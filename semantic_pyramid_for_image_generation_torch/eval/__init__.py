"""Sample grids."""
