"""Command-line entry points: generate and serve."""
