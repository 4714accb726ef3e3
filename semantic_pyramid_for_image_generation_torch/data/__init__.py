"""The semantic mask schedule."""
