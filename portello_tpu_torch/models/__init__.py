"""The forward step and its bucket table."""
