"""Ring history and synthetic sources."""
