"""Host utilities of the port (the logger)."""
