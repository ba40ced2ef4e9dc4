"""Serving: export and the bucketed embedding server."""
