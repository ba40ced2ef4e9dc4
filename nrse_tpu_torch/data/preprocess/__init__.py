"""Offline corpus preprocessing."""
