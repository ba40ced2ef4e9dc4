"""Evaluation of the port's BYOL encoder."""
