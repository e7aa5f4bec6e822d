"""Sizing policy and training plan of the port (copies of the reference's)."""
