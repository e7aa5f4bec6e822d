"""Sizing policy of the port (a copy of the reference's)."""
