"""Measurement tools of the port (torch)."""
