"""Serving front of the port."""
