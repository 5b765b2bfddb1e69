"""Layers of the Paddle API."""
