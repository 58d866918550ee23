"""Layers of the port."""
