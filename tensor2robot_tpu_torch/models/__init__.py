"""Models of the port (inference half)."""
