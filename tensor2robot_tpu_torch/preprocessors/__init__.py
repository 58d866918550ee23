"""Image preprocessing of the port."""
