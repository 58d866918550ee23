"""The serving function of the port (the JAX package's ``export/``)."""
