"""Meta-learning helpers of the port (the JAX package's ``meta_learning/``)."""
