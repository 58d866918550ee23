"""VRGripper helpers of the port (the JAX package's ``research/vrgripper``)."""
