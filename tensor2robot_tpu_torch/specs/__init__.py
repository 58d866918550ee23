"""Specifications of the port: flat ``{key: (shape, dtype)}`` dicts, whose
values may be ``TensorSpec``s that also say how each tensor is stored on
disk."""
