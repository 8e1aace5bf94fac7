"""Tensor ops of the port, one module per JAX counterpart."""
