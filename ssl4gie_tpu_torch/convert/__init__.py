"""Weight conversion between the JAX package and this port."""
