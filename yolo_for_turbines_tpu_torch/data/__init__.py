"""numpy/PIL letterbox geometry (a jax-free copy of the JAX package's)."""
