"""numpy/PIL letterbox geometry and target encoding (jax-free copies of the
JAX package's)."""
