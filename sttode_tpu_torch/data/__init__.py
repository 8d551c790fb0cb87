"""Host-side data helpers of the port (numpy, no JAX): scene batches,
synthetic scenes and the NBA loader."""
