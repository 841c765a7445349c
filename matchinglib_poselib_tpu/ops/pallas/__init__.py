"""Hand-written Pallas kernels; each has a plain XLA path in ops/ beside it."""
