"""Data loading for the port: the JAX-free host loaders and a device
prefetcher."""
