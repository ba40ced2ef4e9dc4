"""Data loading for the port: the host loaders of the BYOL and emotion
datasets, and a device prefetcher."""
