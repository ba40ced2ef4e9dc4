"""Waveform augmentation and normalisation on device tensors."""
