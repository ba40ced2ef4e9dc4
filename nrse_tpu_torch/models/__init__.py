"""The WavLM encoder and its weight conversion."""
