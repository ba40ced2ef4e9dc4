"""nrse_tpu_torch — the WavLM embedding server on PyTorch and CUDA.

A port of ``nrse_tpu`` (JAX on a TPU) to one NVIDIA H100.  ``nrse_tpu``
stays the reference each module is tested against; this package imports
``torch`` and numpy, never ``jax`` and never ``nrse_tpu``.

Layers, from the entry point down to the device:

  * ``serve.export`` — ``export_embedder`` writes weights and a manifest;
    ``ServingModel`` loads them once, pads ragged requests to the clip
    length, routes them to batch buckets and slices the results back.
  * ``models.wavlm`` — the deterministic WavLM forward (conv frontend,
    feature projection, positional conv, gated-relative-position
    transformer, masked-mean pooling), HF ``WavLMModel`` parameter names;
    ``models.convert`` — JAX param trees (as numpy) to its state dict.
  * ``ops`` — ``block_attention`` (kernel A) and ``fused_ffn`` (kernel B)
    with their plain PyTorch versions, ``attention`` and ``rel_pos_bias``.
  * ``csrc`` — the kernels in CUDA C++ for Hopper (``sm_90a``);
    ``runtime.cuda_build`` compiles them with ``nvcc`` at first use and
    binds them with ``ctypes``.

Forward only: training (dropout, LayerDrop, SpecAugment, backward kernels)
comes later, and a module called in training mode raises.
"""

__version__ = "0.1.0"
