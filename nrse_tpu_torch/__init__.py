"""nrse_tpu_torch — the WavLM embedding server and the BYOL train step on
PyTorch and CUDA.

A port of ``nrse_tpu`` (JAX on a TPU) to one NVIDIA H100.  ``nrse_tpu``
stays the reference each module is tested against; this package imports
``torch`` and numpy, never ``jax`` and never ``nrse_tpu``.

Layers, from the entry points down to the device:

  * ``serve.export`` — ``export_embedder`` writes weights and a manifest;
    ``ServingModel`` loads them once, pads ragged requests to the clip
    length, routes them to batch buckets and slices the results back.
  * ``train.byol_trainer`` — the BYOL train step (views, online and target
    towers, loss, backward, AdamW + EMA over flat float32 state) and the
    eval step; ``train.schedules`` the cosine LR; ``audio`` the SNR mixing
    and normalisation of the views on the device.
  * ``models.byol`` and ``models.heads`` — the two towers, the EMA and the
    loss; the heads with flax's BatchNorm semantics.
  * ``models.wavlm`` — the WavLM encoder (conv frontend, feature
    projection, positional conv, gated-relative-position transformer,
    masked-mean pooling; dropout, LayerDrop and SpecAugment in training
    mode), HF ``WavLMModel`` parameter names; ``models.convert`` — JAX
    param trees (as numpy) to its state dicts, and seeded random weights.
  * ``ops`` — the kernels' wrappers with their plain PyTorch versions:
    ``block_attention`` (kernel A), ``fused_ffn`` (kernel B and K2, the
    FFN backward), ``fused_dropout`` (K1), ``fused_optimizer`` (K4);
    ``philox`` the dropout-RNG contract they share; ``attention`` and
    ``rel_pos_bias``.
  * ``csrc`` — the kernels in CUDA C++ for Hopper (``sm_90a``);
    ``runtime.cuda_build`` compiles them with ``nvcc`` at first use and
    binds them with ``ctypes``.
"""

__version__ = "0.2.0"
