"""nrse_tpu_torch — the WavLM embedding and SER classifier servers, BYOL
pretraining, the baseline SER evaluator and fine-tune, and the two-phase
SER trainers on PyTorch and CUDA.

A port of ``nrse_tpu`` (JAX on a TPU) to one NVIDIA H100.  ``nrse_tpu``
stays the reference each module is tested against.  This package imports
``torch``, numpy and the standard library (scipy to resample, PyYAML to
read a config file), never ``jax``, and nothing of ``nrse_tpu``, not even
its JAX-free modules: what it needs from them it keeps as its own copies,
each naming its origin (the audio decoding and its C++ runtime, the data
loaders, the logger, the label parser and maps, the config loader and
presets, the wandb stub, the seeding).  Only the tests
import both (``tests/test_torch_imports.py`` holds the rule with the JAX
package blocked).

Layers, from the entry points down to the device:

  * ``train_emotion`` and ``evaluate_emotion`` — the SER trainers
    (``python -m nrse_tpu_torch.train_emotion --config <yaml|preset>
    --task categorical|dimensional|both``) and the clean-vs-noisy report
    (``python -m nrse_tpu_torch.evaluate_emotion``); ``config`` the YAML
    loader and presets; ``train.categorical_emotions`` and
    ``train.dimentional_emotions`` the two-phase loops;
    ``train.emotion_trainer`` the step (freezing as a trainable suffix of
    the flat buffers, K4 over it) and the eval step;
    ``data.emotion_dataset`` the MSP-Podcast CSV and its loaders;
    ``models.emotion`` the classifier; ``metrics.categorical_metrics`` the
    offline scorer.
  * ``baseline.eval_cat_ser`` — the Odyssey-2024 baseline evaluator
    (``python -m nrse_tpu_torch.baseline.eval_cat_ser``): label list,
    normalisation stats, ``final_model``, bucketed batched SER inference
    timed per audio second, ``inference_results.csv`` and ``metrics.txt``;
    ``baseline.pipeline`` (``BaselineSER``: WavLM → ASP → head),
    ``baseline.net``, ``baseline.wavset``, ``labels.parsing``,
    ``eval.metrics``, ``train.losses``.
  * ``train_byol`` — BYOL pretraining (``python -m
    nrse_tpu_torch.train_byol --config <yaml>``): loaders, train state,
    epoch loop, validation, early stopping, checkpoints and resume;
    ``data.loader`` the loaders and the device prefetcher;
    ``eval.evaluate_byol`` the validation; ``train.checkpoint`` and
    ``train.early_stopping``.

  * ``serve.export`` — ``export_embedder`` and ``export_classifier`` (the
    SER classifier: logits, A/V/D or both) write weights and a manifest;
    ``ServingModel`` loads them once, pads ragged requests to the clip
    length, routes them to batch buckets and slices the results back;
    ``python -m nrse_tpu_torch.serve.export`` exports a BYOL checkpoint's
    encoder.
  * ``models.convert`` and ``models.export_torch`` — the bridges to the
    reference's PyTorch files (its BYOL ``.pt`` checkpoints, HF WavLM
    directories, the harness's ``final_*.pt``), in and out;
    ``models.encoder.WavLMEncoder`` the reference's encoder API;
    ``utils.profiling``, ``data.synthetic``, ``data.mock``,
    ``labels.tools`` and the other host-side tools.
  * ``train.byol_trainer`` — the BYOL train step (views, online and target
    towers, loss, backward, AdamW + EMA over flat float32 state) and the
    eval step; ``train.schedules`` the cosine LR; ``audio`` the SNR mixing
    and normalisation of the views on the device.
  * ``models.byol`` and ``models.heads`` — the two towers, the EMA and the
    loss; the heads with flax's BatchNorm semantics.
  * ``models.wavlm`` — the WavLM encoder (conv frontend, feature
    projection, positional conv, gated-relative-position transformer,
    masked-mean pooling; dropout, LayerDrop and SpecAugment in training
    mode; attention on the block kernel at T ≤ 384 frames, on the flash
    kernel above), HF ``WavLMModel`` parameter names;
    ``models.emotion`` the ASP pooling; ``models.convert`` — JAX param
    trees (as numpy) to its state dicts, and seeded random weights.
  * ``ops`` — the kernels' wrappers with their plain PyTorch versions:
    ``block_attention`` (kernel A and K3, its backward),
    ``flash_attention`` (K5's forward, T > 384), ``fused_ffn``
    (kernel B and K2, the FFN backward), ``fused_dropout`` (K1),
    ``fused_optimizer`` (K4);
    ``philox`` the dropout-RNG contract they share; ``attention``,
    ``rel_pos_bias`` and ``asp_pooling``.
  * ``csrc`` — the kernels in CUDA C++ for Hopper (``sm_90a``);
    ``runtime.cuda_build`` compiles them with ``nvcc`` at first use and
    binds them with ``ctypes``; ``runtime.native`` builds the C++ audio
    decoder with ``g++`` the same way.
"""

__version__ = "0.3.0"
