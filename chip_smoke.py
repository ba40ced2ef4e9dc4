"""Drive the port's embedding server, its BYOL train step, its BYOL
pretraining entry point, its baseline SER evaluator, its SER fine-tune,
its two-phase SER trainers, its SER classifier server, its bridges to
the reference's PyTorch files and its data-parallel path once on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line; any failure raises and the exit code is
not 0:

  1. device  — requires CUDA (never runs on the CPU), prints the card's
     name and power limit from ``nvidia-smi``, turns TF32 off;
  2. build   — compiles ``nrse_tpu_torch/csrc/*.cu`` with ``nvcc`` for
     ``sm_90a`` (one process per source, all at once) into
     ``build/nrse_tpu_torch/`` and prints the seconds;
  3. kernel A (block gated attention) against its plain PyTorch version at
     the serving shapes (bf16, B=32, H=16, D=64, T=249 with ragged key
     masks and one fully masked row, and T=384) and at T ∈ {1, 63, 65,
     257, 383} (ragged last tiles, ragged keys; up to 256 frames the
     one-pass wgmma route, above it the two-pass one), every buffer inside
     NaN guard bands, two calls bit-equal; HGMMA in the one-pass route's
     SASS, registers and no spills; µs per call of both and of the
     library call (``scaled_dot_product_attention`` with the dense float
     bias), the kernel's device time; and that a gradient flows through it
     under autograd;
  3b. K3 (block attention backward) and kernel A's dropout at the training
     shapes (bf16, B=36, H=16, D=64, T=249 with ragged key masks and one
     fully masked row, and T=384, p = 0.1) and at T ∈ {1, 63, 65, 257,
     383} (ragged keys; at T = 1 the gradients that vanish are compared
     against at least 1e-3), and at B=5, T=249 (a batch group of one):
     HGMMA in the wgmma route's SASS (T_pad ≤ 256), registers and no
     spills in every K3 kernel, the dbias partials at most ceil(B/4)
     slices there; the seeded forward and backward
     equal the explicit-mask ones fed K1's dump at the attention site, bit
     for bit; out, dq, dk, dv, dgate, dbias ≤ 1e-2 and lse ≤ 1e-3 of the
     plain versions' max|·|; two forward and two backward calls give the
     same bits; every buffer of both inside NaN guard bands; the autograd
     Function equals the direct calls; µs per call of both and of SDPA's
     backward, K3's device time by kernel;
  4. kernel B (fused FFN: two wgmma GEMMs fed by TMA), its serving entry
     at N = 32·249 = 7968, 32·499 = 15968 and 32·749 = 23968 and its
     training entry (both dropout sites seeded, h1 saved) at N = 36·249,
     both also at N ∈ {1, 127, 129}, C=1024, F=4096, against the plain
     version, every buffer inside NaN guard bands, two calls bit-equal,
     the training entry fed K1's dumps of its masks bit-equal to its
     seeded run; HGMMA in both GEMMs' SASS, no spills; µs per call at the
     large N of kernel, plain and ``F.linear`` → exact GELU → ``F.linear``
     in bf16, and the kernel's device time split into GEMM1 and GEMM2;
  5. serving — WavLM-large at full width (24 layers, 1024 wide, 16 heads,
     FFN 4096) with seeded random weights, exported with buckets
     (1, 8, 32) and 5 s clips, loaded by ``ServingModel`` on the card,
     answers three ragged requests (1 clip; 6 clips; 40 clips chunked
     32 + 8).  Checks shapes, finiteness, that each kernel ran exactly
     24 × (bucket forwards) times, and the pooled cosine of one request
     against the same weights in float32 on the CPU through the plain
     path; then prints audio-sec/sec for each bucket;
  6. K1 (dropout, one Philox draw per four elements) at [36·249, 1024]
     and [32·499, 1024] bf16 and at [1 | 127 | 129, 1024] and [3, 333],
     p = 0.1, every buffer inside NaN guard bands: the kernel's mask equals
     the Philox twin bit for bit, forward and backward equal the plain
     version, two calls give the same bits, the explicit-mask entry equals
     the seeded one, the autograd Function the direct calls; registers;
     µs per call of the wrapper (CUDA events) and of the kernel on the
     card (profiler), of plain and of ``F.dropout`` at both large shapes;
     the mask dump at [36·249, 4096] timed beside its byte bound;
  7. kernel B's training forward (both dropout sites, h1 saved) and K2's
     dx and dW kernels at N = 36·249, C = 1024, F = 4096, p = 0.1, against
     the plain versions (max|Δ|/max|ref| ≤ 1e-2), the explicit-mask entries
     and the autograd Function against the direct seeded calls (bit for
     bit); K2's dx kernel (wgmma fed by TMA) also at N = 32·499 and N ∈
     {1, 127, 129}: two calls bit-equal, explicit masks = Philox masks,
     every buffer inside NaN guard bands, dx, db1, db2, dh1 ≤ 1e-2 of
     plain; K2's dW kernel (both products in one wgmma launch, operands
     MN-major) at N ∈ {1, 127, 129, 36·249, 32·499} inside NaN guard
     bands, two calls bit-equal, dW1 and dW2 ≤ 1e-2 of plain; HGMMA in
     both kernels' SASS (``cuobjdump -sass``), registers and no spills; a
     digest of kernel B's and K2 dx's outputs (equal on two commits when
     their bits are); µs per call and TFLOP/s of each beside the plain
     version's and autograd's backward of the library forward of phase 4,
     the dx and dW kernels at both large N with their time on the card;
  8. K4 (AdamW + EMA) over the flat BYOL parameter set (~326 M) against
     the plain version (≤ 1e-6 relative), the state it updates inside NaN
     guard bands; µs per call and GB/s, and of
     ``torch.optim.AdamW(fused=True)`` + ``torch._foreach_lerp_``;
  8b. K5 (flash attention forward, T > 384, wgmma fed by TMA) against its
     plain version at H=16, D=64: B=4 at T ∈ {385, 449, 513} (T ≡ 1 mod
     64 or 128: keys padded to the next multiple of 128, as JAX pads
     them), T = 512 (no padding) and T ∈ {499, 749, 1499}, the
     evaluator's B=32 at T ∈ {499, 749, 1499}, and B=1 at T=3199 (the
     streamed regime of the TPU kernels) and T=8191, ragged key masks and,
     for B > 1, a wholly masked batch row, every buffer inside NaN guard
     bands: out ≤ 1e-2 and lse ≤ 1e-3 of max|ref|, the wholly masked row
     finite and within 1e-2 of plain (JAX's result: the mean of v times T
     / t_pad); HGMMA in its SASS, registers and no spills; µs per call of
     kernel, plain and SDPA (dense float bias built outside the timed
     call) at B=32 and at B=1, T=3199, the kernel's device time, every
     kernel of a call in the profile's K5 group;
  8c. K5's backward (the dq entry: the delta pre-pass, the dq kernel and
     its dbias fold; the dk/dv kernel) against the plain backward at 8b's
     shapes (ragged keys, a wholly masked row for B > 1), every buffer
     inside NaN guard bands: delta equal to its contract
     (``flash_attention.bwd_delta``) bit for bit, dq, dk, dv, dgate and
     dbias_rel ≤ 1e-2 of plain's max|·|, two calls bit-equal, the autograd
     Function equal to the direct calls; HGMMA in the dq and dk/dv
     kernels' SASS, registers and no spills; µs per call of each entry, of
     the pair, of plain and of SDPA's backward with the dense bias
     requiring grad at B=32 and at B=1, T=3199, beside the bound (5
     products, or each kernel's own), the pair's device time by kernel,
     every kernel in the profile's K5 backward group;
  8d. K6 (fused conv + LayerNorm + GELU, forward and backward) and K7 (the
     channel LayerNorm, forward and backward) against their plain versions
     at every frontend layer of the fine-tune (32 × 10 s: T_in 31999 …
     999) and of BYOL (36 × 5 s: 15999 … 499) and at B=2, T_in ∈ {3, 4, 5,
     1030, 1031}, k ∈ {2, 3} (K7: layer 0's rows of both, and 1–2062 rows):
     out, x̂ and every gradient ≤ 1e-2 of plain's max|·|, rstd, mean and
     inv ≤ 1e-4; two calls bit-equal, the autograd Functions equal to the
     direct calls; every input, output and scratch buffer inside NaN guard
     bands, untouched after the calls and the outputs unchanged; µs per
     call of each beside plain, the library composition (cuDNN conv1d →
     ``F.layer_norm`` → GELU, and its autograd backward; ``F.layer_norm``
     for K7) and the bound; registers and spills (``cuobjdump``); layer 0's
     conv by ``wavlm.strided_conv`` and by cuDNN, timed; K7 against a
     two-pass float32 LayerNorm on layer 0's real output;
  9. training — BYOL on WavLM-large at full width and depth (projection
     1024, prediction 2048, seeded weights) with the JAX preset's
     hyper-parameters (lr 1e-5 cosine, wd 1e-5, clip 1.0, EMA 0.997,
     dropout 0.1, LayerDrop 0.1, SpecAugment 0.05/10/2) on 36 synthetic
     5 s clips: 2 warm-up steps (the target checked to move by exactly the
     EMA), then 5 timed steps whose kernel launches must equal the counts
     the layers each tower ran imply (attention on kernel A in both towers
     and K3 in the online tower's backward); prints s/step,
     audio-sec/sec, peak memory and a ``torch.profiler`` breakdown of a
     step's device time; then the eval step once; then a
     cross-check at 4 layers and batch 2, random features off, bf16 on the
     card against float32 on the CPU (loss, grad_norm ratio, gradient
     cosine ≥ 0.99);
 10. the entry point — ``nrse_tpu_torch.train_byol.main`` on a synthetic
     corpus written to a temporary directory (32 clean 5 s clips, 4 noise
     clips), WavLM-large at full width cut to 2 layers (so that a
     checkpoint stays under 1 GB), batch 8: 2 epochs, then a resumed third;
     checks finite losses, the three checkpoints, that the restored state
     equals the saved one bit for bit and that the resumed run continues
     at epoch 2; prints the audio decoder that ran, whether PyYAML is
     installed and the data-fed s/step of each epoch;
 11. SER evaluation — ``nrse_tpu_torch.baseline.eval_cat_ser.main`` at
     batch 32 on WavLM-large at full width and depth + ASP + the head
     (seeded weights through ``final_model``), over 256 synthetic WAVs of
     2–11.5 s and 4 of 25–30 s in a temporary directory under ``build/``
     (buckets of 5, 10, 15 and 30 s: 249, 499, 749 and 1499 frames):
     outputs written, metrics finite, each bucket's logits equal to a
     direct forward, launches of kernel A and K5 equal to 24 × the batches
     of the buckets on each side of 384 frames; the warm timed modes
     (default, prestaged, overlapped copies) in s per audio-second and
     audio-sec/sec; a ``torch.profiler`` breakdown of one 15 s batch (the
     copies split by source); the logits of a 10 s and a 15 s clip
     against float32 on the CPU (cosine ≥ 0.99);
 12. serving a long clip — an embedder artifact of 64 s clips (3199
     frames, bucket 1) served through K5; pooled cosine against the same
     weights in float32 on the card through the plain versions (≥ 0.99);
     audio-sec/sec;
 13. the SER fine-tune step — ``BaselineSER`` on WavLM-large at full width
     and depth (seeded weights), batch 32 × 10 s (499 frames; every fourth
     clip shorter and masked), lr 5e-6, k = 4, dropout, LayerDrop,
     SpecAugment and the head's dropout on, end to end and with the
     encoder frozen: a warm-up cycle of 4 micro-steps and one K4 update,
     then a timed one (s per micro-step, audio-sec/sec, peak memory)
     whose launches must equal what the layers run imply (K5's forward,
     dq and dk/dv on every layer run end to end, no K5 backward frozen);
     frozen, the encoder's weights must equal p·(1 − lr·wd) after the
     update; a ``torch.profiler`` breakdown of one e2e micro-step (the
     copies group split by source); then a cross-check at 1 layer and
     batch 2, dropout off, at 5 seeds, bf16 on the card against float32
     on the CPU: the card's encoder, given float32's loss gradient at its
     output, gives a parameter gradient of cosine ≥ 0.99 with float32's
     at every seed (the whole step's cosine printed);
 14. the fine-tune's entry point — ``train_ft_cat_ser.main`` on a
     synthetic corpus under ``build/`` (24 train and 8 dev WAVs of
     3–12 s, a one-hot CSV), WavLM-large at full width cut to 2 layers,
     batch 8, k = 2: one epoch frozen, one end to end, then
     ``eval_cat_ser.main`` on the ``final_model`` it wrote: every dev file
     scored; prints the data-fed s per micro-step;
 15. the SER trainers' step — ``train.emotion_trainer.
     make_emotion_train_step("both")`` on an ``EmotionClassifier``
     (WavLM-large at full width and depth + ASP + the shared, categorical
     and dimensional trunks of 1024, seeded weights) at the ``dim_ft``
     preset's batch of 36 × 5 s (249 frames; every third clip masked),
     dropout 0.3 in the trunks, the encoder's dropouts, LayerDrop and
     SpecAugment on, in three runs of 2 warm-up and 3 timed steps: the
     encoder frozen (lr 1e-4), its top 12 layers unfrozen and the whole
     encoder (lr 5e-6); each run's losses finite, the frozen prefix of the
     flat parameters bit-equal after it (``torch.equal``), launches equal
     to what the layers run imply (kernel A and B on every layer run, K3
     and K2 on the unfrozen ones LayerDrop kept, K1 forward and on the
     unfrozen sites backward, K4 once a step over the trainable suffix,
     K6's and K7's backward only in the whole-encoder run); s/step,
     audio-sec/sec, peak memory and a ``torch.profiler`` breakdown of a
     step of each run; then one eval step's logits and A/V/D for 2 clips
     against float32 on the CPU (cosine ≥ 0.99);
 16. the SER trainers' entry points — ``train_emotion.main --config
     <the dim_ft preset> --task both`` on a synthetic MSP-style corpus
     under ``build/`` (24 train and 8 validation WAVs of 2–8 s, 2 noise
     WAVs, ``labels_consensus.csv``; training noise on), WavLM-large at
     full width cut to 2 layers, batch 8, one epoch frozen and one
     unfrozen per trainer: finite losses, K4 once a step, no frontend
     backward (the non-layer encoder stays frozen); then
     ``evaluate_emotion.main`` on each trainer's best fine-tuned
     checkpoint, clean and noisy reports finite; prints the data-fed
     s/step;
 17. the SER classifier's server — ``export_classifier`` of an
     ``EmotionClassifier`` (WavLM-large at full width and depth + ASP +
     trunks of 1024, 8 classes and A/V/D, seeded weights), buckets (1, 8,
     32), 5 s clips, ``task="both"``, loaded by ``ServingModel`` on the
     card, answers phase 5's three ragged requests: kernels A and B
     launched 24 × (bucket forwards) times, K6 and K7 as the frontend
     implies, no K5; logits ``[N, 8]`` and A/V/D ``[N, 3]`` finite; one
     request's outputs against the same artifact in float32 on the CPU
     (cosine ≥ 0.99); each bucket's outputs equal to a direct forward of
     the classifier built as the server builds it, bit for bit; ms a
     request and audio-sec/sec per bucket; then a 10 s artifact (499
     frames) of bucket 8 serves one ragged request: K5 launched 24 times,
     kernel A never; its ms a request;
 18. the bridges and the encoder API — a reference-format
     ``BYOLSpeechModel`` state dict of seeded weights at full width
     (``models.export_torch.byol_state_dicts_to_reference``) through
     ``models.convert.reference_byol_to_state_dicts``: the weights back
     bit for bit; ``WavLMEncoder`` on the bridged online encoder equal to
     ``WavLMModel`` loaded directly on the card, bit for bit, its launches
     and ms a batch at 8 × 5 s; at 2 layers, ``save_reference_byol_
     checkpoint`` writes a ``.pt`` under ``build/`` that
     ``train_emotion.main`` (``emotion.encoder_checkpoint``) trains from
     for one step, its frozen encoder equal to the ``.pt``'s; then
     ``python -m nrse_tpu_torch.serve.export``'s ``main`` exports a port
     ``train_byol`` checkpoint, whose artifact ``ServingModel`` answers
     with the pooled embedding of the checkpoint's encoder run directly,
     and ``utils.profiling.profile_trace`` around one request holds a
     ``block_attention`` kernel record;
 19. data parallelism on the one card (``nrse_tpu_torch.parallel``) —
     first gloo's collectives on CUDA tensors at 2 ranks (``all_reduce``
     sum and max, ``broadcast``, the reduction with a gradient); (a) the
     BYOL step of phase 9 (full width and depth, batch 36 × 5 s, every
     random feature on) through the data-parallel path in an NCCL group of
     one rank against the same steps without a group, from the same
     weights: metrics and every buffer bit for bit, launches as the layers
     run imply, s/step of both; (b) two ranks sharing the card over gloo,
     global batch 36 = 2 × 18: random features off, three steps against
     one rank's run of the whole batch from the same weights (loss within
     1e-3, grad_norm within 1e-2, the parameter deltas' cosine ≥ 0.999 and
     relative distance ≤ 5e-2: the bounds' reasons stand beside
     ``DP_LOSS_TOL``), then every random feature on, three steps: finite,
     the replicas bit-equal after every step (``replicas_agree``),
     launches as the layers run imply; each rank's peak memory beside the
     one-rank run's, s/step labelled as two ranks sharing one card (no
     scaling figure); (c) ``train_byol.main`` and ``train_emotion.run``
     (``--task both``) with two gloo ranks on the card, WavLM-large cut to
     2 layers, global batch 8, one epoch a phase: the ranks' pooled losses
     equal and finite, rank 0's checkpoints written, every kernel of the
     path launched.

Each kernel's bound is the larger of its operations over the bf16 tensor
cores' 989 TFLOP/s and the bytes it must move (each input read once,
each output written once) over 3.35 TB/s, the H100 SXM's published peaks;
the elementwise kernels (K1, K4) are bound by bytes, their operations are
not counted, nor are K7's.  Phases 5, 9–18 also check the frontend's
launches: each encoder forward runs K6 on layers 1–6 and K7 on layer 0,
each backward (the BYOL online tower's, the end-to-end fine-tune's, the
whole-encoder SER step's) K6's and K7's backward as often.  The line before the last is the kernels'
JSON record (launches: kernels A and B from the serving phase, K1, K2, K3
and K4 from the training phase, K5 from the SER evaluation, K5's backward,
K6 and K7 from the fine-tune step, end to end);
the last line is ``{"ok": true, "device": {"platform": "gpu", "kind":
..., "count": ...}}``.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# the port, from this checkout: without it the script stops here
from nrse_tpu_torch import evaluate_emotion, train_emotion  # noqa: E402
from nrse_tpu_torch import train_byol  # noqa: E402
from nrse_tpu_torch.audio.io import save_wav  # noqa: E402
from nrse_tpu_torch.baseline import eval_cat_ser  # noqa: E402
from nrse_tpu_torch.baseline import train_ft_cat_ser  # noqa: E402
from nrse_tpu_torch.baseline.pipeline import (  # noqa: E402
    BaselineSER,
    bucket_length,
    make_baseline_forward,
)
from nrse_tpu_torch.baseline.wavset import WavNormStats  # noqa: E402
from nrse_tpu_torch.config import config_utils  # noqa: E402
from nrse_tpu_torch.labels.parsing import BASELINE_EMOTIONS_MAP  # noqa
from nrse_tpu_torch.models import wavlm as wavlm_module  # noqa: E402
from nrse_tpu_torch.models.byol import OnlineNetwork, TargetNetwork  # noqa
from nrse_tpu_torch.models.convert import (  # noqa: E402
    init_baseline_state_dict,
    init_byol_state_dict,
    init_emotion_state_dict,
    init_state_dict,
    reference_byol_to_state_dicts,
)
from nrse_tpu_torch.models.emotion import EmotionClassifier  # noqa: E402
from nrse_tpu_torch.models.encoder import WavLMEncoder  # noqa: E402
from nrse_tpu_torch.models.export_torch import (  # noqa: E402
    byol_state_dicts_to_reference,
    save_reference_byol_checkpoint,
)
from nrse_tpu_torch.models.wavlm import WavLMConfig, WavLMModel  # noqa
from nrse_tpu_torch.models.wavlm import SITE_ATTN, TrainRNG  # noqa: E402
from nrse_tpu_torch.ops import (  # noqa: E402
    block_attention,
    flash_attention,
    fused_dropout,
    fused_ffn,
    fused_frontend,
    fused_optimizer,
    pallas_norm,
    philox,
)
from nrse_tpu_torch.ops.attention import (  # noqa: E402
    gated_bias_attention,
    gated_bias_attention_bwd,
    gated_bias_attention_fwd,
    gated_bias_attention_lse,
    mask_add,
)
from nrse_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_plain_fwd,
)
from nrse_tpu_torch.ops.fused_ffn import ffn_plain  # noqa: E402
from nrse_tpu_torch.ops.fused_frontend import (  # noqa: E402
    conv_ln_gelu_plain_fwd,
)
from nrse_tpu_torch.ops.pallas_norm import (  # noqa: E402
    channel_layernorm_plain_fwd,
)
from nrse_tpu_torch.runtime import cuda_build  # noqa: E402
from nrse_tpu_torch.runtime.device import sync  # noqa: E402
from nrse_tpu_torch.train import emotion_trainer  # noqa: E402
from nrse_tpu_torch.train.byol_trainer import (  # noqa: E402
    create_train_state,
    make_byol_eval_step,
    make_byol_train_step,
)
from nrse_tpu_torch.train.checkpoint import (  # noqa: E402
    restore_checkpoint,
    save_checkpoint,
    save_model,
    state_tensors,
)
from nrse_tpu_torch.train.schedules import cosine_annealing  # noqa: E402
from nrse_tpu_torch.serve import export as serve_export  # noqa: E402
from nrse_tpu_torch.serve.export import (  # noqa: E402
    ServingModel,
    export_classifier,
    export_embedder,
)
from nrse_tpu_torch.utils.profiling import profile_trace  # noqa: E402

SEED = 0
CLIP_SECONDS = 5.0
SAMPLE_RATE = 16000
BUCKETS = (1, 8, 32)
OUT_TOL = 1e-2      # max|Δ| / max|ref|, bf16 outputs (one bf16 ulp ≈ 4e-3)
LSE_TOL = 1e-3      # max|Δ| / max|ref| of the f32 log-sum-exp
COSINE_MIN = 0.99   # pooled cosine, bf16 card vs f32 CPU
# kernel A and K3 are also held to plain at these T (ragged last tiles)
BLOCK_RAGGED_T = (1, 63, 65, 257, 383)
# the H100 SXM's published dense peaks (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got: torch.Tensor, ref: torch.Tensor,
            floor: float = 1e-30) -> float:
    """max|Δ| / max|ref|, the denominator at least ``floor``."""
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(floor))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flop: float, nbytes_moved: float) -> dict:
    """The least time the card could take: the larger of ``flop`` at the
    bf16 tensor cores' peak and ``nbytes_moved`` at the HBM rate."""
    ops_ms = flop / PEAK_BF16_FLOPS * 1e3
    bytes_ms = nbytes_moved / PEAK_HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def dense_bias(gate, bias, madd) -> torch.Tensor:
    """The ``[B, H, T, T]`` bf16 float mask SDPA takes for gated-bias
    attention: ``gate ⊙ bias + key mask`` (the library call's input, built
    outside its timed call)."""
    return (gate.float()[..., None] * bias.float()[None]
            + madd[:, None, None, :]).to(torch.bfloat16)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events around
    ``iters`` back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    log(card())  # name, power limit
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{name} x{torch.cuda.device_count()}")
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    path = cuda_build.build()
    cuda_build.load()
    log(f"[build] {path.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.3f} s")


def check_no_spills(usage, what: str) -> None:
    """Fail if any kernel of ``kernel_resources``' list spills."""
    spilled = [name for name, u in usage
               if not {"STACK:0", "LOCAL:0"} <= set(u.split())]
    if spilled:
        raise RuntimeError(f"{what} spill registers: {spilled}")


def phase_kernel_a() -> dict:
    """Kernel A against its plain version at the serving shapes and at
    ragged T, every input, output and scratch buffer inside NaN guard
    bands, two calls bit-equal; the one-pass route's SASS read for HGMMA,
    registers and spills; its time beside plain, SDPA and the bound."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, h, d = 32, 16, 64
    check_hgmma("block_attention_fwd_wgmma", tag="kernel A")
    check_no_spills(kernel_resources(("block_attention_fwd",),
                                     tag="kernel A"), "kernel A's routes")
    worst, timing = 0.0, None
    for t in (249, 384, *BLOCK_RAGGED_T):
        q, k, v = (torch.randn(b, h, t, d, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        gate = 1.0 + torch.rand(b, h, t, generator=gen, device=dev)
        bias = torch.randn(h, t, t, generator=gen, device=dev)
        mask = None
        rows = torch.ones(b, dtype=torch.bool, device=dev)  # lse compared
        if t != 384:
            lengths = torch.randint(t // 4, t + 1, (b,), generator=gen,
                                    device=dev)
            lengths[0] = t
            lengths[1] = 0  # one sample whose keys are all padded
            mask = (torch.arange(t, device=dev)[None, :]
                    < lengths[:, None]).to(torch.int32)
            rows = lengths > 0  # lse of an all-padded row is ~-1e9
        with GuardBands(block_attention) as guard, torch.no_grad():
            args = [guard.band(x) for x in (q, k, v, gate, bias)]
            gmask = None if mask is None else guard.band(mask)
            out, lse = block_attention.block_gated_attention_lse(*args, gmask)
            again = block_attention.block_gated_attention_lse(*args, gmask)
            guard.check(f"kernel A at T={t}")
        if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
            raise RuntimeError(f"kernel A: two calls differ at T={t}")
        del again
        ref, ref_lse = gated_bias_attention_lse(q, k, v, gate, bias, mask)
        if not (torch.isfinite(out.float()).all()
                and torch.isfinite(lse).all()):
            raise RuntimeError(f"kernel A: non-finite output at T={t}")
        e_out = rel_err(out, ref)
        e_lse = rel_err(lse[rows], ref_lse[rows])
        abs_err = float((out.float() - ref.float()).abs().max())
        route = "one pass" if -(-t // 64) * 64 <= 256 else "two passes"
        log(f"[kernel A] T={t} ({route}) masked={mask is not None}: out rel "
            f"{e_out:.3e} (abs {abs_err:.3e}), lse rel {e_lse:.3e}; two "
            f"calls bit-equal, guard bands untouched")
        if e_out > OUT_TOL or e_lse > LSE_TOL:
            raise RuntimeError(f"kernel A disagrees with its plain version "
                               f"at T={t}: out {e_out}, lse {e_lse}")
        worst = max(worst, abs_err)
        if t == 249:
            ms = cuda_ms(lambda: block_attention.block_gated_attention_lse(
                q, k, v, gate, bias, mask))
            dev_us = device_us(
                lambda: block_attention.block_gated_attention_lse(
                    q, k, v, gate, bias, mask))
            plain_ms = cuda_ms(lambda: gated_bias_attention_lse(
                q, k, v, gate, bias, mask))
            madd = mask_add(mask, b, t, dev)
            full = dense_bias(gate, bias, madd)
            lib_ms = cuda_ms(lambda: torch.nn.functional
                             .scaled_dot_product_attention(q, k, v,
                                                           attn_mask=full))
            del full
            timing = (ms, plain_ms, lib_ms, bound(
                4.0 * b * h * t * t * d,
                nbytes(q, k, v, gate, bias, madd, out, lse)))
            log(f"[kernel A] B={b} H={h} T={t} D={d}: kernel "
                f"{ms * 1e3:.1f} us/call (on the card {_us_line(dev_us)}), "
                f"plain {plain_ms * 1e3:.1f} us/call, SDPA with the dense "
                f"bias {lib_ms * 1e3:.1f} us/call; bound "
                f"{timing[3]['bound_ms'] * 1e3:.1f} us "
                f"({timing[3]['bound_by']})")
    # under autograd the output is differentiable: a gradient flows to q
    qr = q.detach().requires_grad_()
    block_attention.block_gated_attention(qr, k, v, gate, bias,
                                          mask).float().sum().backward()
    torch.cuda.synchronize()
    if qr.grad is None or not torch.isfinite(qr.grad.float()).all() or \
            float(qr.grad.float().abs().max()) == 0.0:
        raise RuntimeError("kernel A: no gradient flowed to q")
    log(f"[kernel A] under autograd: dq flows, max|dq| "
        f"{float(qr.grad.float().abs().max()):.3e}")
    return {"name": "block_attention_fwd", "route": "cuda",
            "source": "nrse_tpu_torch/csrc/block_attention_fwd.cu",
            "replaces": "nrse_tpu/ops/block_attention.py:106",
            "max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1],
            **timing[3], "library_ms": timing[2]}


GRAD_NAMES = ("dq", "dk", "dv", "dgate", "dbias")


def _k3_plan(b: int, h: int, t: int) -> str:
    """K3's route and dbias partials at (b, h, t), from the wrapper's plan
    (an earlier package without one: its per-batch partials); fails if
    the wgmma route's partials exceed ceil(b / 4) slices of [h, t, t]."""
    plan_fn = getattr(block_attention, "attention_bwd_plan", None)
    if plan_fn is None:
        return f"mma.sync, {b} partial slices"
    plan = plan_fn(b, h, t, torch.cuda.get_device_properties(0)
                   .multi_processor_count)
    if plan["route"] == "wgmma" and plan["partial"] > -(-b // 4) * h * t * t:
        raise RuntimeError(f"K3's dbias partials at B={b} T={t}: "
                           f"{plan['partial']} elements")
    return (f"{plan['route']}, {plan['partial'] // (h * t * t)} partial "
            f"slices")


# K3 is also held to plain at a batch that is not a multiple of its dbias
# group (at least ops/block_attention.py DBIAS_MIN_GROUP)
K3_RAGGED_B = 5


def phase_k3() -> dict:
    """K3 and kernel A's dropout at the training shapes, against the plain
    versions, with the mask contract and determinism checked bit for
    bit; the wgmma route's SASS read for HGMMA, registers and spills, its
    dbias partials' size against the plan."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    h, d = 16, 64
    seed = TrainRNG(SEED, 0, 0).dropout_seed(3, SITE_ATTN)
    for pattern in ("bwd_dq_wgmma", "bwd_dkdv_wgmma"):
        check_hgmma(pattern, tag="K3")
    check_no_spills(kernel_resources(("attention_bwd", "dout_prep",
                                      "dbias_sum"), tag="K3"),
                    "K3's kernels")
    worst, timing = 0.0, None
    cases = [(TRAIN_BATCH, t) for t in (249, 384, *BLOCK_RAGGED_T)]
    for b, t in cases + [(K3_RAGGED_B, 249)]:
        q, k, v, do = (torch.randn(b, h, t, d, generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        gate = 1.0 + torch.rand(b, h, t, generator=gen, device=dev)
        bias = torch.randn(h, t, t, generator=gen, device=dev)
        mask = None
        rows = torch.ones(b, dtype=torch.bool, device=dev)
        if t != 384:
            lengths = torch.randint(t // 4, t + 1, (b,), generator=gen,
                                    device=dev)
            lengths[0] = t
            lengths[1] = 0  # one sample whose keys are all padded
            mask = (torch.arange(t, device=dev)[None, :]
                    < lengths[:, None]).to(torch.int32)
            rows = lengths > 0
        madd = mask_add(mask, b, t, dev).contiguous()
        # the seeded kernels' mask is K1's dump over [B, T, C] at the
        # attention site: fed that dump, the explicit-mask entries must
        # give the same bits
        dump = fused_dropout.dump_dropout_mask(seed, (b, t, h * d), DROP_P,
                                               device=dev)
        keep = dump.view(b, t, h, d).permute(0, 2, 1, 3).contiguous()
        seeded = block_attention._Drop(seed=seed, p=DROP_P)
        # every input, output and scratch buffer of both kernels inside
        # NaN guard bands
        with GuardBands(block_attention) as guard, torch.no_grad():
            args = [guard.band(x) for x in (q, k, v, gate, bias)]
            gmask = None if mask is None else guard.band(mask)
            gmadd, gdo = guard.band(madd), guard.band(do)
            masked = block_attention._Drop(mask=guard.band(keep))
            out, lse = block_attention._kernel_fwd(*args, gmask, seeded)
            f_again = block_attention._kernel_fwd(*args, gmask, seeded)
            m_out, m_lse = block_attention._kernel_fwd(*args, gmask, masked)
            grads = block_attention._kernel_bwd(*args, gmadd, out, lse, gdo,
                                                seeded)
            again = block_attention._kernel_bwd(*args, gmadd, out, lse, gdo,
                                                seeded)
            m_grads = block_attention._kernel_bwd(*args, gmadd, out, lse,
                                                  gdo, masked)
            guard.check(f"kernel A / K3 at B={b} T={t}")
        plan = _k3_plan(b, h, t)
        if not (torch.equal(out, m_out) and torch.equal(lse, m_lse)):
            raise RuntimeError(f"K3 phase: the seeded forward's mask differs "
                               f"from K1's dump at T={t}")
        if not (torch.equal(out, f_again[0]) and torch.equal(lse, f_again[1])):
            raise RuntimeError(f"kernel A with dropout: two calls differ at "
                               f"T={t}")
        del f_again
        for name, a, a2, m in zip(GRAD_NAMES, grads, again, m_grads):
            if not torch.equal(a, m):
                raise RuntimeError(f"K3: the seeded {name} differs from the "
                                   f"explicit-mask one at T={t}")
            if not torch.equal(a, a2):
                raise RuntimeError(f"K3: two backward calls differ in {name} "
                                   f"at T={t}")
        ref_out, ref_lse = gated_bias_attention_fwd(q, k, v, gate, bias,
                                                    madd, keep)
        refs = gated_bias_attention_bwd(q, k, v, gate, bias, madd, out, lse,
                                        do, keep)
        if not all(torch.isfinite(x.float()).all()
                   for x in (out, lse, *grads)):
            raise RuntimeError(f"K3 phase: non-finite output at T={t}")
        errs = {"out": rel_err(out, ref_out),
                "lse": rel_err(lse[rows], ref_lse[rows])}
        # at T = 1 a row's one key gets p = 1, so dq, dk, dgate and dbias
        # are 0 up to rounding: their error is taken against at least 1e-3
        errs.update({n: rel_err(a, r, floor=1e-3)
                     for n, a, r in zip(GRAD_NAMES, grads, refs)})
        scales = {n: float(r.float().abs().max())
                  for n, r in zip(GRAD_NAMES, refs)}
        log(f"[K3] B={b} H={h} T={t} D={d} p={DROP_P} masked="
            f"{mask is not None} ({plan}): seeded = explicit K1-dump mask "
            f"bit for bit "
            f"(fwd and bwd), two forward and two backward calls bit-equal, "
            f"guard bands untouched; max|Δ|/max|ref| "
            f"vs plain " + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
            + "; max|ref| " + ", ".join(f"{n} {v:.3e}"
                                        for n, v in scales.items()))
        if errs.pop("lse") > LSE_TOL or max(errs.values()) > OUT_TOL:
            raise RuntimeError(f"K3 / kernel A disagree with plain at T={t}")
        worst = max(worst, max(float((a.float() - r.float()).abs().max())
                               for a, r in zip(grads, refs)))
        del refs, ref_out, ref_lse

        # the autograd Function gives the direct calls' bits
        leaves = [x.clone().requires_grad_() for x in (q, k, v, gate, bias)]
        o = block_attention.block_gated_attention(
            *leaves, mask, p_drop=DROP_P, dropout_seed=seed)
        o.backward(do)
        if not torch.equal(o.detach(), out):
            raise RuntimeError("K3: the Function's output differs from "
                               "kernel A's")
        for name, leaf, want in zip(GRAD_NAMES, leaves, grads):
            if not torch.equal(leaf.grad, want.to(leaf.grad.dtype)):
                raise RuntimeError(f"K3: the Function's {name} differs from "
                                   f"the kernel's")
        del leaves, o

        if t == 249 and b == TRAIN_BATCH:
            with torch.no_grad():
                fwd_ms = cuda_ms(lambda: block_attention._kernel_fwd(
                    q, k, v, gate, bias, mask, seeded))
                fwd_us = device_us(lambda: block_attention._kernel_fwd(
                    q, k, v, gate, bias, mask, seeded))
                fwd_plain = cuda_ms(lambda: gated_bias_attention_fwd(
                    q, k, v, gate, bias, madd, keep), iters=10)
                ms = cuda_ms(lambda: block_attention._kernel_bwd(
                    q, k, v, gate, bias, madd, out, lse, do, seeded))
                bwd_us = device_us(lambda: block_attention._kernel_bwd(
                    q, k, v, gate, bias, madd, out, lse, do, seeded))
                plain_ms = cuda_ms(lambda: gated_bias_attention_bwd(
                    q, k, v, gate, bias, madd, out, lse, do, keep), iters=10)
            # the library: SDPA's backward, dense bias differentiable, no
            # dropout (SDPA drops probabilities, not the output)
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            full = dense_bias(gate, bias, madd).requires_grad_()
            with torch.enable_grad():
                o = torch.nn.functional.scaled_dot_product_attention(
                    *leaves, attn_mask=full)
                lib_ms = cuda_ms(lambda: torch.autograd.grad(
                    o, leaves + [full], do, retain_graph=True), iters=10)
            del leaves, full, o
            timing = (ms, plain_ms, lib_ms, bound(
                10.0 * b * h * t * t * d,
                nbytes(q, k, v, gate, bias, madd, out, lse, do, *grads)))
            log(f"[K3] B={b} H={h} T={t}: kernel A with dropout "
                f"{fwd_ms * 1e3:.1f} us/call (on the card "
                f"{_us_line(fwd_us)}), plain {fwd_plain * 1e3:.1f} "
                f"us/call; K3 backward {ms * 1e3:.1f} us/call (on the card "
                f"{sum(bwd_us.values()):.1f}: {_us_line(bwd_us)}), plain "
                f"{plain_ms * 1e3:.1f} us/call, SDPA's backward (no "
                f"dropout) {lib_ms * 1e3:.1f} us/call; bound "
                f"{timing[3]['bound_ms'] * 1e3:.1f} us "
                f"({timing[3]['bound_by']})")
    return {"name": "block_attention_bwd", "route": "cuda",
            "source": "nrse_tpu_torch/csrc/block_attention_bwd.cu",
            "replaces": "nrse_tpu/ops/block_attention.py:161",
            "max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1],
            **timing[3], "library_ms": timing[2]}


# kernel B's serving entry at BYOL's / serving's, the fine-tune's and the
# 15 s SER bucket's rows; its training entry at BYOL's; both at ragged N
KB_SERVE_N = (32 * 249, 32 * 499, 32 * 749)
KB_TRAIN_N = 36 * 249
KB_RAGGED_N = (1, 127, 129)


def _ffn_weights(gen, dev, c=1024, f=4096):
    """Seeded FFN weights ``(w1, b1, w2, b2)``, bf16 matrices."""
    w1 = (torch.randn(f, c, generator=gen, device=dev) * c ** -0.5
          ).to(torch.bfloat16)
    b1 = 0.1 * torch.randn(f, generator=gen, device=dev)
    w2 = (torch.randn(c, f, generator=gen, device=dev) * f ** -0.5
          ).to(torch.bfloat16)
    b2 = 0.1 * torch.randn(c, generator=gen, device=dev)
    return w1, b1, w2, b2


def _check_kernel_b(gen, n, weights, train: bool, seed, dev) -> dict:
    """Kernel B's serving entry (``train`` False) or its training entry
    (both dropout sites seeded, h1 saved) at ``n`` rows, every input,
    output and scratch buffer inside NaN guard bands: two calls bit-equal,
    the training entry fed K1's dumps of its masks bit-equal to its seeded
    run; then against plain.  Returns the inputs and ``max|Δ|``."""
    c, f = weights[0].shape[1], weights[0].shape[0]
    x = torch.randn(n, c, generator=gen, device=dev).to(torch.bfloat16)
    drop, masks = fused_ffn._Drop(), (None, None)
    if train:
        drop = fused_ffn._Drop(seed, DROP_P, DROP_P)
        masks = fused_ffn.dump_masks(seed, n, c, f, DROP_P, DROP_P,
                                     device=dev)
    with GuardBands(fused_ffn) as guard, torch.no_grad():
        args = [guard.band(t) for t in (x, *weights)]
        got = fused_ffn._kernel_fwd(*args, drop, train)
        again = fused_ffn._kernel_fwd(*args, drop, train)
        if train:
            m_drop = fused_ffn._Drop(masks=tuple(guard.band(m)
                                                 for m in masks))
            m_got = fused_ffn._kernel_fwd(*args, m_drop, True)
        guard.check(f"kernel B at N={n}")
    names = ("out", "h1", "gd")
    for name, a, a2 in zip(names, got, again):
        if a is not None and not torch.equal(a, a2):
            raise RuntimeError(f"kernel B at N={n}: two calls differ in "
                               f"{name}")
    if train:
        for name, a, m in zip(names, got, m_got):
            if not torch.equal(a, m):
                raise RuntimeError(f"kernel B at N={n}: the explicit masks' "
                                   f"{name} differs from the seeded run")
    with torch.no_grad():
        refs = fused_ffn.ffn_plain_fwd(x, *weights, *masks)
    errs = {k: rel_err(a, r) for k, a, r in zip(names, got, refs)
            if a is not None}
    if not all(torch.isfinite(a.float()).all() for a in got if a is not None):
        raise RuntimeError(f"kernel B at N={n}: non-finite output")
    entry = "training" if train else "serving"
    log(f"[kernel B] {entry} N={n}: two calls bit-equal"
        + (", explicit masks = seeded bit for bit" if train else "")
        + ", guard bands untouched; max|Δ|/max|ref| vs plain "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items()))
    if max(errs.values()) > OUT_TOL:
        raise RuntimeError(f"kernel B disagrees with plain at N={n}: {errs}")
    return {"x": x, "drop": drop, "masks": masks,
            "abs": max(float((a.float() - r.float()).abs().max())
                       for a, r in zip(got, refs) if a is not None)}


def _time_kernel_b(x, weights, drop, masks, train: bool) -> dict:
    """Kernel B's call, its two GEMMs on the card, plain and the library's
    ``F.linear``-GELU-``F.linear`` at ``x``'s rows, beside the bound."""
    n, c = x.shape
    f = weights[0].shape[0]
    with torch.no_grad():
        ms = cuda_ms(lambda: fused_ffn._kernel_fwd(x, *weights, drop, train))
        dev_us = device_us(lambda: fused_ffn._kernel_fwd(x, *weights, drop,
                                                         train))
        plain_ms = cuda_ms(lambda: fused_ffn.ffn_plain_fwd(
            x, *weights, *masks), iters=3, warmup=1)
        w1, b1, w2, b2 = weights
        b1h, b2h = b1.to(torch.bfloat16), b2.to(torch.bfloat16)
        lib_ms = cuda_ms(lambda: library_ffn(x, w1, b1h, w2, b2h))
    flop = 4.0 * n * c * f
    # inputs once, out (and in training h1 and gd, [n, f] bf16) once
    moved = nbytes(x, *weights) + 2 * n * c + (4 * n * f if train else 0)
    bd = bound(flop, moved)
    log(f"[kernel B] {'training' if train else 'serving'} N={n}: kernel "
        f"{ms * 1e3:.1f} us/call ({flop / ms / 1e9:.1f} TFLOP/s), on the card "
        f"{sum(dev_us.values()):.1f} us ({_us_line(dev_us)}); plain "
        f"{plain_ms * 1e3:.1f} us/call, F.linear-GELU-F.linear "
        f"{lib_ms * 1e3:.1f} us/call ({flop / lib_ms / 1e9:.1f} TFLOP/s); "
        f"bound {bd['bound_ms'] * 1e3:.1f} us ({bd['bound_by']})")
    return {"ms": ms, "plain_ms": plain_ms, **bd, "library_ms": lib_ms}


def phase_kernel_b() -> dict:
    """Kernel B's serving entry at the serving, fine-tune and 15 s SER
    rows and its training entry at BYOL's, both at ragged N, against plain
    inside guard bands (two calls bit-equal; the training entry's
    explicit masks equal its seeded ones); HGMMA in both GEMMs' SASS, no
    spills; times beside plain, the library and the bound."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    seed = philox.stream_seed(SEED, 0, 0, 0, 1)
    for epilogue in ("EpiGelu", "EpiBias"):
        check_hgmma(epilogue, tag="kernel B")
    check_no_spills(kernel_resources(("EpiGelu", "EpiBias"), tag="kernel B"),
                    "kernel B's GEMMs")
    weights = _ffn_weights(gen, dev)
    worst, row = 0.0, None
    cases = [(n, False) for n in (*KB_SERVE_N, *KB_RAGGED_N)] \
        + [(n, True) for n in (KB_TRAIN_N, *KB_RAGGED_N)]
    for n, train in cases:
        r = _check_kernel_b(gen, n, weights, train, seed, dev)
        worst = max(worst, r["abs"])
        if n in KB_SERVE_N or n == KB_TRAIN_N:
            times = _time_kernel_b(r["x"], weights, r["drop"], r["masks"],
                                   train)
            if n == KB_SERVE_N[0] and not train:
                row = times
        del r
    return {"name": "fused_ffn_fwd", "route": "cuda",
            "source": "nrse_tpu_torch/csrc/fused_ffn_fwd.cu",
            "replaces": "nrse_tpu/ops/fused_ffn.py:110",
            "max_abs_err": worst, **row}


def library_ffn(x, w1, b1, w2, b2):
    """One FFN forward in PyTorch's own bf16 calls (the library yardstick
    of kernel B and, under autograd, of K2)."""
    f = torch.nn.functional
    return f.linear(f.gelu(f.linear(x, w1, b1), approximate="none"), w2, b2)


TRAIN_BATCH = 36
DROP_P = 0.1
GRAD_TOL = 1e-2    # max|Δ| / max|ref| of K2's outputs against plain
OPT_TOL = 1e-6     # max|Δ| / max|ref| of K4's outputs against plain


def _gbps(nbytes: float, ms: float) -> float:
    return nbytes / ms / 1e6


# the range of a trace's timed calls (a ``record_function``), after calls
# for TRACE_WARM_S seconds under the profiler
TIMED = "chip_smoke.timed"
TRACE_WARM_S = 0.05
TRACE_ATTEMPTS = 4


def _trace_faults(events: list, event_ms: float):
    """``(kernels, faults)`` of a ``torch.profiler`` trace whose calls inside
    the :data:`TIMED` range CUDA events timed at ``event_ms``: the kernels
    of the launches made on the host inside that range (runtime or driver
    ``LaunchKernel`` calls, any thread), and what is wrong with the trace:
    a launch whose kernel it lacks (the profiler drops kernel records,
    mostly early in a session), or a span from the first kernel's start to
    the last one's end that disagrees with the events (a trace once read
    every kernel at about half its time: its clock misconverted)."""
    timed = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == TIMED]
    if len(timed) != 1:
        return [], [f"{len(timed)} timed ranges in the trace"]
    t0, t1 = timed[0]["ts"], timed[0]["ts"] + timed[0]["dur"]
    launches = sorted((e for e in events
                       if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and "LaunchKernel" in e.get("name", "")
                       and t0 <= e["ts"] <= t1), key=lambda e: e["ts"])
    by_corr = {e["args"].get("correlation"): e for e in events
               if e.get("cat") == "kernel"}
    kernels = [by_corr[e["args"].get("correlation")] for e in launches
               if e["args"].get("correlation") in by_corr]
    faults = []
    lost = [i for i, e in enumerate(launches)
            if e["args"].get("correlation") not in by_corr]
    if lost:
        faults.append(f"{len(lost)} of {len(launches)} kernel launches have "
                      f"no kernel in the trace (launches {lost[:8]} in host "
                      f"order)")
    if kernels:
        span = (max(e["ts"] + e["dur"] for e in kernels)
                - min(e["ts"] for e in kernels)) / 1e3
        # the events also count the host's lead-in before the first kernel
        # and the copy back after the last
        if not 0.8 * event_ms - 0.2 <= span <= 1.05 * event_ms + 0.05:
            faults.append(f"kernels span {span:.3f} ms of the trace against "
                          f"{event_ms:.3f} ms of CUDA events")
    elif not lost:
        faults.append("no kernel launched in the timed range")
    return kernels, faults


def traced_kernels(run, iters: int, context=None):
    """``(events, kernels, host seconds)`` of a ``torch.profiler`` trace
    (host and card) over ``iters`` calls of ``run()``, which ends waiting
    for the card or is followed by a synchronize here: ``kernels`` are
    those the calls launched, checked against CUDA events around the same
    calls (:func:`_trace_faults`).  Calls for :data:`TRACE_WARM_S` seconds
    (one at least) run traced before them: the profiler lost the kernels
    of a session's first milliseconds most often.  A trace at fault is
    logged and taken again, up to :data:`TRACE_ATTEMPTS` times in all; then
    the phase fails."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile, record_function

    for attempt in range(1, TRACE_ATTEMPTS + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with (context() if context else contextlib.nullcontext()), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                record_shapes=context is not None) as prof:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < TRACE_WARM_S:
                run()
                torch.cuda.synchronize()
            start.record()
            t0 = time.perf_counter()
            with record_function(TIMED):
                for _ in range(iters):
                    run()
            end.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        fd, path = tempfile.mkstemp(suffix=".json", dir=cuda_build.BUILD_DIR)
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        kernels, faults = _trace_faults(events, start.elapsed_time(end))
        if not faults:
            return events, kernels, wall
        log(f"[profile] trace {attempt} at fault: {'; '.join(faults)}")
    raise RuntimeError(f"{TRACE_ATTEMPTS} profiler traces at fault, the "
                       f"last: " + "; ".join(faults))


def device_us(run, iters: int = 10) -> dict:
    """Device µs a call of ``run()`` by kernel name (shortened), from the
    CUDA kernels of a checked ``torch.profiler`` trace over ``iters`` calls
    after one warm-up (:func:`traced_kernels`): the card's own time,
    without the host's gaps between launches that CUDA events around a
    call also count."""
    run()
    torch.cuda.synchronize()
    _, kernels, _ = traced_kernels(run, iters)
    out = {}
    for e in kernels:
        name = (e["name"].replace("(anonymous namespace)::", "")
                .replace("void ", "").split("(")[0][:60])
        out[name] = out.get(name, 0.0) + e["dur"] / iters
    return out


def _us_line(times: dict) -> str:
    return ", ".join(f"{k} {v:.1f}" for k, v in
                     sorted(times.items(), key=lambda kv: -kv[1]))


# K1 and K2 dx are also checked at these small, ragged shapes
K1_RAGGED = ((1, 1024), (127, 1024), (129, 1024), (3, 333))
K2_RAGGED_N = (1, 127, 129)
FT_ROWS = 32 * 499  # the fine-tune's rows: batch 32 x 499 frames


def _check_k1(gen, shape, seed, dev) -> float:
    """K1 at one shape, every input, output and scratch buffer inside NaN
    guard bands: the dump equals the Philox twin bit for bit, the seeded
    pass equals plain exactly forward and backward, two calls give the
    same bits, the explicit-mask entry fed the twin gives the seeded bits.
    Returns the keep fraction."""
    bf = torch.bfloat16
    with GuardBands(fused_dropout) as guard, torch.no_grad():
        x = guard.band(torch.randn(shape, generator=gen, device=dev).to(bf))
        dy = guard.band(torch.randn(shape, generator=gen, device=dev).to(bf))
        mask = fused_dropout.dump_dropout_mask(seed, shape, DROP_P,
                                               device=dev)
        twin = philox.dump_mask(seed, 0, shape, DROP_P, device=dev)
        y = fused_dropout._seeded(x, seed, DROP_P, 0)
        again = fused_dropout._seeded(x, seed, DROP_P, 0)
        dx = fused_dropout._seeded(dy, seed, DROP_P, 0)
        y_masked = fused_dropout._masked(x, guard.band(twin))
        guard.check(f"K1 at {shape}")
    for what, got, want in (
            ("the mask dump vs the Philox twin", mask, twin),
            ("two seeded calls", again, y),
            ("forward vs plain", y, fused_dropout.dropout_plain(x, twin)),
            ("backward vs plain", dx, fused_dropout.dropout_plain(dy, twin)),
            ("the explicit-mask entry vs the seeded one", y_masked, y)):
        if not torch.equal(got, want):
            raise RuntimeError(f"K1 at {shape}: {what} differ at "
                               f"{int((got != want).sum())} elements")
    return float((twin > 0).float().mean())


def _time_k1(gen, n, c, seed, dev) -> dict:
    x = torch.randn(n, c, generator=gen, device=dev).to(torch.bfloat16)
    with torch.no_grad():
        ms = cuda_ms(lambda: fused_dropout.hw_dropout(x, seed, DROP_P))
        dev_us = device_us(lambda: fused_dropout.hw_dropout(x, seed, DROP_P))
        plain_ms = cuda_ms(lambda: fused_dropout.dropout_plain(
            x, philox.dump_mask(seed, 0, (n, c), DROP_P, device=dev)),
            iters=5)
        lib_ms = cuda_ms(lambda: torch.nn.functional.dropout(
            x, DROP_P, training=True))
    moved = 2 * nbytes(x)
    bd = bound(0.0, moved)
    log(f"[K1] [{n}, {c}]: the wrapper {ms * 1e3:.1f} us/call "
        f"({_gbps(moved, ms):.0f} GB/s), on the card {_us_line(dev_us)} "
        f"us/call; plain (Philox twin + multiply) {plain_ms * 1e3:.1f} "
        f"us/call, F.dropout {lib_ms * 1e3:.1f} us/call; bound "
        f"{bd['bound_ms'] * 1e3:.1f} us ({bd['bound_by']})")
    return {"ms": ms, "plain_ms": plain_ms, **bd, "library_ms": lib_ms}


def phase_k1() -> dict:
    """K1 at the BYOL and fine-tune shapes and at ragged ones: the
    kernel's mask against the Philox twin bit for bit, forward and backward
    against the plain version, inside guard bands; times, and the mask
    dump's at [8964, 4096]."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    n, c = TRAIN_BATCH * 249, 1024
    seed = philox.stream_seed(SEED, 0, 0, 0, 0)
    kernel_resources(("dropout_kernel",), tag="K1")
    for shape in ((n, c), (FT_ROWS, c), *K1_RAGGED):
        kept = _check_k1(gen, shape, seed, dev)
        log(f"[K1] {list(shape)} bf16 p={DROP_P}: the dump equals the Philox "
            f"twin bit for bit (keep {kept:.5f}); seeded = plain forward and "
            f"backward, = the explicit-mask entry, two calls bit-equal; "
            f"guard bands untouched")

    # the autograd Function: forward and backward are the direct calls
    x = torch.randn(n, c, generator=gen, device=dev).to(torch.bfloat16)
    dy = torch.randn(n, c, generator=gen, device=dev).to(torch.bfloat16)
    twin = philox.dump_mask(seed, 0, (n, c), DROP_P, device=dev)
    xr = x.clone().requires_grad_()
    y = fused_dropout.hw_dropout(xr, seed, DROP_P)
    y.backward(dy)
    err = max(float((y.detach().float() - fused_dropout.dropout_plain(
                  x, twin).float()).abs().max()),
              float((xr.grad.float() - fused_dropout.dropout_plain(
                  dy, twin).float()).abs().max()))
    if err != 0.0:
        raise RuntimeError(f"K1's autograd Function disagrees with its "
                           f"plain version: {err}")
    del x, dy, twin, xr, y

    row = _time_k1(gen, n, c, seed, dev)
    _time_k1(gen, FT_ROWS, c, seed, dev)
    # the mask dump (mode 2) at the activation site's shape: no library
    # call computes it
    shape = (n, 4 * c)
    dump_ms = cuda_ms(lambda: fused_dropout.dump_dropout_mask(
        seed, shape, DROP_P, device=dev))
    dump_us = device_us(lambda: fused_dropout.dump_dropout_mask(
        seed, shape, DROP_P, device=dev))
    twin_ms = cuda_ms(lambda: philox.dump_mask(seed, 0, shape, DROP_P,
                                               device=dev), iters=3)
    bd = bound(0.0, 4 * n * 4 * c)
    log(f"[K1] mask dump {list(shape)} f32: the wrapper {dump_ms * 1e3:.1f} "
        f"us/call, on the card {_us_line(dump_us)} us/call; plain (the "
        f"Philox twin on the card) {twin_ms * 1e3:.1f} us/call; bound "
        f"{bd['bound_ms'] * 1e3:.1f} us ({bd['bound_by']})")
    return {"name": "fused_dropout", "route": "cuda",
            "source": "nrse_tpu_torch/csrc/fused_dropout.cu",
            "replaces": "nrse_tpu/ops/fused_dropout.py:68",
            "max_abs_err": err, **row}


@functools.lru_cache(maxsize=1)
def _sass(library: str) -> str:
    """The built library's SASS, as ``cuobjdump -sass`` lists it."""
    return subprocess.run([_cuda_bin("cuobjdump"), "-sass", library],
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout


def check_hgmma(pattern: str = "gemm_tn_kernel", tag: str = "K2") -> None:
    """Fail unless every kernel whose name holds ``pattern`` runs its
    products on wgmma: ``HGMMA`` in its SASS, as ``cuobjdump -sass`` reads
    it from the built library."""
    counts = {}
    sass = _sass(str(cuda_build.library_path()))
    for section in sass.split("Function : ")[1:]:
        name = section.split("\n", 1)[0].strip()
        if pattern in name:
            counts[name] = section.count("HGMMA")
    log(f"[{tag}] HGMMA instructions in the SASS of {pattern}: "
        + ", ".join(f"{k[-40:]} {v}" for k, v in counts.items()))
    if not counts or not all(counts.values()):
        raise RuntimeError(f"{pattern}: no HGMMA in its SASS ({counts})")


def _check_k2_dx(gen, n, seed, dev, c=1024, f=4096) -> dict:
    """K2's dx kernel at ``n`` rows, every input, output and scratch buffer
    inside NaN guard bands: seeded twice (bit-equal) and with the dumped
    masks (bit-equal to seeded), then against the plain version.  Returns
    ``{output: (max|Δ|/max|ref|, max|Δ|)}``."""
    bf = torch.bfloat16
    dout = (0.1 * torch.randn(n, c, generator=gen, device=dev)).to(bf)
    h1 = torch.randn(n, f, generator=gen, device=dev).to(bf)
    w1 = torch.randn(f, c, generator=gen, device=dev) * c ** -0.5
    w2 = torch.randn(c, f, generator=gen, device=dev) * f ** -0.5
    keep_act, keep_hid = fused_ffn.dump_masks(seed, n, c, f, DROP_P, DROP_P,
                                              device=dev)
    drop = fused_ffn._Drop(seed, DROP_P, DROP_P)
    with GuardBands(fused_ffn) as guard, torch.no_grad():
        args = [guard.band(t) for t in (dout, h1, w1, w2)]
        got = fused_ffn._kernel_bwd_dx(*args, drop)
        again = fused_ffn._kernel_bwd_dx(*args, drop)
        masked = fused_ffn._Drop(masks=(guard.band(keep_act),
                                        guard.band(keep_hid)))
        m_got = fused_ffn._kernel_bwd_dx(*args, masked)
        guard.check(f"K2 dx at N={n}")
    names = ("dx", "db1", "db2", "dh1", "dh2")
    for name, a, b, m in zip(names, got, again, m_got):
        if not torch.equal(a, b):
            raise RuntimeError(f"K2 dx at N={n}: two calls differ in {name}")
        if not torch.equal(a, m):
            raise RuntimeError(f"K2 dx at N={n}: the explicit masks' {name} "
                               f"differs from the Philox masks' run")
    with torch.no_grad():
        ref = fused_ffn.ffn_plain_bwd_dx(dout, h1, w1, w2, keep_act,
                                         keep_hid)
    if not all(torch.isfinite(t.float()).all() for t in got):
        raise RuntimeError(f"K2 dx at N={n}: non-finite output")
    errs = {k: (rel_err(a, r), float((a.float() - r.float()).abs().max()))
            for k, a, r in zip(names, got, ref)}
    log(f"[K2] dx N={n} C={c} F={f} p={DROP_P}: two calls bit-equal, "
        f"explicit masks = Philox masks bit for bit, guard bands untouched; "
        f"max|Δ|/max|ref| vs plain "
        + ", ".join(f"{k} {v[0]:.2e}" for k, v in errs.items()))
    if max(v[0] for v in errs.values()) > GRAD_TOL:
        raise RuntimeError(f"K2 dx disagrees with plain at N={n}: {errs}")
    return errs


def _check_k2_dw(gen, n, dev, c=1024, f=4096) -> float:
    """K2's dW kernel at ``n`` rows, every input and output inside NaN
    guard bands: two calls bit-equal, dW1 and dW2 against the plain
    version.  Returns max|Δ|."""
    bf = torch.bfloat16
    x = torch.randn(n, c, generator=gen, device=dev).to(bf)
    gd = torch.randn(n, f, generator=gen, device=dev).to(bf)
    dh1 = (0.1 * torch.randn(n, f, generator=gen, device=dev)).to(bf)
    dh2 = (0.1 * torch.randn(n, c, generator=gen, device=dev)).to(bf)
    with GuardBands(fused_ffn) as guard, torch.no_grad():
        args = [guard.band(t) for t in (x, gd, dh1, dh2)]
        got = fused_ffn._kernel_bwd_dw(*args)
        again = fused_ffn._kernel_bwd_dw(*args)
        guard.check(f"K2 dW at N={n}")
    for name, a, b in zip(("dw1", "dw2"), got, again):
        if not torch.equal(a, b):
            raise RuntimeError(f"K2 dW at N={n}: two calls differ in {name}")
    with torch.no_grad():
        ref = fused_ffn.ffn_plain_bwd_dw(x, gd, dh1, dh2)
    if not all(torch.isfinite(t).all() for t in got):
        raise RuntimeError(f"K2 dW at N={n}: non-finite output")
    errs = {k: rel_err(a, r) for k, a, r in zip(("dw1", "dw2"), got, ref)}
    log(f"[K2] dW N={n} C={c} F={f}: two calls bit-equal, guard bands "
        f"untouched; max|Δ|/max|ref| vs plain "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if max(errs.values()) > GRAD_TOL:
        raise RuntimeError(f"K2 dW disagrees with plain at N={n}: {errs}")
    return max(float((a - r).abs().max()) for a, r in zip(got, ref))


def _time_k2_dw(gen, n, dev, c=1024, f=4096) -> dict:
    """K2's dW kernel at ``n`` rows: µs a call and on the card, plain, the
    library (autograd's weight gradients of ``library_ffn``) and the
    bound."""
    bf = torch.bfloat16
    x = torch.randn(n, c, generator=gen, device=dev).to(bf)
    gd = torch.randn(n, f, generator=gen, device=dev).to(bf)
    dh1 = (0.1 * torch.randn(n, f, generator=gen, device=dev)).to(bf)
    dh2 = (0.1 * torch.randn(n, c, generator=gen, device=dev)).to(bf)
    dout = (0.1 * torch.randn(n, c, generator=gen, device=dev)).to(bf)
    weights = [torch.randn(f, c, generator=gen, device=dev) * c ** -0.5,
               0.1 * torch.randn(f, generator=gen, device=dev),
               torch.randn(c, f, generator=gen, device=dev) * f ** -0.5,
               0.1 * torch.randn(c, generator=gen, device=dev)]
    with torch.no_grad():
        out = fused_ffn._kernel_bwd_dw(x, gd, dh1, dh2)
        ms = cuda_ms(lambda: fused_ffn._kernel_bwd_dw(x, gd, dh1, dh2))
        dev_us = device_us(lambda: fused_ffn._kernel_bwd_dw(x, gd, dh1, dh2))
        plain_ms = cuda_ms(lambda: fused_ffn.ffn_plain_bwd_dw(
            x, gd, dh1, dh2), iters=5)
    leaves = [t.to(bf).clone().requires_grad_() for t in (x, *weights)]
    with torch.enable_grad():
        o = library_ffn(*leaves)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            o, leaves[1:], dout, retain_graph=True))
    del leaves, o
    flop = 4.0 * n * c * f
    bd = bound(flop, nbytes(x, gd, dh1, dh2, *out))
    log(f"[K2] dW N={n}: the wrapper {ms * 1e3:.1f} us/call "
        f"({flop / ms / 1e9:.1f} TFLOP/s), on the card "
        f"{sum(dev_us.values()):.1f} us/call ({_us_line(dev_us)}); plain "
        f"{plain_ms * 1e3:.1f} us/call, autograd of F.linear-GELU-F.linear "
        f"(weights only) {lib_ms * 1e3:.1f} us/call; bound "
        f"{bd['bound_ms'] * 1e3:.1f} us ({bd['bound_by']})")
    return {"ms": ms, "plain_ms": plain_ms, **bd, "library_ms": lib_ms}


def _digest(*tensors) -> str:
    """A short hash of the tensors' bytes: equal outputs, equal digests."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def _time_k2_dx(gen, n, seed, dev, c=1024, f=4096) -> dict:
    bf = torch.bfloat16
    x = torch.randn(n, c, generator=gen, device=dev).to(bf)
    dout = (0.1 * torch.randn(n, c, generator=gen, device=dev)).to(bf)
    h1 = torch.randn(n, f, generator=gen, device=dev).to(bf)
    w1 = torch.randn(f, c, generator=gen, device=dev) * c ** -0.5
    w2 = torch.randn(c, f, generator=gen, device=dev) * f ** -0.5
    b1 = 0.1 * torch.randn(f, generator=gen, device=dev)
    b2 = 0.1 * torch.randn(c, generator=gen, device=dev)
    keep_act, keep_hid = fused_ffn.dump_masks(seed, n, c, f, DROP_P, DROP_P,
                                              device=dev)
    drop = fused_ffn._Drop(seed, DROP_P, DROP_P)
    with torch.no_grad():
        out = fused_ffn._kernel_bwd_dx(dout, h1, w1, w2, drop)
        ms = cuda_ms(lambda: fused_ffn._kernel_bwd_dx(dout, h1, w1, w2, drop))
        dev_us = device_us(lambda: fused_ffn._kernel_bwd_dx(
            dout, h1, w1, w2, drop))
        plain_ms = cuda_ms(lambda: fused_ffn.ffn_plain_bwd_dx(
            dout, h1, w1, w2, keep_act, keep_hid), iters=5)
    leaves = [t.to(bf).clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
    with torch.enable_grad():
        o = library_ffn(*leaves)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            o, leaves[:1], dout, retain_graph=True))
    del leaves, o
    flop = 4.0 * n * c * f
    bd = bound(flop, nbytes(dout, h1, w1, w2, *out))
    log(f"[K2] dx N={n}: the wrapper {ms * 1e3:.1f} us/call "
        f"({flop / ms / 1e9:.1f} TFLOP/s), on the card "
        f"{sum(dev_us.values()):.1f} us/call ({_us_line(dev_us)}); plain "
        f"{plain_ms * 1e3:.1f} us/call, autograd of F.linear-GELU-F.linear "
        f"(dx only) {lib_ms * 1e3:.1f} us/call; bound "
        f"{bd['bound_ms'] * 1e3:.1f} us ({bd['bound_by']})")
    return {"ms": ms, "plain_ms": plain_ms, **bd, "library_ms": lib_ms}


def phase_k2() -> list:
    """Kernel B's training forward (both dropout sites, h1 saved) and K2's
    dx and dW kernels at N = 36 x 249 against the plain versions; K2's dx
    kernel also at the fine-tune's N = 32 x 499 and at ragged N, inside
    guard bands, with its SASS read for HGMMA."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    n, c, f = TRAIN_BATCH * 249, 1024, 4096
    seed = philox.stream_seed(SEED, 0, 0, 0, 2)
    for epilogue in ("EpiDgd", "EpiStoreBf16", "EpiDw"):
        check_hgmma(epilogue)
    check_no_spills(kernel_resources(("EpiDgd", "EpiStoreBf16", "dh2_kernel",
                                      "colsum_fold", "transpose_cast"),
                                     tag="K2"), "K2's dx kernels")
    check_no_spills(kernel_resources(("EpiDw",), tag="K2 dW"),
                    "K2's dW kernel")
    x = torch.randn(n, c, generator=gen, device=dev).to(torch.bfloat16)
    dout = (0.1 * torch.randn(n, c, generator=gen, device=dev)
            ).to(torch.bfloat16)
    w1 = torch.randn(f, c, generator=gen, device=dev) * c ** -0.5
    w2 = torch.randn(c, f, generator=gen, device=dev) * f ** -0.5
    b1 = 0.1 * torch.randn(f, generator=gen, device=dev)
    b2 = 0.1 * torch.randn(c, generator=gen, device=dev)
    keep_act, keep_hid = fused_ffn.dump_masks(seed, n, c, f, DROP_P, DROP_P,
                                              device=dev)
    drop = fused_ffn._Drop(seed, DROP_P, DROP_P)
    with torch.no_grad():
        out, h1, gd = fused_ffn._kernel_fwd(x, w1, b1, w2, b2, drop, True)
        dx, db1, db2, dh1, dh2 = fused_ffn._kernel_bwd_dx(dout, h1, w1, w2,
                                                          drop)
        dw1, dw2 = fused_ffn._kernel_bwd_dw(x, gd, dh1, dh2)
        torch.cuda.synchronize()
        ref_out, ref_h1, ref_gd = fused_ffn.ffn_plain_fwd(
            x, w1, b1, w2, b2, keep_act, keep_hid)
        ref_dx, ref_db1, ref_db2, ref_dh1, ref_dh2 = \
            fused_ffn.ffn_plain_bwd_dx(dout, h1, w1, w2, keep_act, keep_hid)
        ref_dw1, ref_dw2 = fused_ffn.ffn_plain_bwd_dw(x, gd, dh1, dh2)
    # kernel B's and K2 dx's bits on these seeded inputs: equal digests on
    # two commits mean equal outputs
    log(f"[K2] digest of kernel B's training forward (out, h1, gd) "
        f"{_digest(out, h1, gd)}, of K2 dx (dx, db1, db2, dh1, dh2) "
        f"{_digest(dx, db1, db2, dh1, dh2)}, of K2 dW {_digest(dw1, dw2)}")
    checks = {"out": (out, ref_out), "h1": (h1, ref_h1), "gd": (gd, ref_gd),
              "dx": (dx, ref_dx), "db1": (db1, ref_db1),
              "db2": (db2, ref_db2), "dh1": (dh1, ref_dh1),
              "dw1": (dw1, ref_dw1), "dw2": (dw2, ref_dw2)}
    errs = {k: rel_err(*v) for k, v in checks.items()}
    if not all(torch.isfinite(t.float()).all() for t, _ in checks.values()):
        raise RuntimeError("kernel B / K2: non-finite output")
    log(f"[K2] N={n} C={c} F={f} p={DROP_P}: max|Δ|/max|ref| vs plain "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if max(errs.values()) > GRAD_TOL:
        raise RuntimeError(f"kernel B / K2 disagree with plain: {errs}")

    # the explicit-mask entries, fed the dumped masks, give the same bits
    with torch.no_grad():
        masked = fused_ffn._Drop(masks=(keep_act, keep_hid))
        m_out, m_h1, _ = fused_ffn._kernel_fwd(x, w1, b1, w2, b2, masked,
                                               True)
        m_dx = fused_ffn._kernel_bwd_dx(dout, h1, w1, w2, masked)
    for name, got, want in (("out", m_out, out), ("h1", m_h1, h1),
                            ("dx", m_dx[0], dx), ("db1", m_dx[1], db1),
                            ("dh1", m_dx[3], dh1)):
        if not torch.equal(got, want):
            raise RuntimeError(f"kernel B / K2 with explicit masks: {name} "
                               f"differs from the Philox masks' run")

    # the autograd Function gives the same gradients as the direct calls
    xr = x.clone().requires_grad_()
    params = [t.clone().requires_grad_() for t in (w1, b1, w2, b2)]
    fused_ffn.fused_ffn(xr, *params, seed, DROP_P, DROP_P).backward(dout)
    for name, got, want in (("dx", xr.grad, dx), ("dw1", params[0].grad, dw1),
                            ("db1", params[1].grad, db1),
                            ("dw2", params[2].grad, dw2),
                            ("db2", params[3].grad, db2)):
        if not torch.equal(got, want.to(got.dtype)):
            raise RuntimeError(f"FusedFFN's {name} differs from K2's")
    del xr, params, m_out, m_h1, m_dx, masked

    # K2's dx kernel at every N it is held to: guard bands, repeats, plain
    dx_abs = max(float((a.float() - b.float()).abs().max())
                 for a, b in (checks["dx"], checks["db1"], checks["db2"]))
    for rows in (n, FT_ROWS, *K2_RAGGED_N):
        e = _check_k2_dx(gen, rows, seed, dev)
        dx_abs = max(dx_abs, e["dx"][1], e["db1"][1], e["db2"][1])
    # K2's dW kernel likewise
    dw_abs = max(float((a - b).abs().max())
                 for a, b in (checks["dw1"], checks["dw2"]))
    for rows in (*K2_RAGGED_N, n, FT_ROWS):
        dw_abs = max(dw_abs, _check_k2_dw(gen, rows, dev))

    flop = 4.0 * n * c * f
    with torch.no_grad():
        times = {
            "fwd": (cuda_ms(lambda: fused_ffn._kernel_fwd(
                        x, w1, b1, w2, b2, drop, True)),
                    cuda_ms(lambda: fused_ffn.ffn_plain_fwd(
                        x, w1, b1, w2, b2, keep_act, keep_hid))),
            "dw": (cuda_ms(lambda: fused_ffn._kernel_bwd_dw(x, gd, dh1, dh2)),
                   cuda_ms(lambda: fused_ffn.ffn_plain_bwd_dw(
                       x, gd, dh1, dh2))),
        }
    # the library: autograd's backward of library_ffn for the weights alone
    leaves = [t.to(torch.bfloat16).clone().requires_grad_()
              for t in (x, w1, b1, w2, b2)]
    with torch.enable_grad():
        o = library_ffn(*leaves)
        lib_dw = cuda_ms(lambda: torch.autograd.grad(
            o, leaves[1:], dout, retain_graph=True))
    del leaves, o
    bound_dw = bound(flop, nbytes(x, gd, dh1, dh2, dw1, dw2))
    for k, (ms, plain_ms) in times.items():
        line = (f"[K2] {k}: kernel {ms * 1e3:.1f} us/call "
                f"({flop / ms / 1e9:.1f} TFLOP/s), plain "
                f"{plain_ms * 1e3:.1f} us/call "
                f"({flop / plain_ms / 1e9:.1f} TFLOP/s)")
        if k == "dw":
            line += (f", autograd of F.linear-GELU-F.linear "
                     f"{lib_dw * 1e3:.1f} us/call; bound "
                     f"{bound_dw['bound_ms'] * 1e3:.1f} us "
                     f"({bound_dw['bound_by']})")
        log(line)
    del x, dout, h1, gd, dh1, dh2, keep_act, keep_hid
    dx_row = _time_k2_dx(gen, n, seed, dev)
    _time_k2_dx(gen, FT_ROWS, seed, dev)
    _time_k2_dw(gen, n, dev)
    _time_k2_dw(gen, FT_ROWS, dev)
    return [
        {"name": "fused_ffn_bwd_dx", "route": "cuda",
         "source": "nrse_tpu_torch/csrc/fused_ffn_bwd.cu",
         "replaces": "nrse_tpu/ops/fused_ffn.py:204",
         "max_abs_err": dx_abs, **dx_row},
        {"name": "fused_ffn_bwd_dw", "route": "cuda",
         "source": "nrse_tpu_torch/csrc/fused_ffn_bwd.cu",
         "replaces": "nrse_tpu/ops/fused_ffn.py:253",
         "max_abs_err": dw_abs,
         "ms": times["dw"][0], "plain_ms": times["dw"][1], **bound_dw,
         "library_ms": lib_dw},
    ]


def byol_sizes(cfg, projection_dim=1024, prediction_dim=2048):
    """``(online, target)`` parameter counts of the BYOL towers."""
    def count(m):
        return sum(p.numel() for p in m.parameters())
    return (count(OnlineNetwork(cfg, projection_dim, prediction_dim,
                                device="meta")),
            count(TargetNetwork(cfg, projection_dim, device="meta")))


def phase_k4() -> dict:
    """K4 over the full flat BYOL parameter set against the plain
    version, with a clipping grad norm."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    n, n_ema = byol_sizes(WavLMConfig.large())
    spec = fused_optimizer.FusedAdamWSpec(schedule=1e-5)
    p = torch.randn(n, generator=gen, device=dev)
    g = 1e-3 * torch.randn(n, generator=gen, device=dev)
    mu = 1e-3 * torch.randn(n, generator=gen, device=dev)
    nu = 1e-6 * torch.rand(n, generator=gen, device=dev)
    pt = p[:n_ema] + 1e-3 * torch.randn(n_ema, generator=gen, device=dev)
    grad_norm = torch.tensor(2.5, device=dev)  # above the clip norm 1.0
    ref = None
    with torch.no_grad():
        sc = fused_optimizer.scalars(spec, 3, grad_norm)
        ref = fused_optimizer.adamw_ema_plain(sc, g, p, mu, nu, pt)
        # the state it updates in place, and its gradient, inside NaN
        # guard bands
        with GuardBands(fused_optimizer) as guard:
            g, p, mu, nu, pt = (guard.band(t) for t in (g, p, mu, nu, pt))
            fused_optimizer.fused_adamw_ema_update(g, p, mu, nu, pt, spec, 3,
                                                   grad_norm)
            guard.check("K4")
    errs = {k: rel_err(a, b) for k, a, b in zip(
        ("p", "mu", "nu", "target"), (p, mu, nu, pt), ref)}
    abs_err = max(float((a - b).abs().max())
                  for a, b in zip((p, mu, nu, pt), ref))
    log(f"[K4] {n / 1e6:.1f} M params ({n_ema / 1e6:.1f} M with EMA), "
        f"guard bands untouched: max|Δ|/max|ref| vs plain " +
        ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if max(errs.values()) > OPT_TOL:
        raise RuntimeError(f"K4 disagrees with its plain version: {errs}")
    del ref
    with torch.no_grad():
        ms = cuda_ms(lambda: fused_optimizer._kernel(sc, g, p, mu, nu, pt),
                     iters=10)
        plain_ms = cuda_ms(lambda: fused_optimizer.adamw_ema_plain(
            sc, g, p, mu, nu, pt), iters=5, warmup=1)
    # each input read once (g, p, mu, nu, target), each output written once
    moved = nbytes(g, p, mu, nu, pt) + nbytes(p, mu, nu, pt)
    bd = bound(0.0, moved)
    # the library: fused AdamW over the same flat parameter, then the EMA
    param = torch.nn.Parameter(p.clone())
    param.grad = g.clone()
    target = pt.clone()
    opt = torch.optim.AdamW([param], lr=1e-5, weight_decay=1e-5, fused=True)

    def library_step():
        opt.step()
        torch._foreach_lerp_([target], [param.detach()[:n_ema]],
                             1.0 - spec.ema_decay)

    lib_ms = cuda_ms(library_step, iters=10)
    del param, target, opt
    log(f"[K4] kernel {ms * 1e3:.1f} us/call ({_gbps(moved, ms):.0f} GB/s), "
        f"plain {plain_ms * 1e3:.1f} us/call "
        f"({_gbps(moved, plain_ms):.0f} GB/s), AdamW(fused=True) + "
        f"_foreach_lerp_ {lib_ms * 1e3:.1f} us/call; bound "
        f"{bd['bound_ms'] * 1e3:.1f} us ({bd['bound_by']})")
    return {"name": "fused_adamw_ema", "route": "cuda",
            "source": "nrse_tpu_torch/csrc/fused_adamw_ema.cu",
            "replaces": "nrse_tpu/ops/fused_optimizer.py:75",
            "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms, **bd,
            "library_ms": lib_ms}


def _requests(rng: np.random.Generator, clip_seconds: float):
    """Three ragged requests ``(name, audio [N, T], lengths or None)``:
    one clip of 0.34 of the clip length (1.7 s of a 5 s clip), 6 clips of
    0.1-1 of it, 40 full clips."""
    clip = int(clip_seconds * SAMPLE_RATE)

    def clips(n, fractions):
        lengths = [int(f * clip) for f in fractions]
        out = np.zeros((n, clip), np.float32)
        for i, m in enumerate(lengths):
            out[i, :m] = 0.1 * rng.standard_normal(m)
        return out, lengths

    one, (one_len,) = clips(1, [0.34])
    six, six_len = clips(6, rng.uniform(0.1, 1.0, 6))
    forty, _ = clips(40, [1.0] * 40)
    return [(f"1 clip of {one_len / SAMPLE_RATE:g} s", one[:, :one_len],
             None),
            (f"6 clips of {min(six_len) / SAMPLE_RATE:.2f}-"
             f"{max(six_len) / SAMPLE_RATE:.2f} s", six, six_len),
            (f"40 clips of {clip_seconds:g} s", forty, None)]


def phase_serving(cfg=None, device=torch.device("cuda"),
                  clip_seconds: float = CLIP_SECONDS,
                  buckets=BUCKETS) -> dict:
    """The serving phase; its arguments let it be rehearsed at a small
    width on the CPU, with the wrappers' plain paths standing in."""

    cfg = cfg or WavLMConfig.large()
    t0 = time.perf_counter()
    sd = init_state_dict(cfg, torch.Generator().manual_seed(SEED))
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    art = tempfile.mkdtemp(prefix="smoke_artifact_",
                           dir=cuda_build.BUILD_DIR)
    try:
        export_embedder(sd, cfg, art, batch_sizes=buckets,
                        clip_seconds=clip_seconds, sample_rate=SAMPLE_RATE)
        server = ServingModel(art, device)
        ref_server = ServingModel(art, torch.device("cpu"))  # float32
    finally:
        shutil.rmtree(art)
    n_params = sum(v.numel() for v in sd.values())
    log(f"[serve] WavLM {cfg.num_hidden_layers} layers x "
        f"{cfg.hidden_size}, {n_params / 1e6:.1f} M params, exported and "
        f"loaded in {time.perf_counter() - t0:.1f} s")

    clip = server.clip_samples
    frames = int(cfg.feature_lengths(clip))
    for bkt in buckets:  # warm-up: cuDNN algorithm choice, allocator
        server(np.zeros((bkt, clip), np.float32))
    sync(device)

    reqs = _requests(np.random.default_rng(SEED), clip_seconds)
    forwards = sum(len(server.plan(len(a))) for _, a, _ in reqs)
    _reset_counts()
    results = []
    for name, audio, lengths in reqs:
        mask = None
        if lengths is not None:
            mask = (np.arange(audio.shape[1])[None, :]
                    < np.asarray(lengths)[:, None]).astype(np.int32)
        results.append(server(audio, mask))
    sync(device)
    launches = {"block_attention_fwd": block_attention.LAUNCHES,
                "fused_ffn_fwd": fused_ffn.LAUNCHES, **_frontend_counts()}
    want = {"block_attention_fwd": cfg.num_hidden_layers * forwards,
            "fused_ffn_fwd": cfg.num_hidden_layers * forwards,
            **frontend_want(cfg, forwards, 0)}
    log(f"[serve] {forwards} bucket forwards; launches {launches} "
        f"(want {want})")
    if launches != want:
        raise RuntimeError(f"kernel launches {launches} != {want}")

    for (name, audio, _), (seq, pooled) in zip(reqs, results):
        n = audio.shape[0]
        ok = (seq.shape == (n, frames, cfg.hidden_size)
              and pooled.shape == (n, cfg.hidden_size)
              and np.isfinite(seq).all() and np.isfinite(pooled).all())
        log(f"[serve] {name}: sequence {seq.shape}, pooled {pooled.shape}, "
            f"finite={ok}")
        if not ok:
            raise RuntimeError(f"bad serving output for {name}")

    # the same weights in float32 on the CPU, through the plain path
    ref_seq, ref_pooled = ref_server(reqs[0][1])
    del ref_server
    got = torch.from_numpy(results[0][1]).double()
    cos = torch.nn.functional.cosine_similarity(
        got, torch.from_numpy(ref_pooled).double(), dim=-1)
    seq_cos = torch.nn.functional.cosine_similarity(
        torch.from_numpy(results[0][0]).double().flatten(),
        torch.from_numpy(ref_seq).double().flatten(), dim=0)
    log(f"[serve] {reqs[0][0]}: pooled cosine vs float32 CPU "
        f"{[round(c, 6) for c in cos.tolist()]}, sequence cosine "
        f"{float(seq_cos):.6f}")
    if float(cos.min()) < COSINE_MIN:
        raise RuntimeError(f"pooled cosine {cos.tolist()} < {COSINE_MIN}")

    for bkt in buckets:
        audio = 0.1 * np.random.default_rng(bkt).standard_normal(
            (bkt, clip)).astype(np.float32)
        for _ in range(3):  # warm-up; the card idled during the CPU run
            server(audio)
        iters = 10
        sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            server(audio)
        sync(device)
        dt = (time.perf_counter() - t0) / iters
        log(f"[serve] bucket {bkt}: {dt * 1e3:.2f} ms/request, "
            f"{bkt * clip_seconds / dt:.1f} audio-sec/sec")
    if device.type == "cuda":
        log(f"[serve] peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def _train_batch(n: int, clip_seconds: float, device, seed: int = 0):
    """Synthetic clean speech, noise and SNRs as ``bench.py`` makes
    them."""
    rng = np.random.default_rng(seed)
    t = int(SAMPLE_RATE * clip_seconds)
    ax = np.arange(t) / SAMPLE_RATE
    clean = (0.3 * np.sin(2 * np.pi * rng.uniform(80, 300, (n, 1)) * ax)
             + 0.02 * rng.standard_normal((n, t))).astype(np.float32)
    noise = (0.2 * rng.standard_normal((n, t))).astype(np.float32)
    snr = rng.choice([2.0, 5.0, 10.0, 15.0, 20.0], n).astype(np.float32)
    return {k: torch.from_numpy(v).to(device)
            for k, v in (("clean", clean), ("noise", noise), ("snr", snr))}


def _adamw_spec():
    """The JAX preset's optimizer: lr 1e-5 cosine over 100000 steps, wd
    1e-5, clip 1.0, EMA 0.997 (``bench.py:1037-1075``)."""
    return fused_optimizer.FusedAdamWSpec(
        schedule=cosine_annealing(1e-5, 100000), weight_decay=1e-5,
        clip_norm=1.0, ema_decay=0.997)


def _reset_counts() -> None:
    block_attention.LAUNCHES = block_attention.BWD_LAUNCHES = 0
    flash_attention.LAUNCHES = 0
    flash_attention.DQ_LAUNCHES = flash_attention.DKV_LAUNCHES = 0
    fused_ffn.LAUNCHES = fused_ffn.DX_LAUNCHES = fused_ffn.DW_LAUNCHES = 0
    fused_dropout.LAUNCHES = 0
    fused_optimizer.LAUNCHES = 0
    fused_frontend.LAUNCHES = fused_frontend.BWD_LAUNCHES = 0
    pallas_norm.LAUNCHES = pallas_norm.BWD_LAUNCHES = 0


def _frontend_counts() -> dict:
    return {"fused_frontend_fwd": fused_frontend.LAUNCHES,
            "fused_frontend_bwd": fused_frontend.BWD_LAUNCHES,
            "channel_layernorm_fwd": pallas_norm.LAUNCHES,
            "channel_layernorm_bwd": pallas_norm.BWD_LAUNCHES}


def frontend_want(cfg, forwards: int, backwards: int) -> dict:
    """The frontend's launches for ``forwards`` encoder forwards of which
    ``backwards`` ran a backward: K6 on each layer of its shape, K7 on
    every other layer (the "layer" norm)."""
    dims = (1,) + tuple(cfg.conv_dim)
    k6 = sum(1 for i, (k, s) in enumerate(zip(cfg.conv_kernel,
                                              cfg.conv_stride))
             if s == fused_frontend.STRIDE and k in fused_frontend.KERNEL_SIZES
             and dims[i] == dims[i + 1])
    k7 = len(cfg.conv_dim) - k6
    if cfg.feat_extract_norm != "layer":
        k6 = k7 = 0
    return {"fused_frontend_fwd": k6 * forwards,
            "fused_frontend_bwd": k6 * backwards,
            "channel_layernorm_fwd": k7 * forwards,
            "channel_layernorm_bwd": k7 * backwards}


def _train_counts() -> dict:
    return {"fused_ffn_fwd": fused_ffn.LAUNCHES,
            "fused_ffn_bwd_dx": fused_ffn.DX_LAUNCHES,
            "fused_ffn_bwd_dw": fused_ffn.DW_LAUNCHES,
            "fused_dropout": fused_dropout.LAUNCHES,
            "fused_adamw_ema": fused_optimizer.LAUNCHES,
            "block_attention_fwd": block_attention.LAUNCHES,
            "block_attention_bwd": block_attention.BWD_LAUNCHES,
            **_frontend_counts()}


def byol_launch_want(cfg, metrics) -> dict:
    """The kernel launches of the BYOL train steps whose ``metrics`` are
    given, from the layers each tower ran (dropout on at every site)."""
    steps = len(metrics)
    on = sum(m["layers_online"] for m in metrics)
    tg = sum(m["layers_target"] for m in metrics)
    return {"fused_ffn_fwd": on + tg, "fused_ffn_bwd_dx": on,
            "fused_ffn_bwd_dw": on,
            # encoder site + the hidden site of each layer run; the online
            # tower's again in its backward (the attention output's site is
            # inside kernel A and K3)
            "fused_dropout": 2 * (steps + on) + steps + tg,
            "fused_adamw_ema": steps, "block_attention_fwd": on + tg,
            "block_attention_bwd": on,
            # both towers' frontends, the online tower's backward
            **frontend_want(cfg, 2 * steps, steps)}


def phase_training(cfg=None, device=torch.device("cuda"),
                   batch: int = TRAIN_BATCH,
                   clip_seconds: float = CLIP_SECONDS, warmup: int = 2,
                   steps: int = 5, projection_dim: int = 1024,
                   prediction_dim: int = 2048) -> dict:
    """The BYOL train step at full width with the JAX preset's
    hyper-parameters (dropout 0.1 at every site, LayerDrop 0.1,
    SpecAugment 0.05/10/2: ``WavLMConfig``'s defaults); its arguments let
    it be rehearsed at a small width on the CPU, with the wrappers' plain
    paths standing in."""
    cfg = cfg or WavLMConfig.large()
    t0 = time.perf_counter()
    sd = init_byol_state_dict(cfg, projection_dim, prediction_dim,
                              torch.Generator().manual_seed(SEED))
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    state = create_train_state(cfg, sd, projection_dim, prediction_dim,
                               device, seed=SEED, compute_dtype=dtype)
    del sd
    step = make_byol_train_step(_adamw_spec())
    data = _train_batch(batch, clip_seconds, device)
    log(f"[train] BYOL on WavLM {cfg.num_hidden_layers} x "
        f"{cfg.hidden_size}, projection {projection_dim}, prediction "
        f"{prediction_dim}: {state.params.numel() / 1e6:.1f} M online "
        f"params, {state.target_params.numel() / 1e6:.1f} M target; batch "
        f"{batch} x {clip_seconds:g} s; set up in "
        f"{time.perf_counter() - t0:.1f} s")

    def check(m, when):
        if not bool(m["finite"]):
            raise RuntimeError(f"non-finite loss or grad norm {when}: "
                               f"{float(m['loss'])} {float(m['grad_norm'])}")

    for i in range(warmup):
        if i == warmup - 1:  # the EMA of this step is checked exactly
            target_before = state.target_params.clone()
        m = step(state, data)
        check(m, f"at warm-up step {i}")
        log(f"[train] warm-up step {i}: loss {float(m['loss']):.6f}, "
            f"grad_norm {float(m['grad_norm']):.4f}, layers run "
            f"{m['layers_online']}/{m['layers_target']}")
    with torch.no_grad():  # in float32, as K4 rounds it
        ema = torch.tensor(_adamw_spec().ema_decay, dtype=torch.float32,
                           device=device)
        want = (ema * target_before
                + (1.0 - ema) * state.params[:target_before.numel()])
        ema_err = float((state.target_params - want).abs().max())
    del target_before, want
    log(f"[train] target after a step vs ema·target + (1−ema)·online: "
        f"max|Δ| {ema_err:.3e}")
    if ema_err != 0.0:
        raise RuntimeError(f"the target did not move by the EMA: {ema_err}")

    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    metrics = [step(state, data) for _ in range(steps)]
    sync(device)
    dt = (time.perf_counter() - t0) / steps
    counts = _train_counts()
    for i, m in enumerate(metrics):
        check(m, f"at timed step {i}")
    on = sum(m["layers_online"] for m in metrics)
    tg = sum(m["layers_target"] for m in metrics)
    want = byol_launch_want(cfg, metrics)
    log(f"[train] {steps} timed steps, layers run online {on}, target {tg}: "
        f"launches {counts} (want {want})")
    if counts != want:
        raise RuntimeError(f"kernel launches {counts} != {want}")
    log(f"[train] losses {[round(float(m['loss']), 6) for m in metrics]}, "
        f"grad norms {[round(float(m['grad_norm']), 4) for m in metrics]}")
    log(f"[train] {dt:.4f} s/step, {batch * clip_seconds / dt:.1f} "
        f"audio-sec/sec")
    if device.type == "cuda":
        log(f"[train] peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        # the step's device time by kernel group (PERF.md §5): the host
        # clock above also counts the host's gaps between launches
        profile_device(lambda: (step(state, data), sync(device)),
                       "[train] BYOL step", iters=2)

    loss, sim = make_byol_eval_step()(state, data)
    sync(device)
    if loss.shape != (batch,) or sim.shape != (batch,) or not (
            torch.isfinite(loss).all() and torch.isfinite(sim).all()):
        raise RuntimeError("bad eval step output")
    log(f"[eval] loss {float(loss.mean()):.6f}, clean-noisy cosine "
        f"{float(sim.mean()):.6f} (mean over {batch})")
    return counts


def _crosscheck_step(cfg, sd, batch: int, heads_on_batch_stats: bool):
    """One train step of the same weights and batch in bf16 on the card
    and in float32 on the CPU: ``(loss, grad_norm)`` of each, and the
    cosines of the whole flat gradient and of its encoder part."""
    grads, out = [], []
    for device, dtype in ((torch.device("cuda"), torch.bfloat16),
                          (torch.device("cpu"), torch.float32)):
        state = create_train_state(cfg, sd, 1024, 2048, device, seed=SEED,
                                   compute_dtype=dtype)
        if not heads_on_batch_stats:
            for head in (state.online.projector, state.online.predictor,
                         state.target.projector):
                head.eval()
        m = make_byol_train_step(_adamw_spec())(
            state, _train_batch(batch, CLIP_SECONDS, device, seed=1))
        out.append((float(m["loss"]), float(m["grad_norm"])))
        grads.append(state.grads.detach().double().cpu())
        n_enc = sum(p.numel() for p in state.online.encoder.parameters())
        del state
    cos = torch.nn.functional.cosine_similarity
    return (out, float(cos(grads[0], grads[1], dim=0)),
            float(cos(grads[0][:n_enc], grads[1][:n_enc], dim=0)))


def phase_crosscheck(layers: int = 4, batch: int = 2) -> None:
    """One train step at full width and ``layers`` deep, random features
    off, in bf16 on the card against float32 on the CPU through the plain
    paths, from the same weights and batch.  The bound holds the step
    with the heads' BatchNorm on its running statistics: over a batch of
    2, BatchNorm on batch statistics divides each feature by half the
    difference of its two values, and its backward magnifies bf16's
    rounding of the pooled embeddings until the gradient's direction is
    lost (bf16 against float32, both on the CPU, gives a cosine of -0.34
    there; PERF.md).  That step is measured and printed too."""
    cfg = WavLMConfig.large(num_hidden_layers=layers, hidden_dropout=0.0,
                            activation_dropout=0.0, attention_dropout=0.0,
                            layerdrop=0.0, mask_time_prob=0.0)
    sd = init_byol_state_dict(cfg, 1024, 2048,
                              torch.Generator().manual_seed(SEED + 5))
    torch.set_num_threads(os.cpu_count() or 1)
    for on_batch_stats in (False, True):
        ((loss_c, gn_c), (loss_f, gn_f)), cos, cos_enc = _crosscheck_step(
            cfg, sd, batch, on_batch_stats)
        stats = "batch statistics, not held to a bound" if on_batch_stats \
            else f"running statistics, cosine >= {COSINE_MIN}"
        log(f"[crosscheck] {layers} layers, batch {batch}, heads' BN on "
            f"{stats}: loss bf16 card {loss_c:.6f} vs f32 CPU {loss_f:.6f} "
            f"(Δ {loss_c - loss_f:.3e}); grad_norm ratio {gn_c / gn_f:.6f}; "
            f"gradient cosine {cos:.6f} (encoder part {cos_enc:.6f})")
        if not on_batch_stats and cos < COSINE_MIN:
            raise RuntimeError(f"gradient cosine {cos} < {COSINE_MIN}")


ENTRY_LAYERS = 2


def _write_corpus(root: str, n_clean: int, n_noise: int,
                  clip_seconds: float):
    """Synthetic clean speech (tones in noise) and noise clips as 16 kHz
    PCM16 WAV files under ``root/clean`` and ``root/noise``."""
    import wave

    def save_wav(path, x, sample_rate):
        pcm = np.clip(x * 32767.0, -32768, 32767).astype(np.int16)
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sample_rate)
            w.writeframes(pcm.tobytes())

    rng = np.random.default_rng(SEED)
    t = int(SAMPLE_RATE * clip_seconds)
    ax = np.arange(t) / SAMPLE_RATE
    dirs = [os.path.join(root, "clean"), os.path.join(root, "noise")]
    for path in dirs:
        os.makedirs(path)
    for i in range(n_clean):
        tone = (0.3 * np.sin(2 * np.pi * rng.uniform(80, 300) * ax)
                + 0.02 * rng.standard_normal(t))
        save_wav(os.path.join(dirs[0], f"c{i:03d}.wav"),
                 tone.astype(np.float32), SAMPLE_RATE)
    for i in range(n_noise):
        save_wav(os.path.join(dirs[1], f"n{i:03d}.wav"),
                 (0.2 * rng.standard_normal(t)).astype(np.float32),
                 SAMPLE_RATE)
    return dirs


def phase_entry(cfg=None, device=torch.device("cuda"), clips: int = 32,
                noise_clips: int = 4, batch: int = 8,
                clip_seconds: float = CLIP_SECONDS,
                projection_dim: int = 1024,
                prediction_dim: int = 2048) -> dict:
    """BYOL pretraining through ``train_byol.main`` on a synthetic corpus:
    2 epochs, the checkpoints, then a resumed third epoch.  Its arguments
    let it be rehearsed at a small width on the CPU."""
    import importlib.util

    cfg = cfg or WavLMConfig.large(num_hidden_layers=ENTRY_LAYERS)
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_corpus_", dir=cuda_build.BUILD_DIR)
    try:
        clean, noise = _write_corpus(root, clips, noise_clips, clip_seconds)
        ckpt = os.path.join(root, "ckpt")
        config = {
            "model": {"name": "microsoft/wavlm-large",
                      "projection_dim": projection_dim,
                      "prediction_dim": prediction_dim, "ema_decay": 0.997},
            "training": {"batch_size": batch, "num_workers": 8,
                         "num_epochs": 2, "learning_rate": 1e-5,
                         "weight_decay": 1e-5, "seed": SEED,
                         "checkpoint_dir": ckpt,
                         "log_dir": os.path.join(root, "logs")},
            "data": {"clean_data_path": clean, "noise_data_path": noise,
                     "sample_rate": SAMPLE_RATE,
                     "max_audio_length": clip_seconds,
                     "snr_range": [0, 5, 10, 15, 20],
                     "validation_ratio": 0.25},
            "device": device.type,
        }
        sync(device)
        _reset_counts()
        first = train_byol.main(config, cfg)
        sync(device)
        counts = _train_counts()
        epochs = first["epochs"]
        log(f"[entry] WavLM {cfg.num_hidden_layers} layers (depth cut) x "
            f"{cfg.hidden_size}, batch {batch} x {clip_seconds:g} s, "
            f"{clips} clean + {noise_clips} noise clips; audio decoder: "
            f"{first['decoder']}; PyYAML installed: "
            f"{importlib.util.find_spec('yaml') is not None}; launches "
            f"{counts}")
        if not all(n > 0 for n in counts.values()):
            raise RuntimeError(f"entry point: a kernel of the path never "
                               f"ran: {counts}")
        for e in epochs:
            if not (np.isfinite(e["train_loss"])
                    and np.isfinite(e["val_loss"])):
                raise RuntimeError(f"entry point: non-finite loss {e}")
        names = ("best_val_loss", "best_val_similarity", "last_model")
        missing = [n for n in names
                   if not os.path.isfile(os.path.join(ckpt, n, "state.pt"))]
        if missing or [e["epoch"] for e in epochs] != [0, 1]:
            raise RuntimeError(f"entry point: epochs {epochs}, missing "
                               f"checkpoints {missing}")
        size = os.path.getsize(os.path.join(ckpt, "last_model", "state.pt"))

        # the checkpoint restores into a state made from other weights
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        fresh = create_train_state(
            cfg, init_byol_state_dict(cfg, projection_dim, prediction_dim,
                                      torch.Generator().manual_seed(SEED + 7)),
            projection_dim, prediction_dim, device, seed=SEED + 7,
            compute_dtype=dtype)
        fresh, meta = restore_checkpoint(ckpt, "last_model", fresh)
        saved, got = state_tensors(first["state"]), state_tensors(fresh)
        if got.keys() != saved.keys() or not all(
                torch.equal(got[k], saved[k]) for k in saved) or \
                (fresh.step, fresh.seed) != (first["state"].step, SEED):
            raise RuntimeError("entry point: the restored state differs from "
                               "the saved one")
        step_after_two = first["state"].step
        del fresh, saved, got, first

        second = train_byol.main(dict(config, resume=True, training=dict(
            config["training"], num_epochs=3)), cfg)
        sync(device)
        resumed = second["epochs"]
        if [e["epoch"] for e in resumed] != [2] or \
                second["state"].step != step_after_two + resumed[0]["steps"] \
                or not np.isfinite(resumed[0]["train_loss"]):
            raise RuntimeError(f"entry point: the resumed run {resumed}")
        log(f"[entry] 3 checkpoints ({size / 2**20:.1f} MiB each), "
            f"last_model restored bit for bit (step {step_after_two}); "
            f"resumed at epoch {resumed[0]['epoch']}, step "
            f"{second['state'].step}")
        for e in epochs + resumed:
            log(f"[entry] epoch {e['epoch']}: train loss "
                f"{e['train_loss']:.6f}, val loss {e['val_loss']:.6f}, val "
                f"similarity {e['val_avg_similarity']:.6f}; {e['steps']} "
                f"data-fed steps at {e['s_per_step']:.4f} s/step "
                f"({e['audio_sec_per_sec']:.1f} audio-sec/sec; "
                f"{cfg.num_hidden_layers} layers deep, not the 24-layer "
                f"model)")
        return counts
    finally:
        shutil.rmtree(root, ignore_errors=True)


# (B, T) of the comparisons: T ≡ 1 (mod 64) twice and T ≡ 1 (mod 128)
# (a last key tile of one key; 127 padded keys at 513), T = 512 (no padded
# key), the evaluator's 10, 15 and 30 s buckets at batch 4 and at its
# batch of 32, one 64 s clip (the TPU kernels' streamed regime) and a
# 164 s one (the longest whose dense plain version fits the card).  The
# batch-32 cases and the 64 s clip are also timed.
K5_CASES = ((4, 385), (4, 449), (4, 513), (4, 512), (4, 499), (4, 749),
            (4, 1499), (32, 499), (32, 749), (32, 1499), (1, 3199),
            (1, 8191))
K5_TIMED = ((32, 499), (32, 749), (32, 1499), (1, 3199))
K5_ROW_T = 499  # the K5 bucket with the most batches: the JSON row


def _k5_inputs(gen, b, t, lengths, h=16, d=64):
    dev = torch.device("cuda")
    q, k, v = (torch.randn(b, h, t, d, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    gate = 1.0 + torch.rand(b, h, t, generator=gen, device=dev)
    bias_rel = torch.randn(h, 2 * t, generator=gen,
                           device=dev).to(torch.bfloat16)
    mask = (torch.arange(t, device=dev)[None, :]
            < lengths[:, None]).to(torch.int32)
    return q, k, v, gate, bias_rel, mask


def phase_k5() -> dict:
    """K5 against its plain version at the SER buckets' lengths (at the
    evaluator's batch of 32 too) and a 64 s clip's, then its time at
    batch 32 beside plain and SDPA."""
    check_hgmma("flash_attention_fwd_wgmma", tag="K5")
    check_no_spills(kernel_resources(("flash_attention_fwd_wgmma",),
                                     tag="K5"), "K5's forward")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    h, d = 16, 64
    worst, row = 0.0, None
    for b, t in K5_CASES:
        lengths = torch.randint(t // 4, t + 1, (b,), generator=gen,
                                device=dev)
        lengths[0] = t
        if b > 1:
            lengths[1] = 0  # a row that pads a bucket's last batch
        q, k, v, gate, bias_rel, mask = _k5_inputs(gen, b, t, lengths)
        madd = mask_add(mask, b, t, dev)
        with GuardBands(flash_attention) as guard, torch.no_grad():
            out, lse = flash_attention.flash_gated_attention_lse(
                *(guard.band(x) for x in (q, k, v, gate, bias_rel, mask)))
            guard.check(f"K5 at B={b} T={t}")
        with torch.no_grad():
            ref, ref_lse = flash_attention.flash_attention_plain_fwd(
                q, k, v, gate, bias_rel, madd)
        if not (torch.isfinite(out.float()).all()
                and torch.isfinite(lse).all()):
            raise RuntimeError(f"K5: non-finite output at B={b} T={t}")
        rows = lengths > 0
        e_out = rel_err(out[rows], ref[rows])
        e_lse = rel_err(lse[rows], ref_lse[rows])
        e_masked = rel_err(out[~rows], ref[~rows]) if (~rows).any() \
            else 0.0
        abs_err = float((out.float() - ref.float()).abs().max())
        log(f"[K5] B={b} H={h} T={t} D={d}, key lengths "
            f"{sorted(lengths.tolist())[:4]}..., guard bands untouched: out "
            f"rel {e_out:.3e} (abs "
            f"{abs_err:.3e}), lse rel {e_lse:.3e}, wholly masked rows rel "
            f"{e_masked:.3e}")
        if e_out > OUT_TOL or e_lse > LSE_TOL or e_masked > OUT_TOL:
            raise RuntimeError(f"K5 disagrees with its plain version at "
                               f"B={b} T={t}: out {e_out}, lse {e_lse}, "
                               f"masked rows {e_masked}")
        worst = max(worst, abs_err)
        del ref, ref_lse
        if (b, t) not in K5_TIMED:
            continue
        with torch.no_grad():
            ms = cuda_ms(lambda: flash_attention.flash_gated_attention_lse(
                q, k, v, gate, bias_rel, mask))
            plain_ms = cuda_ms(
                lambda: flash_attention.flash_attention_plain_fwd(
                    q, k, v, gate, bias_rel, madd), iters=5, warmup=1)
            full = dense_bias(gate, flash_attention.dense_bias_from_rel(
                bias_rel, t), madd)
            lib_ms = cuda_ms(lambda: torch.nn.functional
                             .scaled_dot_product_attention(q, k, v,
                                                           attn_mask=full),
                             iters=10)
            del full
            us = device_us(lambda: flash_attention._kernel_fwd(
                q, k, v, gate, bias_rel, madd))
        check_group(us, "K5 (flash attention)")
        flop = 4.0 * b * h * t * t * d
        bd = bound(flop, nbytes(q, k, v, gate, bias_rel, madd, out, lse))
        log(f"[K5] B={b} H={h} T={t} D={d}: kernel {ms * 1e3:.1f} us/call "
            f"({flop / ms / 1e9:.1f} TFLOP/s), plain {plain_ms * 1e3:.1f} "
            f"us/call, SDPA with the dense bias {lib_ms * 1e3:.1f} us/call; "
            f"bound {bd['bound_ms'] * 1e3:.1f} us ({bd['bound_by']}); on "
            f"the card (us): {_us_line(us)}")
        if t == K5_ROW_T:
            row = {"ms": ms, "plain_ms": plain_ms, **bd,
                   "library_ms": lib_ms}
    del q, k, v, out
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "nrse_tpu_torch/csrc/flash_attention_fwd.cu",
            "replaces": "nrse_tpu/ops/flash_attention.py:150, :564",
            "max_abs_err": worst, **row}


K5_BWD_ROW = (32, 499)  # the fine-tune's shape: the backward's JSON rows
DQ_NAMES = ("dq", "dgate", "dbias")
DKV_NAMES = ("dk", "dv")


def phase_k5_bwd() -> list:
    """K5's dq and dk/dv kernels against the plain backward at the forward's
    shapes, with ragged keys and, for B > 1, a wholly masked batch row:
    delta equal to its contract, the gradients within 1e-2 of plain, two
    calls bit-equal, the autograd Function equal to the direct calls; µs
    per call of each kernel, the pair, plain and SDPA's backward at the
    timed shapes, the pair's device time by kernel."""
    for pattern in ("flash_attention_bwd_dq_wgmma",
                    "flash_attention_bwd_dkv_wgmma"):
        check_hgmma(pattern, tag="K5 bwd")
    check_no_spills(kernel_resources(
        ("flash_attention_bwd_dq_wgmma", "flash_attention_bwd_dkv_wgmma",
         "flash_attention_bwd_delta", "flash_dbias_fold"), tag="K5 bwd"),
        "K5's backward kernels")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    h, d = 16, 64
    worst = {"dq": 0.0, "dkv": 0.0}
    rows = {}
    for b, t in K5_CASES:
        lengths = torch.randint(t // 4, t + 1, (b,), generator=gen,
                                device=dev)
        lengths[0] = t
        if b > 1:
            lengths[1] = 0  # a row that pads a bucket's last batch
        q, k, v, gate, bias_rel, mask = _k5_inputs(gen, b, t, lengths)
        do = torch.randn(b, h, t, d, generator=gen,
                         device=dev).to(torch.bfloat16)
        madd = mask_add(mask, b, t, dev).contiguous()
        # every input, output and scratch buffer inside NaN guard bands
        with GuardBands(flash_attention) as guard, torch.no_grad():
            args = [guard.band(x) for x in (q, k, v, gate, bias_rel, madd)]
            out, lse = flash_attention._kernel_fwd(*args)
            gdo = guard.band(do)
            grads = flash_attention._kernel_bwd(*args, out, lse, gdo)
            again = flash_attention._kernel_bwd(*args, out, lse, gdo)
            if hasattr(flash_attention, "bwd_delta"):
                # the pre-pass's delta against its contract, bit for bit
                ins = flash_attention.bwd_inputs(*args, out, lse, gdo)
                flash_attention.launch_bwd_dq(*ins)
                if not torch.equal(ins[-1],
                                   flash_attention.bwd_delta(gdo, out)):
                    raise RuntimeError(f"K5 backward: delta differs from "
                                       f"its contract at B={b} T={t}")
                del ins
            guard.check(f"K5 backward at B={b} T={t}")
        with torch.no_grad():
            refs = flash_attention.flash_attention_plain_bwd(
                q, k, v, gate, bias_rel, madd, out, lse, do)
        names = ("dq", "dk", "dv", "dgate", "dbias")
        if not all(torch.isfinite(x.float()).all() for x in grads):
            raise RuntimeError(f"K5 backward: non-finite output at B={b} "
                               f"T={t}")
        for name, a, a2 in zip(names, grads, again):
            if not torch.equal(a, a2):
                raise RuntimeError(f"K5 backward: two calls differ in {name} "
                                   f"at B={b} T={t}")
        errs = {n: rel_err(a, r) for n, a, r in zip(names, grads, refs)}
        ok = lengths > 0
        masked = {n: rel_err(a[~ok], r[~ok]) for n, a, r in
                  zip(names[:4], grads[:4], refs[:4])} if (~ok).any() else {}
        log(f"[K5 bwd] B={b} H={h} T={t} D={d}: two calls bit-equal, guard "
            f"bands untouched; "
            f"max|Δ|/max|ref| vs plain " + ", ".join(
                f"{n} {e:.2e}" for n, e in errs.items())
            + ("; the wholly masked row's " + ", ".join(
                f"{n} {e:.2e}" for n, e in masked.items()) if masked else ""))
        if max(errs.values()) > OUT_TOL or \
                max(masked.values(), default=0.0) > OUT_TOL:
            raise RuntimeError(f"K5 backward disagrees with plain at B={b} "
                               f"T={t}: {errs}, masked rows {masked}")
        absd = {n: float((a.float() - r.float()).abs().max())
                for n, a, r in zip(names, grads, refs)}
        worst["dq"] = max(worst["dq"], *(absd[n] for n in DQ_NAMES))
        worst["dkv"] = max(worst["dkv"], *(absd[n] for n in DKV_NAMES))
        del refs, again

        # the autograd Function gives the direct calls' bits
        leaves = [x.clone().requires_grad_()
                  for x in (q, k, v, gate, bias_rel)]
        o = flash_attention.flash_gated_attention(*leaves, mask)
        o.backward(do)
        if not torch.equal(o.detach(), out):
            raise RuntimeError("K5: the Function's output differs from the "
                               "forward kernel's")
        for name, leaf, want in zip(names, leaves, grads):
            if not torch.equal(leaf.grad, want.to(leaf.grad.dtype)):
                raise RuntimeError(f"K5: the Function's {name} differs from "
                                   f"the backward kernels'")
        del leaves, o
        if (b, t) not in K5_TIMED:
            continue

        with torch.no_grad():
            ins = flash_attention.bwd_inputs(q, k, v, gate, bias_rel, madd,
                                             out, lse, do)
            dq_ms = cuda_ms(lambda: flash_attention.launch_bwd_dq(*ins))
            dkv_ms = cuda_ms(lambda: flash_attention.launch_bwd_dkv(*ins))
            pair_ms = cuda_ms(lambda: flash_attention._kernel_bwd(
                q, k, v, gate, bias_rel, madd, out, lse, do))
            plain_ms = cuda_ms(
                lambda: flash_attention.flash_attention_plain_bwd(
                    q, k, v, gate, bias_rel, madd, out, lse, do),
                iters=3, warmup=1)
            del ins
            us = device_us(lambda: flash_attention._kernel_bwd(
                q, k, v, gate, bias_rel, madd, out, lse, do))
        if hasattr(flash_attention, "bwd_delta"):
            # (an earlier K5 formed delta in torch, outside the group)
            check_group(us, "K5 backward (delta, dq, dk/dv, dbias fold)")
        # the library: SDPA's backward with the dense float bias requiring
        # grad, built outside the timed call
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        full = dense_bias(gate, flash_attention.dense_bias_from_rel(
            bias_rel, t), madd).requires_grad_()
        with torch.enable_grad():
            o = torch.nn.functional.scaled_dot_product_attention(
                *leaves, attn_mask=full)
            lib_ms = cuda_ms(lambda: torch.autograd.grad(
                o, leaves + [full], do, retain_graph=True), iters=5)
        del leaves, full, o
        product = 2.0 * b * h * t * t * d
        moved = nbytes(q, k, v, out, do, *grads[:3])
        bd = {"dq": bound(3 * product, nbytes(q, k, v, do, grads[0])),
              "dkv": bound(4 * product, nbytes(q, k, v, do, *grads[1:3])),
              "pair": bound(5 * product, moved)}
        log(f"[K5 bwd] B={b} H={h} T={t} D={d}: dq kernel {dq_ms * 1e3:.1f} "
            f"us/call (bound {bd['dq']['bound_ms'] * 1e3:.1f} us), dk/dv "
            f"kernel {dkv_ms * 1e3:.1f} us/call (bound "
            f"{bd['dkv']['bound_ms'] * 1e3:.1f} us), the pair "
            f"{pair_ms * 1e3:.1f} us/call ({5 * product / pair_ms / 1e9:.1f} "
            f"TFLOP/s of the 5 products; bound "
            f"{bd['pair']['bound_ms'] * 1e3:.1f} us, "
            f"{bd['pair']['bound_by']}); plain {plain_ms * 1e3:.1f} "
            f"us/call; SDPA's backward with the dense bias {lib_ms * 1e3:.1f} "
            f"us/call; the pair on the card (us): {_us_line(us)}")
        rows[(b, t)] = {"dq": (dq_ms, bd["dq"]), "dkv": (dkv_ms, bd["dkv"]),
                        "plain_ms": plain_ms, "library_ms": lib_ms}
    del q, k, v, out, do, grads
    row = rows[K5_BWD_ROW]
    out = []
    for key, name, line in (("dq", "flash_attention_bwd_dq", ":288, :656"),
                            ("dkv", "flash_attention_bwd_dkv",
                             ":401, :774")):
        ms, bd = row[key]
        out.append({"name": name, "route": "cuda",
                    "source": "nrse_tpu_torch/csrc/flash_attention_bwd.cu",
                    "replaces": f"nrse_tpu/ops/flash_attention.py{line}",
                    "max_abs_err": worst[key], "ms": ms,
                    "plain_ms": row["plain_ms"], **bd,
                    "library_ms": row["library_ms"]})
    return out


class GuardBands:
    """Guard bands around a kernel call's tensors.  Within the block, the
    given ops modules' ``torch.empty`` and ``torch.empty_like`` return
    views into buffers ``PAD`` elements longer on each side whose margins
    hold NaN (an integer type's least value for integer tensors, such as
    key masks), so every output and scratch buffer a wrapper allocates is
    banded; :meth:`band` copies an input into such a buffer.  :meth:`check`
    raises if any margin no longer holds NaN (a write past a buffer); a
    read past an input reads NaN and shows in the outputs."""

    PAD = 4096  # elements: keeps the views 16-byte aligned

    def __init__(self, *modules):
        self.modules = modules
        self.buffers = []
        guard = self

        class Proxy:
            def __getattr__(self, name):
                return getattr(torch, name)

            @staticmethod
            def empty(*size, dtype=None, device=None):
                if len(size) == 1 and not isinstance(size[0], int):
                    size = tuple(size[0])
                return guard._banded(size, dtype or torch.float32, device)

            @staticmethod
            def empty_like(t):
                return guard._banded(tuple(t.shape), t.dtype, t.device)

        self.proxy = Proxy()

    @staticmethod
    def _fill(dtype):
        """The margins' value: NaN, or for an integer type its least."""
        return float("nan") if dtype.is_floating_point \
            else torch.iinfo(dtype).min

    def _banded(self, size, dtype, device):
        n = int(np.prod(size))
        buf = torch.full((n + 2 * self.PAD,), self._fill(dtype), dtype=dtype,
                         device=device)
        self.buffers.append((buf, n))
        return buf[self.PAD:self.PAD + n].view(size)

    def band(self, t):
        view = self._banded(tuple(t.shape), t.dtype, t.device)
        view.copy_(t)
        return view

    def __enter__(self):
        for m in self.modules:
            m.torch = self.proxy
        return self

    def __exit__(self, *exc):
        for m in self.modules:
            m.torch = torch

    def check(self, what: str) -> None:
        torch.cuda.synchronize()
        for buf, n in self.buffers:
            margins = torch.cat([buf[:self.PAD], buf[self.PAD + n:]])
            fill = self._fill(buf.dtype)
            if not (torch.isnan(margins.float()).all()
                    if buf.dtype.is_floating_point
                    else (margins == fill).all()):
                raise RuntimeError(f"{what}: a write past a buffer of "
                                   f"{n} elements (guard band changed)")


FRONTEND_C = 512
LN_EPS = 1e-5
LONG_CLIP_SECONDS = 64.0  # phase 12's clip; K6's serving entry alone
# K6's kernels on wgmma (HGMMA in their SASS, no spills)
K6_WGMMA = ("k6_fwd_wgmma", "k6_dx_wgmma", "k6_dw_wgmma")
RSTD_TOL = 1e-4    # max|Δ| / max|ref| of rstd, mean and inv


def frontend_shapes(batch: int, clip_seconds: float):
    """``(layer 0's rows, [(T_in, k) of each K6 layer]``) of wavlm-large's
    frontend on ``batch`` clips of ``clip_seconds``."""
    cfg = WavLMConfig.large()
    t = (int(clip_seconds * SAMPLE_RATE) - cfg.conv_kernel[0]) \
        // cfg.conv_stride[0] + 1
    layers = []
    for k, s in zip(cfg.conv_kernel[1:], cfg.conv_stride[1:]):
        layers.append((t, k))
        t = (t - k) // s + 1
    return batch * layers[0][0], layers


def _k6_inputs(gen, b, t_in, k, dev):
    c = FRONTEND_C
    x = torch.randn(b, t_in, c, generator=gen, device=dev).to(torch.bfloat16)
    kernel = torch.randn(k, c, c, generator=gen, device=dev) * (k * c) ** -0.5
    vecs = [0.1 * torch.randn(c, generator=gen, device=dev),
            1.0 + 0.1 * torch.randn(c, generator=gen, device=dev),
            0.1 * torch.randn(c, generator=gen, device=dev)]
    t_out = fused_frontend.out_length(t_in, k)
    dout = (0.1 * torch.randn(b, t_out, c, generator=gen, device=dev)
            ).to(torch.bfloat16)
    return x, kernel, vecs, dout


K6_GRADS = ("dx", "dkernel", "dbias", "dscale", "dln_bias")


def _check_k6(gen, b, t_in, k, dev) -> dict:
    """K6 forward and backward at one shape against plain, bit-equal
    repeats, the Function against the direct calls, and guard bands."""
    x, kernel, (bias, scale, ln_bias), dout = _k6_inputs(gen, b, t_in, k, dev)
    with torch.no_grad():
        out, xhat, rstd = fused_frontend._kernel_fwd(
            x, kernel, bias, scale, ln_bias, LN_EPS, True)
        serve_out = fused_frontend._kernel_fwd(
            x, kernel, bias, scale, ln_bias, LN_EPS, False)[0]
        grads = fused_frontend._kernel_bwd(dout, x, xhat, rstd, kernel,
                                           scale, ln_bias)
        again = fused_frontend._kernel_bwd(dout, x, xhat, rstd, kernel,
                                           scale, ln_bias)
        torch.cuda.synchronize()
        refs_fwd = fused_frontend.conv_ln_gelu_plain_fwd(
            x, kernel, bias, scale, ln_bias, LN_EPS)
        refs = fused_frontend.conv_ln_gelu_plain_bwd(
            dout, x, xhat, rstd, kernel, scale, ln_bias)
    where = f"B={b} T_in={t_in} k={k}"
    if not torch.equal(out, serve_out):
        raise RuntimeError(f"K6 {where}: the serving entry's output differs "
                           f"from the training entry's")
    for name, a, a2 in zip(K6_GRADS, grads, again):
        if not torch.equal(a, a2):
            raise RuntimeError(f"K6 {where}: two backward calls differ in "
                               f"{name}")
    if not all(torch.isfinite(t.float()).all()
               for t in (out, xhat, rstd, *grads)):
        raise RuntimeError(f"K6 {where}: non-finite output")
    errs = {"out": rel_err(out, refs_fwd[0]), "xhat": rel_err(xhat,
                                                               refs_fwd[1])}
    errs.update({n: rel_err(a, r) for n, a, r in zip(K6_GRADS, grads, refs)})
    e_rstd = rel_err(rstd, refs_fwd[2])
    absd = max(float((a.float() - r.float()).abs().max())
               for a, r in zip((out, xhat, *grads), (*refs_fwd[:2], *refs)))
    del refs, refs_fwd, again

    # the autograd Function gives the direct calls' bits
    leaves = [t.clone().requires_grad_()
              for t in (x, kernel, bias, scale, ln_bias)]
    o = fused_frontend.fused_conv_ln_gelu(*leaves, LN_EPS)
    o.backward(dout)
    if not torch.equal(o.detach(), out):
        raise RuntimeError(f"K6 {where}: the Function's output differs")
    for name, leaf, want in zip(K6_GRADS, leaves, grads):
        if not torch.equal(leaf.grad, want.to(leaf.grad.dtype)):
            raise RuntimeError(f"K6 {where}: the Function's {name} differs")
    del leaves, o

    # every input, the bf16 weight operands the wrappers make
    # (fwd_weight, bwd_weight), every output and scratch buffer inside NaN
    # guard bands
    with GuardBands(fused_frontend) as g, torch.no_grad():
        gx, gk, gdout = g.band(x), g.band(kernel), g.band(dout)
        gv = [g.band(v) for v in (bias, scale, ln_bias)]
        g_out, g_xhat, g_rstd = fused_frontend._kernel_fwd(
            gx, gk, *gv, LN_EPS, True)
        g_grads = fused_frontend._kernel_bwd(gdout, gx, g_xhat, g_rstd, gk,
                                             gv[1], gv[2])
        g.check(f"K6 {where}")
    for name, a, want in zip(("out", "xhat", "rstd", *K6_GRADS),
                             (g_out, g_xhat, g_rstd, *g_grads),
                             (out, xhat, rstd, *grads)):
        if not torch.equal(a, want):
            raise RuntimeError(f"K6 {where}: inside guard bands {name} "
                               f"differs (a read past a buffer)")
    log(f"[8d K6] {where}: max|Δ|/max|ref| vs plain " + ", ".join(
        f"{n} {e:.2e}" for n, e in errs.items()) + f", rstd {e_rstd:.2e}; "
        f"two backward calls bit-equal, the Function = the direct calls, "
        f"guard bands untouched")
    if max(errs.values()) > OUT_TOL or e_rstd > RSTD_TOL:
        raise RuntimeError(f"K6 disagrees with plain at {where}: {errs}, "
                           f"rstd {e_rstd}")
    return {"abs": absd, "tensors": (x, kernel, bias, scale, ln_bias, dout,
                                     out, xhat, rstd, grads)}


def _check_k6_serving(gen, b, t_in, k, dev) -> float:
    """K6's serving entry alone (out only: no x̂, no rstd) at one shape
    against plain, two calls bit-equal, inside guard bands; returns
    max|Δ|."""
    x, kernel, (bias, scale, ln_bias), _ = _k6_inputs(gen, b, t_in, k, dev)
    with torch.no_grad():
        out = fused_frontend._kernel_fwd(x, kernel, bias, scale, ln_bias,
                                         LN_EPS, False)[0]
        again = fused_frontend._kernel_fwd(x, kernel, bias, scale, ln_bias,
                                           LN_EPS, False)[0]
        torch.cuda.synchronize()
        ref = fused_frontend.conv_ln_gelu_plain_fwd(x, kernel, bias, scale,
                                                    ln_bias, LN_EPS)[0]
    where = f"serving B={b} T_in={t_in} k={k}"
    if not torch.equal(out, again):
        raise RuntimeError(f"K6 {where}: two calls differ")
    if not torch.isfinite(out.float()).all():
        raise RuntimeError(f"K6 {where}: non-finite output")
    err = rel_err(out, ref)
    absd = float((out.float() - ref.float()).abs().max())
    del ref, again
    with GuardBands(fused_frontend) as g, torch.no_grad():
        gx, gk = g.band(x), g.band(kernel)
        gv = [g.band(v) for v in (bias, scale, ln_bias)]
        g_out = fused_frontend._kernel_fwd(gx, gk, *gv, LN_EPS, False)[0]
        g.check(f"K6 {where}")
    if not torch.equal(g_out, out):
        raise RuntimeError(f"K6 {where}: inside guard bands out differs")
    log(f"[8d K6] {where}: max|Δ|/max|ref| vs plain {err:.2e}; two calls "
        f"bit-equal, guard bands untouched")
    if err > OUT_TOL:
        raise RuntimeError(f"K6 disagrees with plain at {where}: {err}")
    return absd


def library_conv_ln_gelu(x, w, b, g, beta):
    """The library composition K6 is held against: cuDNN's conv1d on the
    channels-last input, ``F.layer_norm`` and exact GELU, in bf16."""
    f = torch.nn.functional
    z = f.conv1d(x.transpose(1, 2), w, b, stride=2).transpose(1, 2)
    return f.gelu(f.layer_norm(z, (z.shape[-1],), g, beta, LN_EPS),
                  approximate="none")


def _time_k6(tensors, k, by_kernel: bool = False) -> dict:
    """K6's forward and backward at one shape beside plain, the library
    composition and the bound; with ``by_kernel`` also the card's time of
    each of their kernels."""
    x, kernel, bias, scale, ln_bias, dout, out, xhat, rstd, grads = tensors
    b, t_in, c = x.shape
    t_out = out.shape[1]
    if by_kernel:
        with torch.no_grad():
            fwd_us = device_us(lambda: fused_frontend._kernel_fwd(
                x, kernel, bias, scale, ln_bias, LN_EPS, True), iters=5)
            bwd_us = device_us(lambda: fused_frontend._kernel_bwd(
                dout, x, xhat, rstd, kernel, scale, ln_bias), iters=5)
        log(f"[8d K6] B={b} T_in={t_in} k={k}: device us a call, forward "
            f"{_us_line(fwd_us)}; backward (row pass, dx, dW, folds) "
            f"{_us_line(bwd_us)}, in all {sum(bwd_us.values()):.1f}")
    with torch.no_grad():
        fwd = cuda_ms(lambda: fused_frontend._kernel_fwd(
            x, kernel, bias, scale, ln_bias, LN_EPS, True), iters=10)
        serve = cuda_ms(lambda: fused_frontend._kernel_fwd(
            x, kernel, bias, scale, ln_bias, LN_EPS, False), iters=10)
        bwd = cuda_ms(lambda: fused_frontend._kernel_bwd(
            dout, x, xhat, rstd, kernel, scale, ln_bias), iters=10)
        plain_fwd = cuda_ms(lambda: fused_frontend.conv_ln_gelu_plain_fwd(
            x, kernel, bias, scale, ln_bias, LN_EPS), iters=3, warmup=1)
        plain_bwd = cuda_ms(lambda: fused_frontend.conv_ln_gelu_plain_bwd(
            dout, x, xhat, rstd, kernel, scale, ln_bias), iters=3, warmup=1)
    bf = torch.bfloat16
    lib_in = [x.clone().requires_grad_(),
              kernel.permute(2, 1, 0).to(bf).contiguous().requires_grad_()] \
        + [v.to(bf).requires_grad_() for v in (bias, scale, ln_bias)]
    with torch.no_grad():
        lib_fwd = cuda_ms(lambda: library_conv_ln_gelu(*lib_in), iters=10)
    with torch.enable_grad():
        o = library_conv_ln_gelu(*lib_in)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(
            o, lib_in, dout, retain_graph=True), iters=10)
    del o, lib_in
    flop = 2.0 * b * t_out * k * c * c
    w_bf16 = fused_frontend.fwd_weight(kernel)
    bounds = {"fwd": bound(flop, nbytes(x, w_bf16, bias, scale, ln_bias, out,
                                        xhat, rstd)),
              "bwd": bound(2 * flop, nbytes(dout, x, xhat, rstd, w_bf16,
                                            scale, ln_bias, *grads))}
    log(f"[8d K6] B={b} T_in={t_in} k={k}: forward {fwd * 1e3:.1f} us/call "
        f"({flop / fwd / 1e9:.1f} TFLOP/s; serving entry {serve * 1e3:.1f}), "
        f"plain {plain_fwd * 1e3:.1f}, cuDNN conv1d-layer_norm-GELU "
        f"{lib_fwd * 1e3:.1f}, bound {bounds['fwd']['bound_ms'] * 1e3:.1f} us "
        f"({bounds['fwd']['bound_by']}); backward {bwd * 1e3:.1f} us/call "
        f"({2 * flop / bwd / 1e9:.1f} TFLOP/s), plain {plain_bwd * 1e3:.1f}, "
        f"autograd of the library composition {lib_bwd * 1e3:.1f}, bound "
        f"{bounds['bwd']['bound_ms'] * 1e3:.1f} us "
        f"({bounds['bwd']['bound_by']})")
    return {"fwd": {"ms": fwd, "plain_ms": plain_fwd, **bounds["fwd"],
                    "library_ms": lib_fwd},
            "bwd": {"ms": bwd, "plain_ms": plain_bwd, **bounds["bwd"],
                    "library_ms": lib_bwd}}


def layer0_conv_cudnn(audio, weight, bias):
    """Layer 0 by cuDNN's conv1d, then one transpose to channels-last (the
    alternative to ``wavlm.strided_conv`` timed in phase 8d)."""
    return torch.nn.functional.conv1d(
        audio[:, None, :], weight, bias,
        stride=WavLMConfig.large().conv_stride[0]).transpose(1, 2).contiguous()


def _check_k7(gen, x2, dev) -> dict:
    """K7 forward and backward on rows ``x2`` against plain, bit-equal
    repeats, the Function against the direct calls, and guard bands."""
    n, c = x2.shape
    scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
    bias = 0.1 * torch.randn(c, generator=gen, device=dev)
    dy = torch.randn(n, c, generator=gen, device=dev).to(torch.bfloat16)
    with torch.no_grad():
        out, mean, inv = pallas_norm._kernel_fwd(x2, scale, bias, LN_EPS,
                                                 True)
        serve_out = pallas_norm._kernel_fwd(x2, scale, bias, LN_EPS,
                                            False)[0]
        grads = pallas_norm._kernel_bwd(dy, x2, mean, inv, scale)
        again = pallas_norm._kernel_bwd(dy, x2, mean, inv, scale)
        torch.cuda.synchronize()
        ref = pallas_norm.channel_layernorm_plain_fwd(x2, scale, bias, LN_EPS)
        refs = pallas_norm.channel_layernorm_plain_bwd(dy, x2, mean, inv,
                                                       scale)
    names = ("dx", "dscale", "dbias")
    if not torch.equal(out, serve_out) or not all(
            torch.equal(a, b) for a, b in zip(grads, again)):
        raise RuntimeError(f"K7 N={n}: repeated calls differ")
    if not all(torch.isfinite(t.float()).all()
               for t in (out, mean, inv, *grads)):
        raise RuntimeError(f"K7 N={n}: non-finite output")
    errs = {"out": rel_err(out, ref[0])}
    errs.update({k: rel_err(a, r) for k, a, r in zip(names, grads, refs)})
    e_stats = max(rel_err(mean, ref[1]), rel_err(inv, ref[2]))
    absd = max(float((a.float() - r.float()).abs().max())
               for a, r in zip((out, *grads), (ref[0], *refs)))
    del ref, refs, again
    leaves = [t.clone().requires_grad_() for t in (x2, scale, bias)]
    o = pallas_norm.channel_layernorm(*leaves, LN_EPS)
    o.backward(dy)
    if not torch.equal(o.detach(), out) or not all(
            torch.equal(leaf.grad, want.to(leaf.grad.dtype))
            for leaf, want in zip(leaves, grads)):
        raise RuntimeError(f"K7 N={n}: the Function differs from the "
                           f"direct calls")
    del leaves, o
    with GuardBands(pallas_norm) as g, torch.no_grad():
        gx, gdy = g.band(x2), g.band(dy)
        gs, gb = g.band(scale), g.band(bias)
        g_out, g_mean, g_inv = pallas_norm._kernel_fwd(gx, gs, gb, LN_EPS,
                                                       True)
        g_grads = pallas_norm._kernel_bwd(gdy, gx, g_mean, g_inv, gs)
        g.check(f"K7 N={n}")
    if not all(torch.equal(a, b) for a, b in zip(
            (g_out, g_mean, g_inv, *g_grads), (out, mean, inv, *grads))):
        raise RuntimeError(f"K7 N={n}: inside guard bands an output differs "
                           f"(a read past a buffer)")
    log(f"[8d K7] N={n} C={c}: max|Δ|/max|ref| vs plain " + ", ".join(
        f"{k} {e:.2e}" for k, e in errs.items()) + f", mean/inv "
        f"{e_stats:.2e}; repeats bit-equal, the Function = the direct calls, "
        f"guard bands untouched")
    if max(errs.values()) > OUT_TOL or e_stats > RSTD_TOL:
        raise RuntimeError(f"K7 disagrees with plain at N={n}: {errs}, "
                           f"mean/inv {e_stats}")
    return {"abs": absd, "tensors": (scale, bias, dy, out, mean, inv, grads)}


def _time_k7(x2, tensors) -> dict:
    scale, bias, dy, out, mean, inv, grads = tensors
    c = x2.shape[1]
    with torch.no_grad():
        fwd = cuda_ms(lambda: pallas_norm._kernel_fwd(x2, scale, bias, LN_EPS,
                                                      True), iters=10)
        serve = cuda_ms(lambda: pallas_norm._kernel_fwd(x2, scale, bias,
                                                        LN_EPS, False),
                        iters=10)
        bwd = cuda_ms(lambda: pallas_norm._kernel_bwd(dy, x2, mean, inv,
                                                      scale), iters=10)
        plain_fwd = cuda_ms(lambda: pallas_norm.channel_layernorm_plain_fwd(
            x2, scale, bias, LN_EPS), iters=3, warmup=1)
        plain_bwd = cuda_ms(lambda: pallas_norm.channel_layernorm_plain_bwd(
            dy, x2, mean, inv, scale), iters=3, warmup=1)
    lib_in = [x2.clone().requires_grad_()] + [
        v.to(torch.bfloat16).requires_grad_() for v in (scale, bias)]
    f = torch.nn.functional
    with torch.no_grad():
        lib_fwd = cuda_ms(lambda: f.layer_norm(lib_in[0], (c,), lib_in[1],
                                               lib_in[2], LN_EPS), iters=10)
    with torch.enable_grad():
        o = f.layer_norm(lib_in[0], (c,), lib_in[1], lib_in[2], LN_EPS)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(
            o, lib_in, dy, retain_graph=True), iters=10)
    del o, lib_in
    moved = nbytes(x2, scale, bias, out, mean, inv)
    bounds = {"fwd": bound(0.0, moved),
              "bwd": bound(0.0, nbytes(dy, x2, mean, inv, scale, *grads))}
    log(f"[8d K7] N={x2.shape[0]} C={c}: forward {fwd * 1e3:.1f} us/call "
        f"({_gbps(moved, fwd):.0f} GB/s; serving entry {serve * 1e3:.1f}), "
        f"plain "
        f"{plain_fwd * 1e3:.1f}, F.layer_norm {lib_fwd * 1e3:.1f}, bound "
        f"{bounds['fwd']['bound_ms'] * 1e3:.1f} us (bytes); backward "
        f"{bwd * 1e3:.1f} us/call, plain {plain_bwd * 1e3:.1f}, autograd of "
        f"F.layer_norm {lib_bwd * 1e3:.1f}, bound "
        f"{bounds['bwd']['bound_ms'] * 1e3:.1f} us (bytes)")
    return {"fwd": {"ms": fwd, "plain_ms": plain_fwd, **bounds["fwd"],
                    "library_ms": lib_fwd},
            "bwd": {"ms": bwd, "plain_ms": plain_bwd, **bounds["bwd"],
                    "library_ms": lib_bwd}}


def _cuda_bin(tool: str) -> str:
    return os.path.join(os.path.dirname(os.path.dirname(cuda_build._nvcc())),
                        "bin", tool)


def kernel_resources(patterns=("k6_", "ln_row_", "ln_fold"),
                     tag: str = "8d") -> list:
    """Registers, stack and local (spill) bytes of the kernels whose names
    hold one of ``patterns`` (the frontend's by default), as ``cuobjdump
    -res-usage`` reads them from the built library; returns ``[(name,
    usage)]``."""
    res = subprocess.run([_cuda_bin("cuobjdump"),
                          "-res-usage", str(cuda_build.library_path())],
                         capture_output=True, text=True, check=True,
                         timeout=120)
    found, name = [], None
    for line in res.stdout.splitlines():
        line = line.strip()
        if line.startswith("Function "):
            name = line[len("Function "):].rstrip(":")
        elif name and line.startswith("REG:"):
            if any(p in name for p in patterns):
                found.append((name, " ".join(line.split()[:4])))
            name = None
    filt = _cuda_bin("cu++filt")
    if found and os.path.isfile(filt):
        names = subprocess.run([filt], input="\n".join(n for n, _ in found),
                               capture_output=True, text=True, check=True,
                               timeout=60).stdout.splitlines()
        # "void <unnamed>::f<(int)2, ...>(args)" -> "<unnamed>::f<2, ...>"
        found = [(short.replace("(int)", "").replace("void ", "")
                  .split("(")[0], usage)
                 for short, (_, usage) in zip(names, found)]
    for name, usage in found:
        log(f"[{tag}] {name}: {usage}")
    if not found:
        raise RuntimeError(f"cuobjdump listed no kernel matching {patterns}")
    return found


def phase_frontend_kernels() -> list:
    """Phase 8d: K6 and K7 against their plain versions at every frontend
    shape of the fine-tune (32 × 10 s) and of BYOL (36 × 5 s) and at ragged
    small shapes, K6's serving entry alone at a 64 s clip's layer 1; HGMMA
    in the SASS of K6's wgmma kernels, their registers and no spills; the
    fine-tune's and BYOL's layers timed beside plain, the library calls and
    the bounds, layer 1's kernels by device time; the layer-0 conv choice and K7 against a two-pass
    LayerNorm on layer 0's real output."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    kernel_resources()
    for pattern in K6_WGMMA:
        check_hgmma(pattern, tag="8d K6")
    check_no_spills(kernel_resources(K6_WGMMA, tag="8d K6"),
                    "K6's wgmma kernels")
    ft_rows, ft_layers = frontend_shapes(FT_BATCH, FT_CLIP_SECONDS)
    byol_rows, byol_layers = frontend_shapes(TRAIN_BATCH, CLIP_SECONDS)
    cases = ([(FT_BATCH, t, k) for t, k in ft_layers]
             + [(TRAIN_BATCH, t, k) for t, k in byol_layers]
             + [(2, t, k) for t in (3, 4, 5, 1030, 1031) for k in (2, 3)])
    worst6, k6_rows = 0.0, None
    totals = {b: {"fwd": 0.0, "bwd": 0.0, "flop": 0.0}
              for b in (FT_BATCH, TRAIN_BATCH)}
    for i, (b, t_in, k) in enumerate(cases):
        r = _check_k6(gen, b, t_in, k, dev)
        worst6 = max(worst6, r["abs"])
        if b in totals:  # the fine-tune's and BYOL's layers are timed
            first = (t_in, k) == (ft_layers if b == FT_BATCH
                                  else byol_layers)[0]
            times = _time_k6(r["tensors"], k, by_kernel=first)
            tot = totals[b]
            tot["fwd"] += times["fwd"]["ms"]
            tot["bwd"] += times["bwd"]["ms"]
            tot["flop"] += 2.0 * b * fused_frontend.out_length(t_in, k) \
                * k * FRONTEND_C ** 2
            if i == 0:  # layer 1 of the fine-tune: the JSON rows
                k6_rows = times
        del r
    for b, tot in totals.items():
        tb = bound(tot["flop"], 0.0)["bound_ms"]
        log(f"[8d K6] {'the fine-tune' if b == FT_BATCH else 'BYOL'}'s "
            f"layers 1-6 (B={b}): forward {tot['fwd'] * 1e3:.1f} us, "
            f"backward {tot['bwd'] * 1e3:.1f} us; bound {tb * 1e3:.1f} / "
            f"{2 * tb * 1e3:.1f} us (operations, {tot['flop'] / 1e12:.3f} "
            f"TFLOP forward)")
    # the serving entry alone at a 64 s clip's layer 1
    long_t = frontend_shapes(1, LONG_CLIP_SECONDS)[1][0]
    worst6 = max(worst6, _check_k6_serving(gen, 1, *long_t, dev))

    # layer 0 of the fine-tune on z-normed noise, seeded layer-0 weights
    sd = init_state_dict(WavLMConfig.large(num_hidden_layers=1),
                         torch.Generator().manual_seed(SEED + 15))
    pre = "feature_extractor.conv_layers.0."
    bf = torch.bfloat16
    w0 = sd[pre + "conv.weight"].to(dev, bf)
    b0 = sd[pre + "conv.bias"].to(dev, bf)
    audio = torch.randn(FT_BATCH, int(FT_CLIP_SECONDS * SAMPLE_RATE),
                        generator=gen, device=dev).to(bf)
    with torch.no_grad():
        z = wavlm_module.strided_conv(audio[..., None], w0, b0, 5)
        z_cudnn = layer0_conv_cudnn(audio, w0, b0)
        e_conv = rel_err(z, z_cudnn)
        unfold_ms = cuda_ms(lambda: wavlm_module.strided_conv(
            audio[..., None], w0, b0, 5), iters=10)
        cudnn_ms = cuda_ms(lambda: layer0_conv_cudnn(audio, w0, b0),
                           iters=10)
    log(f"[8d] layer 0 (B={FT_BATCH} x {FT_CLIP_SECONDS:g} s -> "
        f"{tuple(z.shape)}): unfold + F.linear {unfold_ms * 1e3:.1f} us/call, "
        f"cuDNN conv1d + transpose {cudnn_ms * 1e3:.1f} us/call; the two "
        f"agree to {e_conv:.2e} of max|ref|")
    if e_conv > OUT_TOL:
        raise RuntimeError(f"layer-0 conv: the two routes differ by {e_conv}")
    del z_cudnn, audio
    x2 = z.reshape(-1, FRONTEND_C)
    assert x2.shape[0] == ft_rows
    lnw = sd[pre + "layer_norm.weight"].to(dev)
    lnb = sd[pre + "layer_norm.bias"].to(dev)
    with torch.no_grad():
        fast = pallas_norm.channel_layernorm(x2, lnw, lnb, LN_EPS)
        # the fast variance in float32, before the output's bf16 rounding
        xf = x2.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        fast32 = (xf - mean) * torch.rsqrt(var + LN_EPS) * lnw + lnb
        two = torch.nn.functional.layer_norm(xf, (FRONTEND_C,), lnw, lnb,
                                             LN_EPS)
        ratio = float((mean[:, 0].abs()
                       / xf.std(-1).clamp_min(1e-30)).max())
        del xf, mean, var
    log(f"[8d K7] layer 0 of the fine-tune, K7 (fast variance) vs a "
        f"two-pass float32 LayerNorm: max|Δ| "
        f"{float((fast.float() - two).abs().max()):.3e} "
        f"({rel_err(fast, two):.2e} of max|ref|); the fast variance in "
        f"float32 vs two-pass {float((fast32 - two).abs().max()):.3e}; "
        f"largest |frame mean| / frame std {ratio:.3f}")
    del fast, fast32, two

    worst7, k7_rows = 0.0, None
    # layer 0's rows of the fine-tune and of BYOL, then ragged row counts
    k7_inputs = [x2, None, 1, 6, 8, 10, 2060, 2062]
    for n in k7_inputs:
        if n is None:  # BYOL's layer-0 rows
            n = byol_rows
        rows = n if isinstance(n, torch.Tensor) else torch.randn(
            n, FRONTEND_C, generator=gen, device=dev).to(bf)
        r = _check_k7(gen, rows, dev)
        worst7 = max(worst7, r["abs"])
        if k7_rows is None:
            k7_rows = _time_k7(rows, r["tensors"])
        del r, rows
    del x2, z

    def row(name, replaces, source, times, worst):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "max_abs_err": worst, **times}

    src6 = "nrse_tpu_torch/csrc/fused_frontend.cu"
    src7 = "nrse_tpu_torch/csrc/channel_layernorm.cu"
    return [row("fused_frontend_fwd", "nrse_tpu/ops/fused_frontend.py:65",
                src6, k6_rows["fwd"], worst6),
            row("fused_frontend_bwd", "nrse_tpu/ops/fused_frontend.py:138",
                src6, k6_rows["bwd"], worst6),
            row("channel_layernorm_fwd", "nrse_tpu/ops/pallas_norm.py:36",
                src7, k7_rows["fwd"], worst7),
            row("channel_layernorm_bwd", "nrse_tpu/ops/pallas_norm.py:51",
                src7, k7_rows["bwd"], worst7)]


SER_BATCH = 32
EMOTION_CODES = sorted(BASELINE_EMOTIONS_MAP, key=BASELINE_EMOTIONS_MAP.get)


def _write_ser_corpus(root: str, n_clips: int, long_clips: int,
                      lo: float, hi: float, long_lo: float, long_hi: float):
    """``n_clips`` WAVs of ``lo``–``hi`` s drawn as ``bench.py:699-714``
    draws its sereval list (numpy seed 0: length, emotion, samples; the
    samples scaled by 0.25 so that PCM16 does not clip them), then
    ``long_clips`` of ``long_lo``–``long_hi`` s, with their label list.
    Returns ``(list path, audio dir, waveforms)``."""
    rng = np.random.default_rng(0)
    audio = os.path.join(root, "Audios")
    os.makedirs(audio)
    lines, waves = [], []
    spans = [(lo, hi)] * n_clips + [(long_lo, long_hi)] * long_clips
    for i, (a, b) in enumerate(spans):
        n = int(rng.uniform(a, b) * SAMPLE_RATE)
        emotion = int(rng.integers(0, 8))
        x = (0.25 * rng.standard_normal(n)).astype(np.float32)
        name = f"synthetic_{i:05d}.wav"
        save_wav(os.path.join(audio, name), x, SAMPLE_RATE)
        waves.append(x)
        lines.append(f"Audios/{name}; {EMOTION_CODES[emotion]}; A:4.0; "
                     f"V:4.0; D:4.0;")
    path = os.path.join(root, "list.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path, root, waves


def _bucket_batches(cfg, loaded, batch: int):
    """``{bucket length: (frames, batches)}`` of the evaluator's buckets."""
    counts = {}
    for _, wav in loaded:
        blen = bucket_length(len(wav))
        counts[blen] = counts.get(blen, 0) + 1
    return {blen: (int(cfg.feature_lengths(blen)), -(-n // batch))
            for blen, n in sorted(counts.items())}


def _cosine(a, b) -> float:
    a, b = (torch.as_tensor(np.asarray(x, np.float64)).flatten()
            for x in (a, b))
    return float(torch.nn.functional.cosine_similarity(a, b, dim=0))


def phase_ser(cfg=None, device=torch.device("cuda"),
              model_name: str = "microsoft/wavlm-large", n_clips: int = 256,
              long_clips: int = 4, batch: int = SER_BATCH, lo: float = 2.0,
              hi: float = 11.5, long_lo: float = 25.0, long_hi: float = 30.0,
              head_dim: int = 1024) -> dict:
    """The baseline evaluator end to end through ``eval_cat_ser.main``;
    its arguments let it be rehearsed at a small width on the CPU, with
    the wrappers' plain paths standing in."""
    cfg = cfg or WavLMConfig.large()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_ser_", dir=cuda_build.BUILD_DIR)
    try:
        t0 = time.perf_counter()
        label_list, audio_dir, waves = _write_ser_corpus(
            root, n_clips, long_clips, lo, hi, long_lo, long_hi)
        model_path = os.path.join(root, "model")
        os.makedirs(model_path)
        WavNormStats.from_waveforms(waves).save(
            os.path.join(model_path, "train_norm_stat.pkl"))
        del waves
        model = BaselineSER(cfg, head_dim=head_dim, device="meta")
        model.load_state_dict(init_baseline_state_dict(
            cfg, torch.Generator().manual_seed(SEED + 10), head_dim=head_dim),
            strict=True, assign=True)
        save_model(model_path, "final_model", model)
        size = os.path.getsize(os.path.join(model_path, "final_model",
                                            "state.pt"))
        del model
        log(f"[ser] corpus of {n_clips} + {long_clips} WAVs, stats and a "
            f"{size / 2**20:.1f} MiB final_model written in "
            f"{time.perf_counter() - t0:.1f} s")

        sync(device)
        _reset_counts()
        t0 = time.perf_counter()
        metrics, scored = eval_cat_ser.main([
            "--model_path", model_path, "--audio_list", label_list,
            "--audio_dir", audio_dir, "--batch_size", str(batch),
            "--head_dim", str(head_dim), "--model_name", model_name,
            "--device", device.type])
        sync(device)
        wall = time.perf_counter() - t0
        counts = {"block_attention_fwd": block_attention.LAUNCHES,
                  "flash_attention_fwd": flash_attention.LAUNCHES,
                  "fused_ffn_fwd": fused_ffn.LAUNCHES, **_frontend_counts()}

        out = os.path.join(model_path, "results")
        files = [os.path.join(out, n) for n in ("metrics.txt",
                                                "inference_results.csv")]
        finite = all(np.isfinite(v) for v in metrics.values())
        log(f"[ser] eval_cat_ser.main in {wall:.1f} s (cold: loading, "
            f"decode, first calls): {json.dumps(metrics)}")
        if not all(os.path.isfile(f) for f in files) or not finite or \
                metrics["n_files"] != n_clips + long_clips:
            raise RuntimeError(f"SER evaluation: outputs {files}, metrics "
                               f"{metrics}")

        stats = WavNormStats.load(os.path.join(model_path,
                                               "train_norm_stat.pkl"))
        loaded = [(e, stats.apply(eval_cat_ser.load_audio_16k(e.path)))
                  for e, _ in scored]
        plan = _bucket_batches(cfg, loaded, batch)
        layers = cfg.num_hidden_layers
        want = {"block_attention_fwd": layers * sum(
                    n for f, n in plan.values() if f <= block_attention.MAX_T),
                "flash_attention_fwd": layers * sum(
                    n for f, n in plan.values() if f > block_attention.MAX_T),
                "fused_ffn_fwd": layers * sum(n for _, n in plan.values()),
                **frontend_want(cfg, sum(n for _, n in plan.values()), 0)}
        log(f"[ser] buckets (samples: frames, batches) {plan}; launches "
            f"{counts} (want {want})")
        if counts != want:
            raise RuntimeError(f"SER evaluation: launches {counts} != {want}")

        # each bucket's logits equal a direct forward of its first batch
        model = eval_cat_ser.load_model(model_path, model_name, head_dim,
                                        device)
        forward = make_baseline_forward(model)
        by_entry = {id(e): logit for e, logit in scored}
        picked = {}
        for blen in plan:
            chunk = [(e, w) for e, w in loaded
                     if bucket_length(len(w)) == blen][:batch]
            x = np.zeros((batch, blen), np.float32)
            m = np.zeros((batch, blen), np.float32)
            for j, (_, w) in enumerate(chunk):
                x[j, :len(w)], m[j, :len(w)] = w, 1.0  # len(w) ≤ 30 s
            direct = forward(torch.from_numpy(x).to(device),
                             torch.from_numpy(m).to(device)).float().cpu()
            got = np.stack([by_entry[id(e)] for e, _ in chunk])
            err = float(np.abs(got - direct[:len(chunk)].numpy()).max())
            log(f"[ser] bucket {blen / SAMPLE_RATE:g} s: main's logits vs a "
                f"direct forward max|Δ| {err:.3e}")
            if err > 1e-5 * max(1.0, float(np.abs(got).max())):
                raise RuntimeError(f"SER evaluation: bucket {blen} logits "
                                   f"differ from a direct forward by {err}")
            picked[blen] = chunk[0]

        # the warm timed modes of the evaluator's hot path
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for mode in ({}, {"prestage": True}, {"overlap": True}):
            _, dt, audio_s = eval_cat_ser.bucketed_forward_timed(
                forward, loaded, batch, device, warmup_shapes=True, **mode)
            name = next(iter(mode), "default")
            log(f"[ser] {name}: {dt / audio_s:.6f} s per audio-second, "
                f"{audio_s / dt:.1f} audio-sec/sec ({audio_s:.1f} s of "
                f"audio, {dt:.3f} s)")
        if device.type == "cuda":
            log(f"[ser] peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            blen = 3 * 5 * SAMPLE_RATE
            chunk = [(e, w) for e, w in loaded
                     if bucket_length(len(w)) == blen][:batch]
            x = torch.zeros(batch, blen)
            m = torch.zeros(batch, blen)
            for j, (_, w) in enumerate(chunk):
                x[j, :len(w)], m[j, :len(w)] = torch.from_numpy(w), 1.0
            x, m = x.to(device), m.to(device)
            profile_device(lambda: forward(x, m).cpu(),
                           f"[ser] 15 s bucket, batch {batch}",
                           weight_shapes=_param_shapes(model))
        del model, forward

        # a 10 s and a 15 s clip against float32 on the CPU
        torch.set_num_threads(os.cpu_count() or 1)
        cpu_forward = make_baseline_forward(
            eval_cat_ser.load_model(model_path, model_name, head_dim, "cpu"))
        for blen in (2 * 5 * SAMPLE_RATE, 3 * 5 * SAMPLE_RATE):
            if blen not in picked:
                raise RuntimeError(f"SER evaluation: no clip in the "
                                   f"{blen // SAMPLE_RATE} s bucket")
            e, w = picked[blen]
            x = np.zeros((1, blen), np.float32)
            m = np.zeros((1, blen), np.float32)
            x[0, :len(w)], m[0, :len(w)] = w, 1.0
            ref = cpu_forward(torch.from_numpy(x), torch.from_numpy(m))
            cos = _cosine(by_entry[id(e)], ref.numpy())
            log(f"[ser] {len(w) / SAMPLE_RATE:.2f} s clip ({blen // 16000} s "
                f"bucket, {plan[blen][0]} frames): logits cosine vs float32 "
                f"CPU {cos:.6f}")
            if cos < COSINE_MIN:
                raise RuntimeError(f"SER logits cosine {cos} < {COSINE_MIN}")
        return counts
    finally:
        shutil.rmtree(root, ignore_errors=True)


COPIES = "dtype/layout copies"
# kernel name patterns → the groups PERF.md §5 reports, first match wins
# (the fold of reduction partials, ln_fold_kernel, is shared by K6's and
# K7's backward and counts as K7's)
PROFILE_GROUPS = (
    ("K6 (fused conv frontend)", "k6_|K6RowSource"),
    ("K7 (channel LayerNorm)", "ln_row_|ln_fold"),
    # flash_attention_fwd_wgmma_kernel
    ("K5 (flash attention)", "flash_attention_fwd"),
    # flash_attention_bwd_{delta,dq_wgmma,dkv_wgmma}_kernel and the fold
    ("K5 backward (delta, dq, dk/dv, dbias fold)",
     "flash_attention_bwd|flash_dbias_fold"),
    ("kernel A (block attention)", "block_attention_fwd"),
    ("K3 (block attention backward)",
     "attention_bwd_dkdv|attention_bwd_dq|dbias_sum|dout_prep"),
    ("kernel B and K2 (fused FFN GEMMs)",
     "nrse::gemm|nrse::wg|dh2_kernel|colsum|transpose_cast"),
    ("K1 (dropout)", "dropout_kernel"),
    ("K4 (AdamW)", "adamw_ema"),
    ("cuDNN convs", "conv|cudnn|implicit|winograd|fft"),
    ("cuBLAS (projections, heads)", "gemm|cutlass|xmma|nvjet|cublas"),
    ("LayerNorm", "layer_norm|LayerNorm"),
    (COPIES, "copy|Copy|cast"),
    ("reductions", "reduce|Reduce|softmax|Softmax"),
    ("elementwise", "elementwise|Elementwise|vectorized"),
)


# the sources the copies group is split into (PERF.md §5)
SRC_LN = "float32 LayerNorm inputs"
SRC_WEIGHT = "per-use weight casts"
SRC_FRONTEND = "frontend transposes and casts"
SRC_REST = "the rest"


class _CopySources:
    """Within the block, ``_LayerNorm.forward`` and
    ``ConvFeatureEncoder.forward`` run inside ``record_function`` ranges
    named by their copy source, so that a trace can attribute the copy
    kernels launched in them (and, through the autograd sequence numbers,
    in their backward)."""

    def __enter__(self):
        from torch.profiler import record_function

        def labelled(fn, name):
            def run(*args, **kwargs):
                with record_function(name):
                    return fn(*args, **kwargs)
            return run

        self.saved = [(wavlm_module._LayerNorm, "forward", SRC_LN),
                      (wavlm_module.ConvFeatureEncoder, "forward",
                       SRC_FRONTEND)]
        self.saved = [(cls, attr, getattr(cls, attr), name)
                      for cls, attr, name in self.saved]
        for cls, attr, fn, name in self.saved:
            setattr(cls, attr, labelled(fn, name))
        return self

    def __exit__(self, *exc):
        for cls, attr, fn, _ in self.saved:
            setattr(cls, attr, fn)


def copy_sources(events, copy_kernels, weight_shapes) -> dict:
    """``{correlation id: source}`` of the copy kernels.  Each kernel's
    launch is placed in the stack of host ops and ranges open on its thread
    at that moment.  A copy whose innermost op with shapes copies a tensor
    of a parameter's shape is a per-use weight cast (forward, or its
    backward's cast of the gradient); else the innermost labelled range
    names it; else, in the backward, the range its forward op ran in (the
    op's autograd sequence number); else it is the rest."""
    names = (SRC_LN, SRC_FRONTEND)
    wanted = {k["args"].get("correlation") for k in copy_kernels}
    host = sorted((e for e in events if e.get("ph") == "X" and e.get("cat")
                   in ("cpu_op", "user_annotation", "cuda_runtime")),
                  key=lambda e: (e["ts"], -e.get("dur", 0)))
    stacks, seq_label, out = {}, {}, {}
    for e in host:
        stack = stacks.setdefault((e["pid"], e["tid"]), [])
        while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) <= e["ts"]:
            stack.pop()
        args = e.get("args", {})
        if e["cat"] == "cuda_runtime":
            corr = args.get("correlation")
            if corr not in wanted:
                continue
            src = None
            for op in reversed(stack):
                dims = op.get("args", {}).get("Input Dims")
                if dims and dims[0]:
                    if all(isinstance(v, int) for v in dims[0]) and \
                            tuple(dims[0]) in weight_shapes:
                        src = SRC_WEIGHT
                    break
            if src is None:
                src = next((op["name"] for op in reversed(stack)
                            if op["name"] in names), None)
            if src is None:
                src = next((seq_label[op["args"]["Sequence number"]]
                            for op in reversed(stack)
                            if op.get("args", {}).get("Sequence number")
                            in seq_label), SRC_REST)
            out[corr] = src
            continue
        label = next((op["name"] for op in reversed(stack)
                      if op["name"] in names), None)
        if label is not None and "Sequence number" in args:
            seq_label.setdefault(args["Sequence number"], label)
        stack.append(e)
    return out


def _param_shapes(model) -> frozenset:
    return frozenset(tuple(p.shape) for p in model.parameters()
                     if p.numel() > 1)


def group_of(name: str) -> str:
    """The :data:`PROFILE_GROUPS` group of a kernel name (first match)."""
    import re

    return next((g for g, pat in PROFILE_GROUPS if re.search(pat, name)),
                "other")


def check_group(times: dict, group: str) -> None:
    """Fail unless every kernel of a traced call (``device_us``'s names)
    falls in ``group`` of the profiles' breakdown."""
    stray = {n: group_of(n) for n in times if group_of(n) != group}
    if not times or stray:
        raise RuntimeError(f"kernels outside the profile group {group!r}: "
                           f"{stray or 'none traced'}")


def profile_device(run, label: str, iters: int = 3,
                   weight_shapes=frozenset()) -> None:
    """Device time of ``run()`` (which ends waiting for the card) by kernel
    group, from the CUDA kernels of a checked ``torch.profiler`` trace over
    ``iters`` calls after one warm-up (:func:`traced_kernels`); and the
    card's busy share of the host clock over them.  The copies group is
    also split by source (``copy_sources``; ``weight_shapes`` are the
    model's parameter shapes)."""
    run()
    events, kernels, wall = traced_kernels(run, iters, _CopySources)
    groups, copies = {}, []
    for e in kernels:
        name = group_of(e["name"])
        groups[name] = groups.get(name, 0.0) + e["dur"] / 1e3 / iters
        if name == COPIES:
            copies.append(e)
    busy = sum(groups.values())
    log(f"{label}: {len(kernels) // iters} kernels and {busy:.1f} ms of "
        f"device time a call, {wall / iters * 1e3:.1f} ms of host clock "
        f"(busy {busy / (wall / iters * 1e3):.3f}); by group: " + ", ".join(
            f"{g} {t:.1f} ms ({t / busy:.1%})" for g, t in
            sorted(groups.items(), key=lambda kv: -kv[1])))
    sources = copy_sources(events, copies, weight_shapes)
    split = {}
    for e in copies:
        src = sources.get(e["args"].get("correlation"), SRC_REST)
        split[src] = split.get(src, 0.0) + e["dur"] / 1e3 / iters
    log(f"{label}: {COPIES} by source: " + ", ".join(
        f"{s} {t:.1f} ms ({t / busy:.1%} of device time)"
        for s, t in sorted(split.items(), key=lambda kv: -kv[1])))


class _PlainVersions:
    """Within the block, the WavLM module calls the plain versions of its
    kernels' wrappers: the float32 reference on the card."""

    def __enter__(self):
        def flash(q, k, v, gate, bias_rel, mask=None):
            b, _, t, _ = q.shape
            return flash_attention_plain_fwd(
                q, k, v, gate, bias_rel, mask_add(mask, b, t, q.device))[0]

        def block(q, k, v, gate, pos_bias, mask=None, **_):
            return gated_bias_attention(q, k, v, gate, pos_bias, mask)

        def ffn(x, w1, b1, w2, b2, *_):
            rows = x.reshape(-1, x.shape[-1])
            return ffn_plain(rows, w1, b1, w2, b2).reshape(x.shape)

        def conv_ln_gelu(x, kernel, bias, scale, ln_bias, eps):
            return conv_ln_gelu_plain_fwd(x, kernel, bias, scale, ln_bias,
                                          eps)[0]

        def norm(x, scale, bias, eps):
            rows = x.reshape(-1, x.shape[-1])
            return channel_layernorm_plain_fwd(rows, scale, bias,
                                               eps)[0].reshape(x.shape)

        patches = {"flash_gated_attention": flash,
                   "block_gated_attention": block, "fused_ffn": ffn,
                   "fused_conv_ln_gelu": conv_ln_gelu,
                   "channel_layernorm": norm}
        self.saved = {n: getattr(wavlm_module, n) for n in patches}
        for n, fn in patches.items():
            setattr(wavlm_module, n, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(wavlm_module, name, fn)


def phase_long_clip(cfg=None, device=torch.device("cuda"),
                    clip_seconds: float = LONG_CLIP_SECONDS) -> dict:
    """Serving one clip of ``clip_seconds`` (T > 3072 frames: the TPU's
    streamed regime) through K5, against float32 plain versions on the
    same device."""
    cfg = cfg or WavLMConfig.large()
    sd = init_state_dict(cfg, torch.Generator().manual_seed(SEED + 9))
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    art = tempfile.mkdtemp(prefix="smoke_long_", dir=cuda_build.BUILD_DIR)
    try:
        export_embedder(sd, cfg, art, batch_sizes=(1,),
                        clip_seconds=clip_seconds, sample_rate=SAMPLE_RATE)
        server = ServingModel(art, device)
    finally:
        shutil.rmtree(art)
    clip = server.clip_samples
    frames = int(cfg.feature_lengths(clip))
    audio = (0.1 * np.random.default_rng(SEED + 9).standard_normal(
        (1, clip))).astype(np.float32)
    server(audio)  # warm-up
    sync(device)
    _reset_counts()
    seq, pooled = server(audio)
    sync(device)
    counts = {"flash_attention_fwd": flash_attention.LAUNCHES,
              "block_attention_fwd": block_attention.LAUNCHES,
              "fused_ffn_fwd": fused_ffn.LAUNCHES, **_frontend_counts()}
    layers = cfg.num_hidden_layers
    want = {"flash_attention_fwd": layers, "block_attention_fwd": 0,
            "fused_ffn_fwd": layers, **frontend_want(cfg, 1, 0)}
    log(f"[long] {clip_seconds:g} s clip, {frames} frames: sequence "
        f"{seq.shape}, launches {counts} (want {want})")
    if counts != want or not (np.isfinite(seq).all()
                              and np.isfinite(pooled).all()):
        raise RuntimeError(f"long clip: launches {counts}, finite "
                           f"{np.isfinite(seq).all()}")

    ref_model = WavLMModel(cfg, device="meta")
    ref_model.load_state_dict(sd, strict=True, assign=True)
    ref_model = ref_model.to(device).eval()
    del sd
    with _PlainVersions(), torch.inference_mode():
        _, ref_pooled = ref_model(torch.from_numpy(audio).to(device),
                                  torch.ones(1, clip, dtype=torch.int32,
                                             device=device))
    sync(device)
    if {"flash_attention_fwd": flash_attention.LAUNCHES,
            "block_attention_fwd": block_attention.LAUNCHES,
            "fused_ffn_fwd": fused_ffn.LAUNCHES,
            **_frontend_counts()} != counts:
        raise RuntimeError("long clip: the float32 reference launched a "
                           "kernel")
    cos = _cosine(pooled, ref_pooled.float().cpu().numpy())
    del ref_model
    log(f"[long] pooled cosine vs float32 plain versions on the same "
        f"device {cos:.6f}")
    if cos < COSINE_MIN:
        raise RuntimeError(f"long clip pooled cosine {cos} < {COSINE_MIN}")
    for _ in range(2):
        server(audio)
    iters = 5
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        server(audio)
    sync(device)
    dt = (time.perf_counter() - t0) / iters
    log(f"[long] bucket 1: {dt * 1e3:.2f} ms/request, "
        f"{clip_seconds / dt:.1f} audio-sec/sec")
    return counts


FT_BATCH = 32          # the fine-tune's batch (train_ft_cat_ser's default)
FT_CLIP_SECONDS = 10.0  # its --max_seconds: 499 frames, K5 and its backward
FT_LR = 5e-6
FT_ACCUMULATION = 4
FT_WEIGHTS = tuple(np.linspace(0.5, 1.5, 8))  # class weights of the CE


def _ft_batches(n: int, batch: int, clip_seconds: float, device,
                seed: int):
    """``n`` fine-tune batches of z-normed noise at ``clip_seconds``, every
    fourth clip cut to 50–100% and masked past its end, random labels."""
    rng = np.random.default_rng(seed)
    t = int(clip_seconds * SAMPLE_RATE)
    out = []
    for _ in range(n):
        x = rng.standard_normal((batch, t)).astype(np.float32)
        mask = np.ones((batch, t), np.float32)
        for i in range(0, batch, 4):
            cut = int(rng.uniform(0.5, 1.0) * t)
            x[i, cut:], mask[i, cut:] = 0.0, 0.0
        labels = rng.integers(0, 8, batch).astype(np.int32)
        out.append({k: torch.from_numpy(v).to(device) for k, v in (
            ("input_values", x), ("attention_mask", mask),
            ("label", labels))})
    return out


def _ft_state(cfg, device, seed: int, head_dim: int = 1024,
              dropout: float = 0.5):
    """A fine-tune state of seeded ``BaselineSER`` weights on ``device``
    (bf16 compute on the card, float32 on the CPU)."""
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = BaselineSER(cfg, head_dim=head_dim, dropout=dropout,
                        device="meta", compute_dtype=dtype)
    model.load_state_dict(init_baseline_state_dict(
        cfg, torch.Generator().manual_seed(seed), head_dim=head_dim),
        strict=True, assign=True)
    return train_ft_cat_ser.create_train_state(model.to(device))


def _ft_counts() -> dict:
    return {"flash_attention_fwd": flash_attention.LAUNCHES,
            "flash_attention_bwd_dq": flash_attention.DQ_LAUNCHES,
            "flash_attention_bwd_dkv": flash_attention.DKV_LAUNCHES,
            **_train_counts()}


def phase_ft_step(cfg=None, device=torch.device("cuda"),
                  batch: int = FT_BATCH,
                  clip_seconds: float = FT_CLIP_SECONDS,
                  accumulation: int = FT_ACCUMULATION,
                  head_dim: int = 1024) -> dict:
    """The SER fine-tune's micro-step at full width with the JAX defaults
    (lr 5e-6, k = 4, the encoder's dropout, LayerDrop and SpecAugment, the
    head's dropout 0.5), end to end and frozen: a warm-up cycle of ``k``
    micro-steps and one K4 update, then a timed one whose launches must
    equal what the layers run imply.  Frozen, the encoder's weights must
    move by the decay alone.  Returns the end-to-end cycle's launches.
    Its arguments let it be rehearsed at a small width on the CPU."""
    cfg = cfg or WavLMConfig.large()
    weights = torch.tensor(FT_WEIGHTS, dtype=torch.float32, device=device)
    data = _ft_batches(accumulation, batch, clip_seconds, device, SEED + 12)
    frames = int(cfg.feature_lengths(data[0]["input_values"].shape[1]))
    spec = train_ft_cat_ser.adamw_spec(FT_LR)
    e2e_counts = None
    for freeze in (False, True):
        mode = "frozen" if freeze else "e2e"
        state = _ft_state(cfg, device, SEED + 12, head_dim)
        step = train_ft_cat_ser.make_train_step(spec, accumulation, freeze,
                                                weights)
        micro = [0]

        def cycle():
            losses, layers = [], 0
            for b in data:
                losses.append(step(state, b, TrainRNG(SEED, micro[0])))
                micro[0] += 1
                layers += state.model.ssl.encoder.layers_run
            return losses, layers

        losses, _ = cycle()  # warm-up, one K4 update
        if not all(bool(torch.isfinite(x)) for x in losses):
            raise RuntimeError(f"fine-tune {mode}: non-finite warm-up loss")
        ssl_before = state.params[:state.n_ssl].clone() if freeze else None
        sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        losses, layers = cycle()
        sync(device)
        dt = (time.perf_counter() - t0) / accumulation
        counts = _ft_counts()
        losses = [float(x) for x in losses]
        backward = 0 if freeze else layers
        want = {"flash_attention_fwd": layers,
                "flash_attention_bwd_dq": backward,
                "flash_attention_bwd_dkv": backward,
                "block_attention_fwd": 0, "block_attention_bwd": 0,
                "fused_ffn_fwd": layers, "fused_ffn_bwd_dx": backward,
                "fused_ffn_bwd_dw": backward,
                # the encoder site and each layer's attention-output and
                # hidden sites, again in the backward end to end
                "fused_dropout": (1 if freeze else 2) * (accumulation
                                                         + 2 * layers),
                "fused_adamw_ema": 1,
                **frontend_want(cfg, accumulation,
                                0 if freeze else accumulation)}
        log(f"[ft] {mode}: {cfg.num_hidden_layers} layers x "
            f"{cfg.hidden_size}, batch {batch} x {clip_seconds:g} s "
            f"({frames} frames), k = {accumulation}: {dt:.4f} s per "
            f"micro-step, {batch * clip_seconds / dt:.1f} audio-sec/sec; "
            f"losses {[round(x, 6) for x in losses]}; layers run {layers}; "
            f"launches {counts} (want {want})")
        if not all(np.isfinite(losses)) or counts != want:
            raise RuntimeError(f"fine-tune {mode}: losses {losses}, "
                               f"launches {counts} != {want}")
        if device.type == "cuda":
            log(f"[ft] {mode}: peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if freeze:  # AdamW's decoupled decay alone: p · (1 − lr · wd)
            with torch.no_grad():
                want_p = ssl_before * (1.0 - FT_LR * spec.weight_decay)
                err = float((state.params[:state.n_ssl] - want_p).abs().max()
                            / want_p.abs().max())
            log(f"[ft] frozen: ssl after the update vs p·(1 − lr·wd): "
                f"max|Δ|/max|p| {err:.3e}")
            if err > OPT_TOL:
                raise RuntimeError(f"frozen ssl weights moved by more than "
                                   f"the decay: {err}")
            del ssl_before, want_p
        else:
            e2e_counts = counts
            if device.type == "cuda":
                profile_device(lambda: (step(state, data[0],
                                             TrainRNG(SEED, micro[0])),
                                        sync(device)),
                               f"[ft] e2e micro-step, batch {batch}",
                               iters=2,
                               weight_shapes=_param_shapes(state.model))
        del state, step
    return e2e_counts


FT_CROSSCHECK_SEEDS = (13, 21, 22, 23, 24)


def _ft_crosscheck_step(cfg, device, seed: int, batch: int):
    """One end-to-end micro-step of seeded weights and batch on ``device``
    (bf16 on the card, float32 on the CPU): ``(state, batch on the device,
    loss, flat gradient in float64 on the CPU, the loss's gradient at the
    encoder's output)``."""
    data = _ft_batches(1, batch, FT_CLIP_SECONDS, torch.device("cpu"),
                       SEED + seed)[0]
    data = {k: v.to(device) for k, v in data.items()}
    state = _ft_state(cfg, device, SEED + seed, dropout=0.0)
    step = train_ft_cat_ser.make_train_step(
        train_ft_cat_ser.adamw_spec(FT_LR), 1, False,
        torch.tensor(FT_WEIGHTS, dtype=torch.float32, device=device))
    seqs = []

    def keep(module, inputs, out):
        out[0].retain_grad()
        seqs.append(out[0])

    hook = state.model.ssl.register_forward_hook(keep)
    loss = step(state, data, TrainRNG(SEED, 0))
    hook.remove()
    return state, data, float(loss), state.grads.double().cpu(), seqs[0].grad


def phase_ft_crosscheck(layers: int = 1, batch: int = 2,
                        seeds=FT_CROSSCHECK_SEEDS, cfg=None,
                        device=torch.device("cuda")) -> None:
    """One end-to-end micro-step at full width and ``layers`` deep, random
    features and the head's dropout off, from the same weights and batch
    at each of ``seeds``, in bf16 on the card and in float32 on the CPU.
    Every kernel of the step lies in the encoder, so the bound holds the
    encoder: run forward again on the card and given the float32 loss
    gradient at its output, its parameter gradient must have a cosine of
    at least ``COSINE_MIN`` with float32's.  The whole step's gradient
    cosine is printed, not bound: at random weights attentive statistics
    pooling and the head's ReLUs turn the bf16 encoder's ~1% output error
    into 20-70% of the gradient at the encoder's output, and it scatters
    over seeds with or without K6 and K7 (PERF.md §7).  One layer runs
    every kernel of the step; the encoder's bf16 noise grows with depth
    (1 - cosine 0.0024-0.0032 at one layer, 0.0051-0.0090 at four, as
    before K6 and K7).  Its arguments let it be rehearsed at a small width
    on the CPU."""
    cfg = cfg or WavLMConfig.large(num_hidden_layers=layers,
                                   hidden_dropout=0.0, activation_dropout=0.0,
                                   attention_dropout=0.0, layerdrop=0.0,
                                   mask_time_prob=0.0)
    torch.set_num_threads(os.cpu_count() or 1)
    cos = torch.nn.functional.cosine_similarity
    for seed in seeds:
        _, _, l_f32, g_f32, up = _ft_crosscheck_step(
            cfg, torch.device("cpu"), seed, batch)
        state, data, l_card, g_card, _ = _ft_crosscheck_step(cfg, device,
                                                             seed, batch)
        n_ssl = state.n_ssl
        c_step = float(cos(g_card, g_f32, dim=0))
        state.grads.zero_()
        seq, _ = state.model.ssl(data["input_values"], data["attention_mask"],
                                 TrainRNG(SEED, 0))
        seq.backward(up.to(device, seq.dtype))
        c_enc = float(cos(state.grads[:n_ssl].double().cpu(), g_f32[:n_ssl],
                          dim=0))
        log(f"[ft crosscheck] {cfg.num_hidden_layers} layers, batch {batch} x "
            f"{FT_CLIP_SECONDS:g} s, seed {seed}: loss bf16 card "
            f"{l_card:.6f} vs f32 CPU {l_f32:.6f}; the encoder's gradient "
            f"from the float32 loss gradient, cosine {c_enc:.6f} (bound "
            f"{COSINE_MIN}); the whole step's gradient cosine {c_step:.6f} "
            f"(encoder part "
            f"{float(cos(g_card[:n_ssl], g_f32[:n_ssl], dim=0)):.6f}; not "
            f"bound)")
        del state, data, seq, g_card, g_f32, up
        if c_enc < COSINE_MIN:
            raise RuntimeError(f"fine-tune encoder gradient cosine at seed "
                               f"{seed}: {c_enc} < {COSINE_MIN}")


def _write_ft_corpus(root: str, n_train: int, n_dev: int, lo: float,
                     hi: float):
    """``n_train + n_dev`` WAVs of ``lo``–``hi`` s (noise, random emotions)
    with the one-hot CSV, the config JSON the trainer reads and the dev
    label list the evaluator reads.  Returns ``(config, list)`` paths."""
    import csv

    rng = np.random.default_rng(SEED + 14)
    audio = os.path.join(root, "Audios")
    os.makedirs(audio)
    rows, lines = [], []
    for i in range(n_train + n_dev):
        n = int(rng.uniform(lo, hi) * SAMPLE_RATE)
        code = EMOTION_CODES[int(rng.integers(0, 8))]
        name = f"ft_{i:04d}.wav"
        save_wav(os.path.join(audio, name),
                 (0.25 * rng.standard_normal(n)).astype(np.float32),
                 SAMPLE_RATE)
        split = "Train" if i < n_train else "Development"
        rows.append([name] + [1.0 if c == code else 0.0
                              for c in train_ft_cat_ser.ONE_HOT_COLUMNS]
                    + [split])
        if i >= n_train:
            lines.append(f"Audios/{name}; {code}; A:4.0; V:4.0; D:4.0;")
    labels = os.path.join(root, "labels_onehot.csv")
    with open(labels, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["FileName", *train_ft_cat_ser.ONE_HOT_COLUMNS,
                         "Split_Set"])
        writer.writerows(rows)
    config = os.path.join(root, "config.json")
    with open(config, "w") as f:
        json.dump({"wav_dir": audio, "label_path": labels}, f)
    label_list = os.path.join(root, "dev_list.txt")
    with open(label_list, "w") as f:
        f.write("\n".join(lines) + "\n")
    return config, label_list


def phase_ft_entry(device=torch.device("cuda"),
                   model_name: str = "microsoft/wavlm-large",
                   layers: int = ENTRY_LAYERS, n_train: int = 24,
                   n_dev: int = 8, batch: int = 8, accumulation: int = 2,
                   lo: float = 3.0, hi: float = 12.0,
                   max_seconds: float = FT_CLIP_SECONDS,
                   head_dim: int = 1024) -> None:
    """``train_ft_cat_ser.main`` on a synthetic corpus under ``build/``,
    one epoch frozen, then one end to end into the same model directory,
    then ``eval_cat_ser.main`` on the ``final_model`` it wrote.  Its
    arguments let it be rehearsed at a small width on the CPU."""
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_ft_", dir=cuda_build.BUILD_DIR)
    try:
        config, label_list = _write_ft_corpus(root, n_train, n_dev, lo, hi)
        model_path = os.path.join(root, "model")
        args = ["--config", config, "--model_path", model_path,
                "--epochs", "1", "--batch_size", str(batch),
                "--accumulation_steps", str(accumulation),
                "--head_dim", str(head_dim), "--model_name", model_name,
                "--num_hidden_layers", str(layers),
                "--max_seconds", str(max_seconds),
                "--device", device.type]
        for freeze in ("true", "false"):
            sync(device)
            _reset_counts()
            result = train_ft_cat_ser.main(args + ["--freeze_ssl", freeze])
            sync(device)
            counts = _ft_counts()
            (epoch,) = result["epochs"]
            width = result["state"].model.encoder_config.hidden_size
            log(f"[ft entry] --freeze_ssl {freeze}: WavLM {layers} layers "
                f"(depth cut) x {width}, batch {batch}, k = {accumulation}: "
                f"train loss {epoch['train_loss']:.6f}, dev loss "
                f"{epoch['dev_loss']:.6f}; "
                f"{epoch['steps']} data-fed micro-steps at "
                f"{epoch['s_per_step']:.4f} s each "
                f"({epoch['audio_sec_per_sec']:.1f} audio-sec/sec); "
                f"launches {counts}")
            backward = counts["flash_attention_bwd_dq"]
            frontend = counts["fused_frontend_bwd"]
            # K6 and K7 per encoder backward
            per = frontend_want(result["state"].model.encoder_config, 1, 1)
            ok = (np.isfinite(epoch["train_loss"])
                  and np.isfinite(epoch["dev_loss"])
                  and counts["flash_attention_fwd"] > 0
                  and counts["fused_frontend_fwd"] > 0
                  and counts["channel_layernorm_fwd"] > 0
                  and counts["fused_adamw_ema"] == epoch["steps"]
                  // accumulation
                  and backward == counts["flash_attention_bwd_dkv"]
                  and (backward == 0) == (freeze == "true")
                  and (frontend == 0) == (freeze == "true")
                  and counts["channel_layernorm_bwd"]
                  * per["fused_frontend_bwd"]
                  == frontend * per["channel_layernorm_bwd"])
            if not ok:
                raise RuntimeError(f"fine-tune entry point: {epoch}, "
                                   f"launches {counts}")
            del result
        for path in ("train_norm_stat.pkl", "final_model/state.pt"):
            if not os.path.isfile(os.path.join(model_path, path)):
                raise RuntimeError(f"fine-tune entry point: no {path}")
        metrics, scored = eval_cat_ser.main([
            "--model_path", model_path, "--audio_list", label_list,
            "--audio_dir", root, "--batch_size", str(batch),
            "--head_dim", str(head_dim), "--model_name", model_name,
            "--num_hidden_layers", str(layers), "--device", device.type])
        log(f"[ft entry] eval_cat_ser.main on its final_model: "
            f"{metrics['n_scored']} of {n_dev} dev files scored, f1_macro "
            f"{metrics['f1_macro']:.4f}, inference loss "
            f"{metrics['inference_loss']:.6f}")
        if not (metrics["n_files"] == metrics["n_scored"] == n_dev
                and all(np.isfinite(logit).all() for _, logit in scored)):
            raise RuntimeError(f"fine-tune entry point: evaluation {metrics}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


EMO_BATCH = 36          # the dim_ft preset's emotion.batch_size
EMO_HIDDEN = 1024       # its emotion.hidden_dim
EMO_DROPOUT = 0.3       # its emotion.dropout_rate
EMO_LR = 1e-4           # its emotion.learning_rate (phase 1)
EMO_FT_LR = 5e-6        # its emotion.fine_tuning_lr (phase 2)
EMO_WD = 1e-4           # its emotion.weight_decay


def _emotion_batch(n: int, clip_seconds: float, device, seed: int):
    """A batch of ``n`` synthetic clips as the emotion loader gives them:
    tones in noise, every third clip cut to 40–90% and masked past its
    end, classes 0–9 (8 and 9, X and O, are masked out of the CE) and
    A/V/D ratings in [1, 7]."""
    rng = np.random.default_rng(seed)
    t = int(SAMPLE_RATE * clip_seconds)
    ax = np.arange(t) / SAMPLE_RATE
    x = (0.3 * np.sin(2 * np.pi * rng.uniform(80, 300, (n, 1)) * ax)
         + 0.02 * rng.standard_normal((n, t))).astype(np.float32)
    mask = np.ones((n, t), np.float32)
    for i in range(0, n, 3):
        cut = int(rng.uniform(0.4, 0.9) * t)
        x[i, cut:], mask[i, cut:] = 0.0, 0.0
    out = {"input_values": x, "attention_mask": mask,
           "C": rng.integers(0, 10, n).astype(np.int32)}
    for k in ("A", "V", "D"):
        out[k] = rng.uniform(1, 7, n).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def _emotion_model(cfg, device, hidden_dim: int, dropout: float):
    """A seeded ``EmotionClassifier`` on ``device`` (bf16 compute on the
    card, float32 on the CPU)."""
    model = EmotionClassifier(
        cfg, hidden_dim, dropout=dropout, device="meta",
        compute_dtype=torch.bfloat16 if device.type == "cuda"
        else torch.float32)
    model.load_state_dict(init_emotion_state_dict(
        cfg, torch.Generator().manual_seed(SEED + 15), hidden_dim),
        strict=True, assign=True)
    return model.to(device)


def _cosine_flat(a, b) -> float:
    return float(torch.nn.functional.cosine_similarity(
        a.double().flatten(), b.double().flatten(), dim=0))


def phase_emotion_step(cfg=None, device=torch.device("cuda"),
                       batch: int = EMO_BATCH,
                       clip_seconds: float = CLIP_SECONDS, warmup: int = 2,
                       steps: int = 3, hidden_dim: int = EMO_HIDDEN) -> dict:
    """The SER train step of ``train_emotion`` at full width: WavLM-large
    + ASP + the shared, categorical and dimensional trunks, seeded
    weights, the ``dim_ft`` preset's batch of 36 × 5 s (249 frames: kernel
    A, K3), ``--task both``'s two losses in one step, all dropouts,
    LayerDrop and SpecAugment on.  Three runs of ``warmup`` + ``steps``
    steps: the encoder frozen (lr 1e-4), its top half unfrozen and the
    whole encoder trainable (lr 5e-6): finite losses, the frozen prefix
    of the flat parameters bit-equal after the run, and launches equal to
    what the layers run imply (K3 and K2 on the unfrozen layers LayerDrop
    kept, K4 once a step, K6's and K7's backward only with the whole
    encoder), and a step's device time by group.  Then one eval step's
    logits and A/V/D for 2 clips against float32 on the CPU (cosine ≥
    0.99).  Returns the launches of the whole-encoder run.  Its arguments
    let it be rehearsed at a small width on the CPU."""
    cfg = cfg or WavLMConfig.large()
    t0 = time.perf_counter()
    model = _emotion_model(cfg, device, hidden_dim, EMO_DROPOUT)
    state = emotion_trainer.create_emotion_state(model, SEED)
    step = emotion_trainer.make_emotion_train_step("both", EMO_WD)
    data = _emotion_batch(batch, clip_seconds, device, SEED + 15)
    weights = torch.tensor(FT_WEIGHTS, dtype=torch.float32, device=device)
    n = cfg.num_hidden_layers
    frames = int(cfg.feature_lengths(data["input_values"].shape[1]))
    log(f"[emotion] EmotionClassifier on WavLM {n} x {cfg.hidden_size} + "
        f"ASP + trunks of {hidden_dim}: {state.params.numel() / 1e6:.1f} M "
        f"params; batch {batch} x {clip_seconds:g} s ({frames} frames); "
        f"set up in {time.perf_counter() - t0:.1f} s")
    runs = (("frozen", [], 0.0, EMO_LR),
            (f"top {n - n // 2} unfrozen", list(range(n // 2, n)), 0.0,
             EMO_FT_LR),
            ("whole encoder", list(range(n)), 1.0, EMO_FT_LR))
    whole = None
    for name, layers, rest, lr in runs:
        def run_step():
            keep = state.model.encoder.encoder.layer_keep(
                TrainRNG(state.seed, state.step))
            m = step(state, data, weights, layers, lr, rest)
            return m, keep

        for _ in range(warmup):
            m, _ = run_step()
            if not bool(torch.isfinite(m["loss"])):
                raise RuntimeError(f"emotion {name}: non-finite warm-up "
                                   f"loss {float(m['loss'])}")
        off = emotion_trainer.trainable_segments(state, layers, rest)[0][0]
        frozen_before = state.params[:off].clone()
        sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        results = [run_step() for _ in range(steps)]
        sync(device)
        dt = (time.perf_counter() - t0) / steps
        counts = _train_counts()
        losses = [float(m["loss"]) for m, _ in results]
        run = sum(sum(keep) for _, keep in results)
        unfrozen = sum(sum(keep[i] for i in layers) for _, keep in results)
        want = {"fused_ffn_fwd": run, "fused_ffn_bwd_dx": unfrozen,
                "fused_ffn_bwd_dw": unfrozen,
                # the encoder site and each layer's hidden site; their
                # backward on the unfrozen layers, the encoder site's with
                # the whole encoder (the attention output's site is inside
                # kernel A and K3)
                "fused_dropout": steps + run + unfrozen
                + (steps if rest else 0),
                "fused_adamw_ema": steps, "block_attention_fwd": run,
                "block_attention_bwd": unfrozen,
                **frontend_want(cfg, steps, steps if rest else 0)}
        bit_equal = torch.equal(state.params[:off], frozen_before)
        log(f"[emotion] {name}: {dt:.4f} s/step, "
            f"{batch * clip_seconds / dt:.1f} audio-sec/sec; losses "
            f"{[round(x, 6) for x in losses]}; layers run {run}, unfrozen "
            f"run {unfrozen}; the frozen {off / 1e6:.1f} M params "
            f"bit-equal: {bit_equal}; launches {counts} (want {want})")
        if not (all(np.isfinite(losses)) and bit_equal and counts == want):
            raise RuntimeError(f"emotion step {name}: losses {losses}, "
                               f"frozen prefix bit-equal {bit_equal}, "
                               f"launches {counts} != {want}")
        if device.type == "cuda":
            log(f"[emotion] {name}: peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del frozen_before
        if rest:
            whole = counts
        if device.type == "cuda":  # the step's device time by group
            profile_device(lambda: (run_step(), sync(device)),
                           f"[emotion] {name} step, batch {batch}", iters=2,
                           weight_shapes=_param_shapes(model))

    # the eval step on 2 clips against the same weights in float32 on the
    # CPU through the plain versions
    clips = {k: v[:2] for k, v in data.items()}
    eval_step = emotion_trainer.make_emotion_eval_step("both")
    got = eval_step(state.model, clips)
    ref_model = EmotionClassifier(cfg, hidden_dim, dropout=EMO_DROPOUT,
                                  device="meta", compute_dtype=torch.float32)
    ref_model.load_state_dict({k: v.detach().float().cpu() for k, v in
                               state.model.state_dict().items()},
                              strict=True, assign=True)
    torch.set_num_threads(os.cpu_count() or 1)
    ref = eval_step(ref_model, {k: v.cpu() for k, v in clips.items()})
    cos = {k: _cosine_flat(got[k].cpu(), ref[k]) for k in ("logits", "dims")}
    log(f"[emotion] eval step, 2 clips: cosine vs float32 CPU logits "
        f"{cos['logits']:.6f}, A/V/D {cos['dims']:.6f} (bound {COSINE_MIN})")
    if min(cos.values()) < COSINE_MIN or not all(
            torch.isfinite(v).all() for v in got.values()):
        raise RuntimeError(f"emotion eval step against float32: {cos}")
    del state, model, ref_model
    return whole


NRSE_CODES = "AHSFUDCNXO"  # the NRSE ordering, then X and O


def _write_emotion_corpus(root: str, n_train: int, n_val: int,
                          n_noise: int, lo: float, hi: float):
    """An MSP-style corpus under ``root``: ``Audios/`` with ``n_train +
    n_val`` WAVs of ``lo``–``hi`` s (tones in noise), ``noise/`` with
    ``n_noise`` 5 s noise WAVs, and ``labels_consensus.csv`` (FileName,
    EmoClass, EmoAct, EmoVal, EmoDom, SpkrID, Gender, Split_Set)."""
    import csv

    rng = np.random.default_rng(SEED + 16)
    for sub in ("Audios", "noise"):
        os.makedirs(os.path.join(root, sub))
    rows = []
    for i in range(n_train + n_val):
        n = int(rng.uniform(lo, hi) * SAMPLE_RATE)
        ax = np.arange(n) / SAMPLE_RATE
        x = (0.3 * np.sin(2 * np.pi * rng.uniform(80, 300) * ax)
             + 0.02 * rng.standard_normal(n)).astype(np.float32)
        name = f"MSP-PODCAST_{5000 + i:04d}_{i:04d}.wav"
        save_wav(os.path.join(root, "Audios", name), x, SAMPLE_RATE)
        rows.append([name, NRSE_CODES[i % len(NRSE_CODES)],
                     *np.round(rng.uniform(1, 7, 3), 4), 100 + i % 5,
                     "Female" if i % 2 else "Male",
                     "Train" if i < n_train else "Development"])
    for i in range(n_noise):
        save_wav(os.path.join(root, "noise", f"noise_{i}.wav"),
                 (0.2 * rng.standard_normal(5 * SAMPLE_RATE)).astype(
                     np.float32), SAMPLE_RATE)
    with open(os.path.join(root, "labels_consensus.csv"), "w",
              newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["FileName", "EmoClass", "EmoAct", "EmoVal",
                         "EmoDom", "SpkrID", "Gender", "Split_Set"])
        writer.writerows(rows)


def phase_emotion_entry(device=torch.device("cuda"),
                        model_name: str = "microsoft/wavlm-large",
                        layers: int = ENTRY_LAYERS, n_train: int = 24,
                        n_val: int = 8, batch: int = 8,
                        clip_seconds: float = CLIP_SECONDS, lo: float = 2.0,
                        hi: float = 8.0, hidden_dim: int = EMO_HIDDEN) -> None:
    """``python -m nrse_tpu_torch.train_emotion --config
    default_wavlm-large_emotion_dim_ft --task both`` as ``main``, on a
    synthetic MSP-style corpus under ``build/`` with training noise, the
    encoder cut to ``layers`` deep, ``batch`` clips, one epoch a phase:
    each trainer's phase 1 (frozen) and phase 2 (its one epoch unfreezes
    every layer); then ``evaluate_emotion.main`` on each trainer's best
    fine-tuned checkpoint, clean and noisy.  Its arguments let it be
    rehearsed at a small width on the CPU."""
    import yaml

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_emotion_", dir=cuda_build.BUILD_DIR)
    try:
        _write_emotion_corpus(root, n_train, n_val, 2, lo, hi)
        config = config_utils.load_config("default_wavlm-large_emotion_dim_ft")
        config["model"].update(name=model_name, num_hidden_layers=layers)
        config["training"].update(log_dir=os.path.join(root, "logs"))
        config["data"].update(noise_data_path=os.path.join(root, "noise"),
                              max_audio_length=clip_seconds)
        config["emotion"].update(
            labels_file=os.path.join(root, "labels_consensus.csv"),
            audio_dir=os.path.join(root, "Audios"), encoder_checkpoint=None,
            checkpoint_dir=os.path.join(root, "ckpt"), batch_size=batch,
            hidden_dim=hidden_dim, classifier_epochs=1, fine_tuning_epochs=1)
        path = os.path.join(root, "emotion.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(config, f)
        sync(device)
        _reset_counts()
        results = train_emotion.main(["--config", path, "--task", "both",
                                      "--device", device.type])
        sync(device)
        counts = _train_counts()
        steps = sum(e["steps"] for r in results.values()
                    for e in r["epochs"])
        for task, result in results.items():
            for e in result["epochs"]:
                log(f"[emotion entry] {task} {e['phase']}: WavLM {layers} "
                    f"layers (depth cut) x "
                    f"{result['state'].model.encoder_config.hidden_size}, "
                    f"batch {batch}, layers unfrozen {e['layers']}: train "
                    f"loss {e['train_loss']:.6f}, val loss "
                    f"{e['val_loss']:.6f}; {e['steps']} data-fed steps at "
                    f"{e['s_per_step']:.4f} s each "
                    f"({e['audio_sec_per_sec']:.1f} audio-sec/sec)")
        log(f"[emotion entry] launches {counts}")
        ok = (all(np.isfinite(e["train_loss"]) and np.isfinite(e["val_loss"])
                  for r in results.values() for e in r["epochs"])
              and counts["fused_adamw_ema"] == steps > 0
              and counts["block_attention_fwd"] > 0
              and counts["block_attention_bwd"] > 0
              and counts["fused_ffn_bwd_dx"] > 0
              and counts["fused_frontend_fwd"] > 0
              and counts["fused_frontend_bwd"] == 0
              and counts["channel_layernorm_bwd"] == 0)
        if not ok:
            raise RuntimeError(f"emotion entry point: launches {counts}, "
                               f"{steps} steps")
        for task in ("categorical", "dimensional"):
            ckpt = os.path.join(root, "ckpt", task, "best_fine_tuned_model")
            report = evaluate_emotion.main([
                "--config", path, "--checkpoint", ckpt, "--task", task,
                "--device", device.type])
            log(f"[emotion entry] evaluate_emotion.main on the {task} "
                f"checkpoint: {report}")
            if not all(np.isfinite(v) for cond in report.values()
                       for v in cond.values()) or not report["clean"]:
                raise RuntimeError(f"emotion evaluation {task}: {report}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


CLASSIFIER_LONG_SECONDS = 10.0  # phase 17's second artifact: 499 frames, K5
CLASSIFIER_LONG_BUCKET = 8


def _served_model(artifact: str, device):
    """The artifact's ``EmotionClassifier`` built on its own as
    ``ServingModel`` builds it (the encoder's weights in the working
    dtype, the heads float32), for a direct forward."""
    with open(os.path.join(artifact, "manifest.json")) as f:
        manifest = json.load(f)
    model = EmotionClassifier(WavLMConfig(**manifest["encoder_config"]),
                              manifest["hidden_dim"], device="meta")
    model.load_state_dict(torch.load(
        os.path.join(artifact, "params.pt"), map_location="cpu",
        weights_only=True), strict=True, assign=True)
    model.encoder.to(torch.bfloat16 if device.type == "cuda"
                     else torch.float32)
    return model.to(device).eval()


def _serving_rate(server, device, clip_seconds: float, bkt: int,
                  tag: str) -> float:
    """ms a request of ``bkt`` full clips after 3 warm-up requests (host
    clock over 10, the card synchronised at both ends); prints it with
    audio-sec/sec."""
    audio = 0.1 * np.random.default_rng(bkt).standard_normal(
        (bkt, server.clip_samples)).astype(np.float32)
    for _ in range(3):
        server(audio)
    iters = 10
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        server(audio)
    sync(device)
    dt = (time.perf_counter() - t0) / iters
    log(f"[{tag}] bucket {bkt} x {clip_seconds:g} s: {dt * 1e3:.2f} "
        f"ms/request, {bkt * clip_seconds / dt:.1f} audio-sec/sec")
    return dt


def _forward_ms(fn, device, iters: int = 10) -> float:
    """ms a call of ``fn``: CUDA events on the card, the host clock
    between synchronisations on the CPU."""
    if device.type == "cuda":
        return cuda_ms(fn, iters=iters)
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def _compare_with_embedder(server, sd, cfg, device, clip_seconds: float,
                           buckets) -> None:
    """The classifier's bucket forward against the embedder's on the same
    encoder weights, in turns (classifier, embedder, embedder,
    classifier), on inputs already on the device; then the embedder's
    request, whose sequence output crosses to the host."""
    art = tempfile.mkdtemp(prefix="smoke_embedder_",
                           dir=cuda_build.BUILD_DIR)
    try:
        export_embedder({k[len("encoder."):]: v for k, v in sd.items()
                         if k.startswith("encoder.")}, cfg, art,
                        batch_sizes=buckets, clip_seconds=clip_seconds,
                        sample_rate=SAMPLE_RATE)
        embedder = ServingModel(art, device)
    finally:
        shutil.rmtree(art)
    clip = server.clip_samples
    for bkt in buckets:
        a = 0.1 * torch.randn(bkt, clip, generator=torch.Generator()
                              .manual_seed(bkt)).to(device)
        m = torch.ones(bkt, clip, dtype=torch.int32, device=device)
        order = (server, embedder, embedder, server)
        ms = [_forward_ms(lambda s=srv: s.forward(a, m), device)
              for srv in order]
        log(f"[classifier] bucket {bkt} forward on the {device.type}, "
            f"classifier / embedder / embedder / classifier: "
            f"{' / '.join(f'{t:.2f}' for t in ms)} ms")
        _serving_rate(embedder, device, clip_seconds, bkt,
                      "classifier: the embedder")


def phase_classifier(cfg=None, device=torch.device("cuda"),
                     clip_seconds: float = CLIP_SECONDS, buckets=BUCKETS,
                     hidden_dim: int = EMO_HIDDEN,
                     long_seconds: float = CLASSIFIER_LONG_SECONDS,
                     long_bucket: int = CLASSIFIER_LONG_BUCKET) -> dict:
    """Phase 17, the SER classifier's server: ``export_classifier`` of a
    seeded ``EmotionClassifier`` (``task="both"``), ``ServingModel`` on
    the card answering ``_requests``; launches, shapes, the cosine of a
    request against the artifact served in float32 on the CPU, each
    bucket's outputs against a direct forward; then a ``long_seconds``
    artifact of one bucket (K5's length) serving one request.  Its
    arguments let it be rehearsed at a small width on the CPU."""
    cfg = cfg or WavLMConfig.large()
    t0 = time.perf_counter()
    sd = init_emotion_state_dict(cfg, torch.Generator().manual_seed(
        SEED + 17), hidden_dim)
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    art = tempfile.mkdtemp(prefix="smoke_classifier_",
                           dir=cuda_build.BUILD_DIR)
    try:
        export_classifier(sd, cfg, art, batch_sizes=buckets,
                          clip_seconds=clip_seconds, sample_rate=SAMPLE_RATE,
                          task="both", hidden_dim=hidden_dim)
        server = ServingModel(art, device)
        ref_server = ServingModel(art, torch.device("cpu"))  # float32
        direct = _served_model(art, device)
    finally:
        shutil.rmtree(art)
    log(f"[classifier] EmotionClassifier: WavLM {cfg.num_hidden_layers} "
        f"layers x {cfg.hidden_size} + ASP + trunks of {hidden_dim}, "
        f"{sum(v.numel() for v in sd.values()) / 1e6:.1f} M params, task "
        f"both, exported and loaded in {time.perf_counter() - t0:.1f} s")
    clip = server.clip_samples
    for bkt in buckets:  # warm-up
        server(np.zeros((bkt, clip), np.float32))
    sync(device)

    reqs = _requests(np.random.default_rng(SEED + 17), clip_seconds)
    forwards = sum(len(server.plan(len(a))) for _, a, _ in reqs)
    _reset_counts()
    results = []
    for _, audio, lengths in reqs:
        mask = None
        if lengths is not None:
            mask = (np.arange(audio.shape[1])[None, :]
                    < np.asarray(lengths)[:, None]).astype(np.int32)
        results.append(server(audio, mask))
    sync(device)
    layers = cfg.num_hidden_layers
    launches = {"block_attention_fwd": block_attention.LAUNCHES,
                "flash_attention_fwd": flash_attention.LAUNCHES,
                "fused_ffn_fwd": fused_ffn.LAUNCHES, **_frontend_counts()}
    want = {"block_attention_fwd": layers * forwards,
            "flash_attention_fwd": 0, "fused_ffn_fwd": layers * forwards,
            **frontend_want(cfg, forwards, 0)}
    log(f"[classifier] {forwards} bucket forwards; launches {launches} "
        f"(want {want})")
    if launches != want:
        raise RuntimeError(f"classifier launches {launches} != {want}")
    for (name, audio, _), (logits, dims) in zip(reqs, results):
        n = audio.shape[0]
        ok = (logits.shape == (n, 8) and dims.shape == (n, 3)
              and np.isfinite(logits).all() and np.isfinite(dims).all())
        log(f"[classifier] {name}: logits {logits.shape}, A/V/D "
            f"{dims.shape}, finite={ok}")
        if not ok:
            raise RuntimeError(f"bad classifier output for {name}")

    ref_logits, ref_dims = ref_server(reqs[0][1])
    del ref_server
    cos = (_cosine(results[0][0], ref_logits), _cosine(results[0][1],
                                                       ref_dims))
    log(f"[classifier] {reqs[0][0]}: cosine vs float32 CPU logits "
        f"{cos[0]:.6f}, A/V/D {cos[1]:.6f}")
    if min(cos) < COSINE_MIN:
        raise RuntimeError(f"classifier cosine {cos} < {COSINE_MIN}")

    for bkt in buckets:  # each bucket against a direct forward, bit for bit
        audio = 0.1 * np.random.default_rng(bkt + 17).standard_normal(
            (bkt, clip)).astype(np.float32)
        got = server(audio)
        with torch.inference_mode():
            want_out = direct(torch.from_numpy(audio).to(device),
                              torch.ones(bkt, clip, dtype=torch.int32,
                                         device=device), "both")
        same = all(np.array_equal(g, w.float().cpu().numpy())
                   for g, w in zip(got, want_out))
        log(f"[classifier] bucket {bkt}: outputs = a direct "
            f"EmotionClassifier forward on the {device.type}: {same}")
        if not same:
            raise RuntimeError(f"classifier bucket {bkt} differs from a "
                               f"direct forward")
    del direct
    times = {bkt: _serving_rate(server, device, clip_seconds, bkt,
                                "classifier") for bkt in buckets}
    _compare_with_embedder(server, sd, cfg, device, clip_seconds, buckets)
    del server

    art = tempfile.mkdtemp(prefix="smoke_classifier_long_",
                           dir=cuda_build.BUILD_DIR)
    try:
        export_classifier(sd, cfg, art, batch_sizes=(long_bucket,),
                          clip_seconds=long_seconds,
                          sample_rate=SAMPLE_RATE, task="both",
                          hidden_dim=hidden_dim)
        server = ServingModel(art, device)
    finally:
        shutil.rmtree(art)
    long_clip = server.clip_samples
    frames = int(cfg.feature_lengths(long_clip))
    server(np.zeros((long_bucket, long_clip), np.float32))  # warm-up
    lengths = np.linspace(0.5, 1.0, long_bucket) * long_clip
    audio = 0.1 * np.random.default_rng(SEED + 18).standard_normal(
        (long_bucket, long_clip)).astype(np.float32)
    mask = (np.arange(long_clip)[None, :] < lengths[:, None]).astype(
        np.int32)
    sync(device)
    _reset_counts()
    logits, dims = server(audio, mask)
    sync(device)
    launches_long = {"block_attention_fwd": block_attention.LAUNCHES,
                     "flash_attention_fwd": flash_attention.LAUNCHES,
                     "fused_ffn_fwd": fused_ffn.LAUNCHES,
                     **_frontend_counts()}
    want = {"block_attention_fwd": 0, "flash_attention_fwd": layers,
            "fused_ffn_fwd": layers, **frontend_want(cfg, 1, 0)}
    ok = (logits.shape == (long_bucket, 8) and dims.shape == (long_bucket, 3)
          and np.isfinite(logits).all() and np.isfinite(dims).all())
    log(f"[classifier] {long_seconds:g} s artifact ({frames} frames), one "
        f"request of {long_bucket} ragged clips: finite={ok}; launches "
        f"{launches_long} (want {want})")
    if not ok or launches_long != want:
        raise RuntimeError(f"long-clip classifier: finite={ok}, launches "
                           f"{launches_long} != {want}")
    times[f"{long_bucket} x {long_seconds:g} s"] = _serving_rate(
        server, device, long_seconds, long_bucket, "classifier")
    if device.type == "cuda":
        log(f"[classifier] peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def _newest_trace_records(log_dir: str, category: str, pattern: str) -> int:
    """The records of ``category`` whose name holds ``pattern`` in the
    newest trace under ``log_dir``."""
    path = max((os.path.join(log_dir, f) for f in os.listdir(log_dir)),
               key=os.path.getmtime)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events if e.get("cat") == category
               and pattern in e.get("name", ""))


def phase_bridges(cfg=None, device=torch.device("cuda"),
                  model_name: str = "microsoft/wavlm-large",
                  layers: int = ENTRY_LAYERS, batch: int = 8,
                  clip_seconds: float = CLIP_SECONDS,
                  projection_dim: int = 1024, prediction_dim: int = 2048,
                  hidden_dim: int = EMO_HIDDEN, lo: float = 2.0,
                  hi: float = 8.0, trace_kernel: str = "block_attention"
                  ) -> None:
    """Phase 18, the bridges and the encoder API: a reference-format BYOL
    state dict of seeded weights at full width through
    ``reference_byol_to_state_dicts``, ``WavLMEncoder`` on its online
    encoder against ``WavLMModel`` loaded directly (bit for bit) and
    timed; at ``layers`` deep, ``save_reference_byol_checkpoint`` → a
    ``.pt`` under ``build/`` → ``train_emotion.main`` for one step from
    it, and ``serve.export.main`` on a port BYOL checkpoint whose artifact
    ``ServingModel`` answers, one request traced by ``profile_trace``.
    Its arguments let it be rehearsed at a small width on the CPU (where
    the trace holds no kernel, ``trace_kernel`` names a CPU op)."""
    import yaml

    cfg = cfg or WavLMConfig.from_model_name(model_name)
    t0 = time.perf_counter()
    online = init_byol_state_dict(cfg, projection_dim, prediction_dim,
                                  torch.Generator().manual_seed(SEED + 18))
    target = {k: v for k, v in online.items()
              if not k.startswith("predictor.")}
    reference = byol_state_dicts_to_reference(online, target)
    bridged, bridged_target = reference_byol_to_state_dicts(reference, cfg)
    exact = (bridged.keys() == online.keys()
             and bridged_target.keys() == target.keys()
             and all(np.array_equal(bridged[k], online[k].numpy())
                     for k in online))
    log(f"[bridges] WavLM {cfg.num_hidden_layers} x {cfg.hidden_size} BYOL "
        f"tower → reference layout ({len(reference)} tensors) → "
        f"reference_byol_to_state_dicts in {time.perf_counter() - t0:.1f} s:"
        f" the seeded weights back bit for bit: {exact}")
    if not exact:
        raise RuntimeError("the bridge changed the weights")
    encoder_sd = {k[len("encoder."):]: v for k, v in bridged.items()
                  if k.startswith("encoder.")}
    del reference, bridged, bridged_target, target
    enc = WavLMEncoder(config=cfg, state_dict=encoder_sd, device=device)
    direct = WavLMModel(cfg, device="meta")
    direct.load_state_dict({k[len("encoder."):]: v for k, v in online.items()
                            if k.startswith("encoder.")},
                           strict=True, assign=True)
    direct = direct.to(device=device, dtype=enc.model.feature_projection
                       .projection.weight.dtype).eval()
    clip = int(clip_seconds * SAMPLE_RATE)
    audio = torch.from_numpy((0.1 * np.random.default_rng(SEED + 18)
                              .standard_normal((batch, 1, clip))).astype(
        np.float32)).to(device)
    mask = torch.ones(batch, clip, dtype=torch.int32, device=device)
    mask[1, clip // 2:] = 0
    got = enc(audio, mask)
    with torch.inference_mode():
        want_seq, _ = direct(audio[:, 0], mask)
    same = torch.equal(got, want_seq)
    log(f"[bridges] WavLMEncoder on the bridged online encoder = WavLMModel "
        f"loaded directly, on the {device.type}: {same}; output_dim "
        f"{enc.output_dim}, hidden state {tuple(got.shape)}")
    if not same:
        raise RuntimeError("WavLMEncoder differs from WavLMModel")
    del direct
    for _ in range(3):
        enc(audio, mask)
    sync(device)
    _reset_counts()
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        enc(audio, mask)
    sync(device)
    dt = (time.perf_counter() - t0) / iters
    calls = {"block_attention_fwd": block_attention.LAUNCHES,
             "fused_ffn_fwd": fused_ffn.LAUNCHES, **_frontend_counts()}
    want = {"block_attention_fwd": cfg.num_hidden_layers * iters,
            "fused_ffn_fwd": cfg.num_hidden_layers * iters,
            **frontend_want(cfg, iters, 0)}
    log(f"[bridges] WavLMEncoder {batch} x {clip_seconds:g} s: "
        f"{dt * 1e3:.2f} ms/batch, {batch * clip_seconds / dt:.1f} "
        f"audio-sec/sec; launches {calls} (want {want})")
    if calls != want:
        raise RuntimeError(f"WavLMEncoder launches {calls} != {want}")
    del enc, online, encoder_sd

    shallow = dataclasses.replace(cfg, num_hidden_layers=layers)
    root = tempfile.mkdtemp(prefix="smoke_bridges_", dir=cuda_build.BUILD_DIR)
    try:
        tower = init_byol_state_dict(shallow, projection_dim, prediction_dim,
                                     torch.Generator().manual_seed(SEED + 19))
        pt = os.path.join(root, "byol_reference.pt")
        save_reference_byol_checkpoint(
            pt, tower, {k: v for k, v in tower.items()
                        if not k.startswith("predictor.")}, epoch=3)
        _write_emotion_corpus(root, batch + 2, 4, 2, lo, hi)
        config = config_utils.load_config("default_wavlm-large_emotion_dim_ft")
        config["model"].update(name=model_name, num_hidden_layers=layers)
        config["training"].update(log_dir=os.path.join(root, "logs"))
        config["data"].update(noise_data_path=os.path.join(root, "noise"),
                              max_audio_length=clip_seconds)
        config["emotion"].update(
            labels_file=os.path.join(root, "labels_consensus.csv"),
            audio_dir=os.path.join(root, "Audios"), encoder_checkpoint=pt,
            checkpoint_dir=os.path.join(root, "ckpt"), batch_size=batch,
            hidden_dim=hidden_dim, classifier_epochs=1,
            unfreeze_encoder=False)
        path = os.path.join(root, "emotion.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(config, f)
        result = train_emotion.main(["--config", path, "--task",
                                     "categorical", "--device",
                                     device.type])["categorical"]
        (epoch,) = result["epochs"]
        model = result["state"].model
        from_pt = all(torch.equal(p.detach().cpu(), tower[f"encoder.{n}"])
                      for n, p in model.encoder.named_parameters())
        log(f"[bridges] train_emotion.main from the reference .pt "
            f"(WavLM {layers} layers x {shallow.hidden_size}): "
            f"{epoch['steps']} step, train loss {epoch['train_loss']:.6f}, "
            f"the frozen encoder = the .pt's online encoder: {from_pt}")
        if epoch["steps"] != 1 or not np.isfinite(epoch["train_loss"]) \
                or not from_pt:
            raise RuntimeError(f"train_emotion from a .pt: {epoch}, "
                               f"encoder from the .pt {from_pt}")
        del result, model

        state = create_train_state(shallow, tower, projection_dim,
                                   prediction_dim, "cpu")
        ckpt = save_checkpoint(os.path.join(root, "byol"), "best_val_loss",
                               state)
        byol_yaml = os.path.join(root, "byol.yaml")
        with open(byol_yaml, "w") as f:
            yaml.safe_dump({"model": {"name": model_name,
                                 "num_hidden_layers": layers},
                       "data": {"max_audio_length": clip_seconds,
                                "sample_rate": SAMPLE_RATE}}, f)
        out = serve_export.main(["--config", byol_yaml, "--checkpoint", ckpt,
                                 "--out", os.path.join(root, "artifact"),
                                 "--batch-sizes", "1,8", "--device",
                                 device.type])
        server = ServingModel(out, device)
        direct = WavLMModel(shallow, device="meta")
        direct.load_state_dict({k[len("encoder."):]: v for k, v in
                                tower.items() if k.startswith("encoder.")},
                               strict=True, assign=True)
        direct = direct.to(device=device, dtype=next(
            server.model.parameters()).dtype).eval()
        req = 0.1 * np.random.default_rng(SEED + 20).standard_normal(
            (batch, server.clip_samples)).astype(np.float32)
        seq, pooled = server(req)
        with torch.inference_mode():
            _, want_pooled = direct(torch.from_numpy(req).to(device),
                                    torch.ones(batch, server.clip_samples,
                                               dtype=torch.int32,
                                               device=device))
        same = np.array_equal(pooled, want_pooled.float().cpu().numpy())
        log(f"[bridges] serve.export.main on a port BYOL checkpoint: "
            f"{server.kind} artifact, buckets {server.buckets}; a request "
            f"of {batch}: sequence {seq.shape}, pooled = the checkpoint's "
            f"encoder run directly: {same}")
        if not same or not np.isfinite(seq).all():
            raise RuntimeError("the exported embedder differs from its "
                               "checkpoint's encoder")
        traces = os.path.join(root, "traces")
        category = "kernel" if device.type == "cuda" else "cpu_op"
        for attempt in range(1, TRACE_ATTEMPTS + 1):
            with profile_trace(traces):
                server(req)
            found = _newest_trace_records(traces, category, trace_kernel)
            log(f"[bridges] profile_trace of one request (attempt "
                f"{attempt}): {found} '{trace_kernel}' {category} records")
            if found:
                break
        else:
            raise RuntimeError(f"profile_trace held no {trace_kernel} "
                               f"{category} record in {TRACE_ATTEMPTS} "
                               f"traces")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase 19: data parallelism on the one card (the port's ``parallel``
# package and ``replicas_agree`` are imported in its functions, so that
# this script still runs the other phases on a commit that predates them,
# as tools/port_before_after.py does).  19(b) holds two ranks × 18
# clips against one rank × 36 from the same weights, random features off.
# The two runs share every per-row computation and differ only where rows
# are summed (the heads' BatchNorm sums, the loss's sums, the weight
# gradients of each half batch added by the all_reduce).  At the first
# step, from the same parameters, a change in the last float32 bit of such
# a sum moves a bf16 rounding downstream by at most one bf16 ulp (2⁻⁸) in
# the elements it reaches: the loss stays within 1e-3 and the gradient
# norm within 1e-2.  Adam (eps 1e-8) then turns every gradient element
# below that noise into ±lr of either sign, so the later steps start from
# other parameters and the runs drift apart as any two orders of the same
# sums do (the deltas' cosine read 0.9928 after three steps on an NVIDIA
# H100 80GB HBM3 at 700 W; PERF.md §6).  A
# control measures that drift on the same card: one rank × 36 on the batch
# with its rows reversed (the same sums in another order) against the
# one-rank run; the two ranks may drift at most DP_DRIFT_FACTOR times as
# far (the loss and gradient norm at every step, and the parameter deltas
# after the last).
DP_STEPS = 3
DP_LOSS_TOL = 1e-3       # |Δloss| / loss at the first step
DP_GRAD_NORM_TOL = 1e-2  # |Δgrad_norm| / grad_norm at the first step
DP_DRIFT_FACTOR = 4.0


def _quiet(cfg):
    """``cfg`` with dropout, LayerDrop and SpecAugment off."""
    return dataclasses.replace(cfg, hidden_dropout=0.0,
                               activation_dropout=0.0, attention_dropout=0.0,
                               layerdrop=0.0, mask_time_prob=0.0)


def _byol_state(cfg, sd, device, projection_dim, prediction_dim, mesh=None):
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    return create_train_state(cfg, sd, projection_dim, prediction_dim,
                              device, seed=SEED, compute_dtype=dtype,
                              mesh=mesh)


def _timed_steps(state, step, data, steps: int, device, check=None):
    """``steps + 1`` train steps (the first untimed); returns the metrics
    of all of them and the s/step of the last ``steps``, each rank waiting
    for the others around every step; ``check(state)`` after each step
    runs outside the timed window."""
    from nrse_tpu_torch.parallel.distributed import barrier

    metrics, dt, extra = [], 0.0, []
    for i in range(steps + 1):
        sync(device)
        barrier()
        t0 = time.perf_counter()
        metrics.append(step(state, data))
        sync(device)
        barrier()
        if i:
            dt += time.perf_counter() - t0
        if check is not None:
            extra.append(check(state))
    return metrics, dt / steps, extra


def _tensors_equal(a, b) -> bool:
    ta, tb = a.tensors(), b.tensors()
    return ta.keys() == tb.keys() and all(torch.equal(ta[k], tb[k])
                                          for k in ta)


def phase_dp_one_rank(cfg=None, device=torch.device("cuda"),
                      batch: int = TRAIN_BATCH,
                      clip_seconds: float = CLIP_SECONDS,
                      steps: int = DP_STEPS, projection_dim: int = 1024,
                      prediction_dim: int = 2048) -> dict:
    """19(a): the BYOL step at full width (the JAX preset's
    hyper-parameters, every random feature on) through the data-parallel
    path in a group of one rank over NCCL (gloo on the CPU), against the
    same steps without a group, from the same weights: the metrics and
    every buffer bit for bit, the launches the layers run imply, s/step of
    both.  Its arguments let it be rehearsed at a small width on the
    CPU."""
    from nrse_tpu_torch.parallel.distributed import default_backend
    from nrse_tpu_torch.parallel.launch import free_port
    from nrse_tpu_torch.parallel.mesh import make_mesh
    from nrse_tpu_torch.train.byol_trainer import replicas_agree

    cfg = cfg or WavLMConfig.large()
    sd = init_byol_state_dict(cfg, projection_dim, prediction_dim,
                              torch.Generator().manual_seed(SEED))
    data = _train_batch(batch, clip_seconds, device)
    step = make_byol_train_step(_adamw_spec())
    plain = _byol_state(cfg, sd, device, projection_dim, prediction_dim)
    plain_metrics, plain_dt, _ = _timed_steps(plain, step, data, steps,
                                              device)
    backend = default_backend(device.type)
    dist.init_process_group(backend,
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(device=device)
        dp = _byol_state(cfg, sd, device, projection_dim, prediction_dim,
                         mesh)
        sync(device)
        _reset_counts()
        dp_metrics, dp_dt, _ = _timed_steps(dp, step, data, steps, device)
        sync(device)
        counts = _train_counts()
        agree = replicas_agree(dp)
    finally:
        dist.destroy_process_group()
    want = byol_launch_want(cfg, dp_metrics)
    same_metrics = all(torch.equal(a[k], b[k])
                       for a, b in zip(plain_metrics, dp_metrics)
                       for k in ("loss", "grad_norm", "valid_fraction"))
    same_state = _tensors_equal(plain, dp)
    log(f"[dp one rank] BYOL on WavLM {cfg.num_hidden_layers} x "
        f"{cfg.hidden_size}, batch {batch} x {clip_seconds:g} s, "
        f"{steps + 1} steps, {backend} group of 1 on {mesh.device}: losses "
        f"{[round(float(m['loss']), 6) for m in dp_metrics]}; metrics equal "
        f"the step without a group bit for bit: {same_metrics}; every "
        f"buffer: {same_state}; replicas_agree {agree}; launches {counts} "
        f"(want {want})")
    log(f"[dp one rank] {plain_dt:.4f} s/step without a group, {dp_dt:.4f} "
        f"s/step through the data-parallel path ({backend}, 1 rank): the "
        f"reductions cost {dp_dt - plain_dt:+.4f} s/step")
    if (device.type == "cuda" and counts != want) or not (
            same_metrics and same_state and agree):
        raise RuntimeError("the data-parallel step at one rank differs "
                           "from the step without a group")
    return counts


def _drift(metrics, delta, ref) -> dict:
    """How far a run's per-step losses and grad norms (``metrics``, host
    floats) and its parameter delta lie from the one-rank run's
    (``ref``): the largest relative difference of each over the steps,
    and the deltas' cosine and relative distance (float32 on the card, no
    copies but one difference)."""
    out = {f"{k}_drift": max(abs(a - b) / abs(b)
                             for a, b in zip(metrics[k], ref[k]))
           for k in ("loss", "grad_norm")}
    out["first"] = {k: abs(metrics[k][0] - ref[k][0]) / abs(ref[k][0])
                    for k in ("loss", "grad_norm")}
    norm = torch.linalg.vector_norm
    rd = ref["delta"]
    out["delta_cosine"] = float(torch.dot(delta, rd)
                                / (norm(delta) * norm(rd)))
    out["delta_rel"] = float(norm(delta - rd) / norm(rd))
    return out


def _two_rank_worker(rank: int, world: int, cfg, device: str, batch: int,
                     clip_seconds: float, steps: int, projection_dim: int,
                     prediction_dim: int) -> dict:
    """One rank of 19(b), sharing the card with the other over gloo."""
    from nrse_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from nrse_tpu_torch.train.byol_trainer import replicas_agree

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def peak_gib():
        if device.type != "cuda":
            return float("nan")
        return torch.cuda.max_memory_allocated(device) / 2**30

    def reset_peak():
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)

    out = {"rank": rank}
    qcfg = _quiet(cfg)
    qsd = init_byol_state_dict(qcfg, projection_dim, prediction_dim,
                               torch.Generator().manual_seed(SEED))
    data = _train_batch(batch, clip_seconds, device)
    step = make_byol_train_step(_adamw_spec())

    def run(state, rows):
        p0 = state.params.clone()
        ms = [step(state, rows) for _ in range(steps)]
        sync(device)
        return ({"loss": [float(m["loss"]) for m in ms],
                 "grad_norm": [float(m["grad_norm"]) for m in ms]},
                state.params - p0)

    if rank == 0:  # one rank on the global batch, measured first
        reset_peak()
        ref, ref["delta"] = run(_byol_state(qcfg, qsd, device,
                                            projection_dim,
                                            prediction_dim), data)
        out["ref_peak_gib"] = peak_gib()
        out["ref"] = {k: ref[k] for k in ("loss", "grad_norm")}
        # the control: the same sums in another order
        backwards = {k: v.flip(0) for k, v in data.items()}
        control, delta = run(_byol_state(qcfg, qsd, device, projection_dim,
                                         prediction_dim), backwards)
        out["control"] = dict(control, **_drift(control, delta, ref))
        del delta, backwards
    dist.barrier()
    mesh = make_mesh(device=device)
    reset_peak()
    st = _byol_state(qcfg, qsd, device, projection_dim, prediction_dim,
                     mesh)
    local = shard_batch(mesh, data)
    p0 = st.params.clone()
    metrics, agree = {"loss": [], "grad_norm": []}, []
    for _ in range(steps):
        m = step(st, local)
        agree.append(replicas_agree(st))
        metrics["loss"].append(float(m["loss"]))
        metrics["grad_norm"].append(float(m["grad_norm"]))
    out["deterministic_peak_gib"] = peak_gib()
    out["dp"] = metrics
    out["agree_deterministic"] = agree
    if rank == 0:
        out["dp"].update(_drift(metrics, st.params - p0, ref))
        del ref
    del st, p0, qsd
    # the full configuration: every random feature on
    reset_peak()
    fsd = init_byol_state_dict(cfg, projection_dim, prediction_dim,
                               torch.Generator().manual_seed(SEED))
    st = _byol_state(cfg, fsd, device, projection_dim, prediction_dim, mesh)
    del fsd
    _reset_counts()
    metrics, dt, agree = _timed_steps(st, step, local, steps, device,
                                      check=replicas_agree)
    sync(device)
    out["counts"] = _train_counts()
    out["want"] = byol_launch_want(cfg, metrics)
    out["full_loss"] = [float(m["loss"]) for m in metrics]
    out["full_finite"] = all(bool(m["finite"]) for m in metrics)
    out["full_layers"] = [(m["layers_online"], m["layers_target"])
                          for m in metrics]
    out["agree_full"] = agree
    out["s_per_step"] = dt
    out["peak_gib"] = peak_gib()
    return out


def phase_dp_two_ranks(cfg=None, device=torch.device("cuda"),
                       batch: int = TRAIN_BATCH,
                       clip_seconds: float = CLIP_SECONDS,
                       steps: int = DP_STEPS, projection_dim: int = 1024,
                       prediction_dim: int = 2048) -> list:
    """19(b): two ranks sharing the one card over gloo, each holding half
    of the global batch at full width; first the deterministic
    configuration against one rank's run of the whole batch from the same
    weights and against the control (rank 0 runs both before the group's
    steps, the one-rank run's peak memory measured first; bounds:
    ``DP_LOSS_TOL`` and around), then the full configuration: finite, the
    replicas bit-equal after every step, launches as the layers run imply,
    s/step and each rank's peak memory."""
    from nrse_tpu_torch.parallel.launch import run_ranks

    cfg = cfg or WavLMConfig.large()
    spec = f"{device.type}:0" if device.type == "cuda" else "cpu"
    ranks = run_ranks(_two_rank_worker, 2,
                      (cfg, spec, batch, clip_seconds, steps,
                       projection_dim, prediction_dim), threads=0,
                      timeout=900)
    r0 = ranks[0]
    dp, control = r0["dp"], r0["control"]
    for name, run in (("two ranks x half", dp),
                      ("control: one rank, rows reversed", control)):
        log(f"[dp two ranks] {name} against one rank x {batch}, WavLM "
            f"{cfg.num_hidden_layers} x {cfg.hidden_size}, {clip_seconds:g} "
            f"s clips, random features off, {steps} steps: losses "
            f"{run['loss']} vs {r0['ref']['loss']}, grad norms "
            f"{run['grad_norm']} vs {r0['ref']['grad_norm']}; at the first "
            f"step loss {run['first']['loss']:.3e}, grad_norm "
            f"{run['first']['grad_norm']:.3e} relative")
    ok_first = dp["first"]["loss"] <= DP_LOSS_TOL and \
        dp["first"]["grad_norm"] <= DP_GRAD_NORM_TOL
    ok_drift = all(
        dp[k] <= max(DP_DRIFT_FACTOR * control[k], tol)
        for k, tol in (("loss_drift", DP_LOSS_TOL),
                       ("grad_norm_drift", DP_GRAD_NORM_TOL))
    ) and dp["delta_rel"] <= DP_DRIFT_FACTOR * control["delta_rel"]
    log(f"[dp two ranks] first step: loss {dp['first']['loss']:.3e} (bound "
        f"{DP_LOSS_TOL}), grad_norm {dp['first']['grad_norm']:.3e} (bound "
        f"{DP_GRAD_NORM_TOL}); drift over {steps} steps, two ranks / "
        f"control: loss {dp['loss_drift']:.3e} / "
        f"{control['loss_drift']:.3e}, grad_norm "
        f"{dp['grad_norm_drift']:.3e} / {control['grad_norm_drift']:.3e}, "
        f"parameter "
        f"deltas' relative distance {dp['delta_rel']:.3e} / "
        f"{control['delta_rel']:.3e} (cosine {dp['delta_cosine']:.6f} / "
        f"{control['delta_cosine']:.6f}); bound {DP_DRIFT_FACTOR:g} x the "
        f"control's")
    log(f"[dp two ranks] one rank x {batch}: peak device memory "
        f"{r0['ref_peak_gib']:.2f} GiB")
    for r in ranks:
        log(f"[dp two ranks] rank {r['rank']}: peak device memory "
            f"{r['deterministic_peak_gib']:.2f} GiB (random features off), "
            f"{r['peak_gib']:.2f} GiB (on); full configuration losses "
            f"{r['full_loss']}, layers run {r['full_layers']}, replicas "
            f"agree after every step {r['agree_deterministic']} "
            f"{r['agree_full']}; {r['s_per_step']:.4f} s/step (two ranks "
            f"sharing one card over gloo, not a scaling figure); launches "
            f"{r['counts']}")
    bad = [r["rank"] for r in ranks
           if not (r["full_finite"] and all(r["agree_deterministic"])
                   and all(r["agree_full"]) and (
                       device.type != "cuda" or r["counts"] == r["want"]))]
    if ranks[0]["full_loss"] != ranks[1]["full_loss"]:
        bad.append("the ranks' pooled losses differ")
    if not (ok_first and ok_drift):
        bad.append("two ranks x half the batch differ from one rank")
    if bad:
        raise RuntimeError(f"data parallelism over two ranks: {bad}")
    return ranks


def _dp_entry_worker(rank: int, world: int, device: str, byol_config,
                     encoder, emotion_config) -> dict:
    """One rank of 19(c): ``train_byol.main``, then ``train_emotion.run``
    in the rank's group."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    _reset_counts()
    byol = train_byol.main(byol_config, encoder)
    emotion = train_emotion.run(emotion_config)
    sync(dev)
    keys = ("train_loss", "val_loss", "steps", "s_per_step")
    return {"rank": rank, "counts": _train_counts(),
            "byol": [{k: e[k] for k in keys + ("val_avg_similarity",)}
                     for e in byol["epochs"]],
            "emotion": {task: [{k: e[k] for k in keys + ("phase",)}
                               for e in r["epochs"]]
                        for task, r in emotion.items()}}


def phase_dp_entry(device=torch.device("cuda"), layers: int = ENTRY_LAYERS,
                   model_name: str = "microsoft/wavlm-large",
                   clips: int = 24, noise_clips: int = 4, batch: int = 8,
                   clip_seconds: float = CLIP_SECONDS,
                   projection_dim: int = 1024, prediction_dim: int = 2048,
                   emotion_clips=(16, 8), lo: float = 2.0, hi: float = 8.0,
                   hidden_dim: int = EMO_HIDDEN) -> None:
    """19(c): ``train_byol.main`` and ``train_emotion.run`` (``--task
    both``, the ``dim_ft`` preset) with two gloo ranks sharing the card,
    WavLM at full width cut to ``layers`` deep, global batch ``batch``,
    one epoch (a phase), on synthetic corpora under ``build/``: both
    ranks report the same pooled losses, finite; rank 0's checkpoints
    exist; every kernel of the path ran."""
    from nrse_tpu_torch.parallel.launch import run_ranks

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_dp_", dir=cuda_build.BUILD_DIR)
    spec = f"{device.type}:0" if device.type == "cuda" else "cpu"
    try:
        clean, noise = _write_corpus(os.path.join(root, "byol"), clips,
                                     noise_clips, clip_seconds)
        byol_config = {
            "model": {"name": model_name, "projection_dim": projection_dim,
                      "prediction_dim": prediction_dim, "ema_decay": 0.997},
            "training": {"batch_size": batch, "num_workers": 8,
                         "num_epochs": 1, "learning_rate": 1e-5,
                         "weight_decay": 1e-5, "seed": SEED,
                         "checkpoint_dir": os.path.join(root, "byol_ckpt"),
                         "log_dir": os.path.join(root, "byol_logs")},
            "data": {"clean_data_path": clean, "noise_data_path": noise,
                     "sample_rate": SAMPLE_RATE,
                     "max_audio_length": clip_seconds,
                     "snr_range": [0, 5, 10, 15, 20],
                     "validation_ratio": 0.25},
            "device": spec}
        msp = os.path.join(root, "msp")
        os.makedirs(msp)
        _write_emotion_corpus(msp, *emotion_clips, 2, lo, hi)
        emotion_config = config_utils.load_config(
            "default_wavlm-large_emotion_dim_ft")
        emotion_config["model"].update(name=model_name,
                                       num_hidden_layers=layers)
        emotion_config["training"].update(
            log_dir=os.path.join(root, "emotion_logs"))
        emotion_config["data"].update(
            noise_data_path=os.path.join(msp, "noise"),
            max_audio_length=clip_seconds)
        emotion_config["emotion"].update(
            labels_file=os.path.join(msp, "labels_consensus.csv"),
            audio_dir=os.path.join(msp, "Audios"), encoder_checkpoint=None,
            checkpoint_dir=os.path.join(root, "emotion_ckpt"),
            batch_size=batch, hidden_dim=hidden_dim, classifier_epochs=1,
            fine_tuning_epochs=1)
        emotion_config = config_utils.validate_config(
            dict(emotion_config, device=spec, task="both"))
        encoder = dataclasses.replace(WavLMConfig.from_model_name(
            model_name), num_hidden_layers=layers)
        ranks = run_ranks(_dp_entry_worker, 2,
                          (spec, byol_config, encoder, emotion_config),
                          threads=0, timeout=900)
        for r in ranks:
            for e in r["byol"]:
                log(f"[dp entry] rank {r['rank']} train_byol: WavLM "
                    f"{layers} layers (depth cut) x {encoder.hidden_size}, "
                    f"global batch {batch} = 2 x {batch // 2} on {spec} over "
                    f"gloo: train loss {e['train_loss']:.6f}, val loss "
                    f"{e['val_loss']:.6f}, val similarity "
                    f"{e['val_avg_similarity']:.6f}; {e['steps']} data-fed "
                    f"steps at {e['s_per_step']:.4f} s/step")
            for task, records in r["emotion"].items():
                for e in records:
                    log(f"[dp entry] rank {r['rank']} train_emotion {task} "
                        f"{e['phase']}: train loss {e['train_loss']:.6f}, "
                        f"val loss {e['val_loss']:.6f}; {e['steps']} "
                        f"data-fed steps at {e['s_per_step']:.4f} s/step")
            log(f"[dp entry] rank {r['rank']} launches {r['counts']}")

        def pooled(r):
            return ([(e["train_loss"], e["val_loss"]) for e in r["byol"]],
                    {t: [(e["train_loss"], e["val_loss"]) for e in rs]
                     for t, rs in r["emotion"].items()})

        saved = [os.path.isfile(os.path.join(root, *p, "state.pt")) for p in
                 (("byol_ckpt", "last_model"),
                  ("emotion_ckpt", "categorical", "best_classifier_model"),
                  ("emotion_ckpt", "dimensional", "best_fine_tuned_model"))]
        finite = all(np.isfinite(v) for r in ranks
                     for pair in pooled(r)[0] for v in pair) and all(
            np.isfinite(v) for r in ranks for rs in pooled(r)[1].values()
            for pair in rs for v in pair)
        ran = device.type != "cuda" or all(
            n > 0 for r in ranks for n in r["counts"].values())
        log(f"[dp entry] the ranks' pooled losses equal: "
            f"{pooled(ranks[0]) == pooled(ranks[1])}; rank 0's checkpoints "
            f"{saved}")
        if not (pooled(ranks[0]) == pooled(ranks[1]) and finite
                and all(saved) and ran):
            raise RuntimeError("data-parallel entry points: the ranks "
                               "disagree, a loss is not finite, a "
                               "checkpoint is missing or a kernel never ran")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_dp(cfg=None, device=torch.device("cuda")) -> dict:
    """19: data parallelism on the one card, (a) to (c); returns 19(a)'s
    launches."""
    from nrse_tpu_torch.parallel.dryrun import collectives_check
    from nrse_tpu_torch.parallel.launch import run_ranks

    if device.type == "cuda":
        log(f"[dp] card: {card()}")
        probe = run_ranks(collectives_check, 2, ("cuda:0",), threads=0)
        log(f"[dp] gloo's collectives on CUDA tensors, 2 ranks on one "
            f"card: {probe}")
    counts = phase_dp_one_rank(cfg, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    phase_dp_two_ranks(cfg, device)
    phase_dp_entry(device)
    return counts


def main() -> int:
    name = phase_device()
    phase_build()
    kernels = [phase_kernel_a(), phase_k3(), phase_kernel_b(), phase_k1(),
               *phase_k2(), phase_k4(), phase_k5(), *phase_k5_bwd(),
               *phase_frontend_kernels()]
    launches = phase_serving()
    launches.update({k: v for k, v in phase_training().items()
                     if k not in launches})
    phase_crosscheck()
    phase_entry()
    launches["flash_attention_fwd"] = phase_ser()["flash_attention_fwd"]
    phase_long_clip()
    ft = phase_ft_step()
    # K5's backward and the frontend kernels from the fine-tune's e2e cycle
    for k in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv",
              *_frontend_counts()):
        launches[k] = ft[k]
    phase_ft_crosscheck()
    phase_ft_entry()
    phase_emotion_step()
    phase_emotion_entry()
    phase_classifier()
    phase_bridges()
    phase_dp()
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
