"""The benchmark's fixed arithmetic: the card's peaks, the model FLOPs of a
clip, the least time of the kernels' work, and the kernel-name groups.

Peaks are the H100 SXM's published dense rates (NVIDIA's data sheet): 989
TFLOP/s in bf16 on the tensor cores and 3.35 TB/s of HBM.  A kernel's
least time is the larger of its operations over the peak and its bytes
over the bandwidth, each input read once and each output written once.
The operation counts per kernel are those the port's own on-card checks
bound its kernels with; they are frozen here so that no change to the
program can move them.

Model FLOPs are counted from the configuration's widths on the real audio
of each clip (padding not counted), two FLOPs a multiply-add, the
backward twice the forward except the first conv, whose input needs no
gradient; recomputation is not counted.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Sequence

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def least_seconds(flop: float, nbytes: float) -> float:
    return max(flop / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def frames(cfg: Dict, samples: int) -> List[int]:
    """Each conv layer's output length for ``samples`` input samples."""
    out, n = [], int(samples)
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        n = (n - k) // s + 1
        out.append(n)
    return out


def encoder_forward_flop(cfg: Dict, samples: int, layers: int) -> Dict:
    """Forward FLOPs of one clip of ``samples`` real samples through the
    frontend (``conv0`` apart, since its backward is half) and ``layers``
    transformer layers."""
    c, f = cfg["hidden_size"], cfg["intermediate_size"]
    h = cfg["num_attention_heads"]
    dims = cfg["conv_dim"]
    ts = frames(cfg, samples)
    conv0 = 2.0 * ts[0] * dims[0] * 1 * cfg["conv_kernel"][0]
    rest = sum(2.0 * ts[i] * dims[i] * dims[i - 1] * cfg["conv_kernel"][i]
               for i in range(1, len(dims)))
    t = ts[-1]
    proj = 2.0 * t * dims[-1] * c
    pos = 2.0 * t * c * (c // cfg["num_conv_pos_embedding_groups"]) \
        * cfg["num_conv_pos_embeddings"]
    layer = (4 * 2.0 * t * c * c          # q, k, v, out projections
             + 2 * 2.0 * t * t * c         # scores and probabilities x v
             + 2.0 * t * h * (c // h) * 8  # the gate's projection
             + 2 * 2.0 * t * c * f)        # the FFN
    return {"conv0": conv0, "rest": rest + proj + pos + layers * layer}


def byol_heads_flop(projection: int, prediction: int, hidden: int) -> float:
    """Projector and predictor of one row, forward."""
    proj = 2.0 * (hidden * projection + projection * projection)
    pred = 2.0 * (projection * prediction + prediction * prediction
                  + prediction * projection)
    return proj + pred


def ser_head_flop(cfg: Dict, head: Dict, t: int) -> float:
    """ASP over ``t`` frames and the classifier head of one row, forward."""
    c = cfg["hidden_size"]
    asp = 2.0 * t * c * c + 2.0 * t * c + 4.0 * t * c
    mlp = 2.0 * (2 * c * head["head_dim"] + head["head_dim"]
                 * head["num_classes"])
    return asp + mlp


def train_flop(fwd: Dict) -> float:
    """Forward and backward of an encoder forward count."""
    return 2.0 * fwd["conv0"] + 3.0 * fwd["rest"]


def ffn_least(n: int, c: int, f: int, mode: str) -> float:
    """Least seconds of one layer's FFN on ``n`` rows: ``serve`` (kernel
    B), ``target`` (kernel B's training entry without its backward) or
    ``train`` (kernel B's training entry, K2's dx and dW)."""
    flop = 4.0 * n * c * f
    w = 2 * (2 * c * f) + 2 * (f + c)
    io = 2 * n * c * 2
    if mode == "serve":
        return least_seconds(flop, w + io)
    fwd = least_seconds(flop, w + io + 4 * n * f)
    if mode == "target":
        return fwd
    # dx reads dout, h1 and both weights and writes dx and dh1; dW reads
    # x, gd, dh1 and dh2 and writes both weight gradients
    dx = least_seconds(flop, 2 * n * c + 2 * n * f + w + 2 * n * c
                       + 2 * n * f)
    dw = least_seconds(flop, 2 * n * c + 4 * n * f + 2 * n * c + 4 * 2 * c
                       * f)
    return fwd + dx + dw


def attention_least(b: int, h: int, t: int, d: int, mode: str,
                    dense_bias: bool) -> float:
    """Least seconds of one layer's attention core at ``[b, h, t, d]``:
    forward (kernel A or K5), and with ``mode == "train"`` its backward
    (K3, or K5's dq and dk/dv: five products between them)."""
    qkv = 3 * 2 * b * h * t * d
    bias = 4 * h * t * t if dense_bias else 2 * h * 2 * t
    side = 4 * b * h * t + 4 * b * t  # gate and key mask
    out = 2 * b * h * t * d + 4 * b * h * t
    fwd = least_seconds(4.0 * b * h * t * t * d, qkv + bias + side + out)
    if mode != "train":
        return fwd
    bwd = least_seconds(10.0 * b * h * t * t * d,
                        qkv + bias + side + out + 2 * b * h * t * d
                        + qkv + 4 * h * t * t)
    return fwd + bwd


# kernel name patterns -> groups, first match wins: the port's profile
# table, frozen
GROUPS = (
    ("K6 (fused conv frontend)", "k6_|K6RowSource"),
    ("K7 (channel LayerNorm)", "ln_row_|ln_fold"),
    ("K5 (flash attention)", "flash_attention_fwd"),
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
    ("dtype/layout copies", "copy|Copy|cast"),
    ("reductions", "reduce|Reduce|softmax|Softmax"),
    ("elementwise", "elementwise|Elementwise|vectorized"),
)
FFN = "kernel B and K2 (fused FFN GEMMs)"
ATTENTION = ("K5 (flash attention)",
             "K5 backward (delta, dq, dk/dv, dbias fold)",
             "kernel A (block attention)", "K3 (block attention backward)")


def group_of(name: str) -> str:
    return next((g for g, pat in GROUPS if re.search(pat, name)), "other")


def group_seconds(kernels: Iterable[Sequence]) -> Dict[str, float]:
    """Device seconds by group of ``(name, start_s, seconds)`` records."""
    out: Dict[str, float] = {}
    for name, _, dur in kernels:
        g = group_of(name)
        out[g] = out.get(g, 0.0) + dur
    return out
