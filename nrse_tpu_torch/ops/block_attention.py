"""Block gated attention for short sequences (kernel A and K3's wrapper).

Port of ``nrse_tpu/ops/block_attention.py:339-577``: the same signature and
``[B, H, T, D]`` layout, consuming the dense ``[H, T, T]`` position bias,
with optional dropout of the output inside the kernel.  Kernel A takes one
pass on wgmma fed by TMA while ``T`` pads to at most 256 frames (every main
path: 5 s clips are 249 frames) and two passes on mma.sync above that
(:func:`attention_fwd_plan`).
:func:`block_gated_attention` is a ``torch.autograd.Function``: its
forward is kernel A (``csrc/block_attention_fwd.cu``), which saves the
output after dropout and the per-row ``lse``; its backward is K3
(``csrc/block_attention_bwd.cu``: a pre-pass forms ``do'`` and ``delta``,
then two wgmma kernels while ``T`` pads to at most 256 frames, two
mma.sync kernels above, :func:`attention_bwd_plan`), which recomputes the
scores and probabilities from them and regenerates the keep mask from the
seed, so no ``[B, H, T, T]`` tensor and no mask is kept.  A CPU tensor
goes to the plain versions in ``ops.attention`` instead; there is no
fallback from one to the other.

Dropout comes either from a seed pair (the mask is K1's at the same seed
over the merged ``[B, T, C]`` layout, ``ops.attention.attention_keep_mask``)
or from an explicit float32 ``{0, 1/(1−p)}`` ``[B, H, T, D]`` mask (the
tests' path).  The counterpart of the TPU module's mask dump
(``dump_block_masks``) is therefore K1's ``dump_dropout_mask`` over ``[B,
T, C]``.

The block attention takes T ≤ ``MAX_T`` = 384 frames (≈ 7.7 s of audio),
as the TPU kernels do: the model sends longer sequences to the flash
attention (``ops.flash_attention``, K5), and both paths here raise for
them, so the CPU tests see the card's contract.  The raw CUDA entries refuse inputs that require grad under
autograd (``ops/_guard.py``); the Function calls them with grad mode off.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nrse_tpu_torch.ops import philox
from nrse_tpu_torch.ops._guard import require_no_grad
from nrse_tpu_torch.ops.attention import (
    attention_keep_mask,
    gated_bias_attention_bwd,
    gated_bias_attention_fwd,
    mask_add,
)
from nrse_tpu_torch.runtime import cuda_build

MAX_T = 384
HEAD_DIM = 64
# kernel A's routes (csrc/block_attention_fwd.cu): query and key tiles of
# 64, the one-pass wgmma route up to WGMMA_MAX_T_PAD keys
TILE = 64
WGMMA_MAX_T_PAD = 256
SM_SMEM = 233472  # an H100 SM's shared memory
# K3's wgmma route sums gate·ds over groups of at least DBIAS_MIN_GROUP
# batches, one dbias partial a group, with two dq blocks an SM
DBIAS_MIN_GROUP = 4

# Kernel launches made by this wrapper since the counts were last reset:
# kernel A (forward) and K3 (backward).
LAUNCHES = 0
BWD_LAUNCHES = 0

_MODE_NONE, _MODE_SEEDED, _MODE_MASKED = 0, 1, 2


class _Drop:
    """How the output is dropped: not at all, from a seed pair under
    probability ``p`` (over the merged layout's ``window``, ``(C_global,
    c0)``, when the heads are a shard of a layer's), or by an explicit
    mask."""

    def __init__(self, seed=None, p: float = 0.0, mask=None, window=None):
        self.seed = seed  # a seed tensor (ops/philox.py), read on the device
        self.p, self.mask = float(p), mask
        self.window = window

    @property
    def mode(self) -> int:
        if self.mask is not None:
            return _MODE_MASKED
        return _MODE_SEEDED if self.p > 0.0 else _MODE_NONE

    def plain_mask(self, shape, device) -> Optional[torch.Tensor]:
        """The keep mask as a tensor, for the plain versions."""
        if self.mode == _MODE_SEEDED:
            return attention_keep_mask(philox.seed_pair(self.seed), shape,
                                       self.p, device, self.window)
        return self.mask

    def c_args(self, shape, device):
        """``(mask pointer, seed pointer, p, keep scale, mode, C_global,
        c0)`` for a C entry; keeps the explicit mask it hands over alive on
        ``self``."""
        seed = 0
        if self.mode == _MODE_SEEDED:
            philox.check_seed(self.seed, device)
            seed = self.seed.data_ptr()
        ptr = 0
        if self.mode == _MODE_MASKED:
            m = self.mask
            if tuple(m.shape) != tuple(shape) or m.device != device:
                raise ValueError(f"the dropout mask must be {tuple(shape)} on "
                                 f"{device}, got {tuple(m.shape)} on "
                                 f"{m.device}")
            self._cmask = m.to(torch.float32).contiguous()
            ptr = self._cmask.data_ptr()
        scale = philox.keep_scale(self.p) if self.mode == _MODE_SEEDED else 1.0
        _, h, _, d = shape
        cg, c0 = self.window or (h * d, 0)
        return ptr, seed, self.p, scale, self.mode, cg, c0


def attention_fwd_plan(t: int) -> dict:
    """What kernel A (``csrc/block_attention_fwd.cu``) does for ``t``
    frames: the route (``"wgmma"``, one pass over the whole head's keys
    by TMA and wgmma, while ``T_pad = 64·⌈t/64⌉ ≤ 256``; else
    ``"two_pass"``, mma.sync over 64-key tiles), the query tiles (blocks
    per (b, h)), the dynamic shared memory of a block, and the blocks its
    launch bounds ask to share an SM (whose 228 KB, 1 KB reserved per
    block, must hold them).  The kernel needs no scratch."""
    t_pad = TILE * -(-t // TILE)
    if t_pad <= WGMMA_MAX_T_PAD:
        # alignment slack, Q's 64-row tile, K and V of 256 rows (64 bf16 a
        # row), the key mask (f32) and one mbarrier
        route = "wgmma"
        smem = 1024 + 2 * HEAD_DIM * (TILE + 2 * WGMMA_MAX_T_PAD) \
            + 4 * WGMMA_MAX_T_PAD + 8
    else:
        # padded bf16 Q, K and V tiles (rows of 72), the f32 bias tile
        # (rows of 68) and the key mask tile
        route = "two_pass"
        smem = 2 * 3 * TILE * (HEAD_DIM + 8) + 4 * TILE * (TILE + 4) \
            + 4 * TILE
    return {"route": route, "t_pad": t_pad, "query_tiles": t_pad // TILE,
            "smem": smem, "blocks_per_sm": 2 if route == "wgmma" else 1}


def dbias_group(b: int, h: int, t: int, sms: int) -> int:
    """The batches of one of K3's dbias partials on a card of ``sms`` SMs:
    on its wgmma route (``T_pad = 64·⌈t/64⌉ ≤ 256``) the fewest, at least
    :data:`DBIAS_MIN_GROUP`, whose dq blocks (one a query tile, head and
    group, each walking its group's batches in turn, two an SM) fit the
    card in one wave; on the mma.sync route one (a partial a batch)."""
    tiles = -(-t // TILE)
    if TILE * tiles > WGMMA_MAX_T_PAD:
        return 1
    g = DBIAS_MIN_GROUP
    while g < b and tiles * h * -(-b // g) > 2 * sms:
        g += 1
    return g


def attention_bwd_plan(b: int, h: int, t: int, sms: int) -> dict:
    """What K3 (``csrc/block_attention_bwd.cu``) does for ``b`` batches,
    ``h`` heads and ``t`` frames on a card of ``sms`` SMs: the route
    (``"wgmma"`` while ``T_pad = 64·⌈t/64⌉ ≤ 256``, else ``"mma_sync"``),
    the 64-row tiles, the batches of a dbias partial (:func:`dbias_group`),
    the slices of f32 ``[h, t, t]`` partials the wrapper allocates (one a
    group on the wgmma route, none for one group; one a batch on the
    mma.sync route) and the blocks of its kernels: the wgmma route's dq
    kernel (a block per query tile, head and group) and dk/dv kernel (a
    block per key tile, batch and head), with their dynamic shared memory,
    two blocks an SM.  Both routes take the pre-pass's ``do'`` (bf16
    ``[b, h, t, 64]``) and ``delta`` (f32 ``[b, h, t]``)."""
    t_pad = TILE * -(-t // TILE)
    tiles = t_pad // TILE
    group = dbias_group(b, h, t, sms)
    if t_pad <= WGMMA_MAX_T_PAD:
        groups = -(-b // group)
        slices = groups if groups > 1 else 0
        tile_b, head_b = 2 * TILE * HEAD_DIM, 2 * WGMMA_MAX_T_PAD * HEAD_DIM
        # alignment slack, two 64-row and two 256-row bf16 tiles, f32
        # vectors of 256 (one, or three), the dq kernel's f32 gate·ds
        # stage tile (rows of 72), one mbarrier
        return {"route": "wgmma", "t_pad": t_pad, "tiles": tiles,
                "group": group, "groups": groups,
                "partial": slices * h * t * t,
                "dq_blocks": tiles * h * groups, "dkdv_blocks": tiles * b * h,
                "dq_smem": 1024 + 2 * tile_b + 2 * head_b
                + 4 * WGMMA_MAX_T_PAD + 4 * TILE * (TILE + 8) + 8,
                "dkdv_smem": 1024 + 2 * tile_b + 2 * head_b
                + 12 * WGMMA_MAX_T_PAD + 8,
                "blocks_per_sm": 2}
    return {"route": "mma_sync", "t_pad": t_pad, "tiles": tiles,
            "group": group, "groups": b, "partial": b * h * t * t,
            "dq_blocks": tiles * b * h, "dkdv_blocks": tiles * b * h,
            "blocks_per_sm": 1}


def _check_inputs(q, k, v, gate, pos_bias, key_padding_mask):
    b, h, t, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} "
                         f"{v.shape}")
    if gate.shape != (b, h, t):
        raise ValueError(f"gate must be [B,H,T]=({b},{h},{t}), got "
                         f"{tuple(gate.shape)}")
    if pos_bias.shape != (h, t, t):
        raise ValueError(f"pos_bias must be dense [H,T,T]=({h},{t},{t}), "
                         f"got {tuple(pos_bias.shape)}")
    if key_padding_mask is not None and key_padding_mask.shape != (b, t):
        raise ValueError(f"key_padding_mask must be [B,T]=({b},{t}), got "
                         f"{tuple(key_padding_mask.shape)}")
    if t > MAX_T:
        raise ValueError(
            f"T={t} frames exceeds the block kernel's limit of {MAX_T}; "
            "longer sequences go to ops.flash_attention (K5)")


def _check_cuda(q, k, v, *others):
    d = q.shape[-1]
    if d != HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head_dim {HEAD_DIM}, got {d}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"the CUDA kernel takes bf16 q/k/v, got {q.dtype}")
    if any(x.device != q.device for x in (k, v, *others)):
        raise ValueError("the attention's tensors must share a device")


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def _kernel_fwd(q, k, v, gate, pos_bias, key_padding_mask, drop=None):
    """Kernel A: ``(out, lse)``; ``drop`` a :class:`_Drop` (none if
    omitted)."""
    require_no_grad(q, k, v, gate, pos_bias,
                    what="block_attention_fwd (the raw kernel A entry; "
                         "gradients go through block_gated_attention, whose "
                         "backward is K3)")
    drop = drop or _Drop()
    _check_cuda(q, k, v, gate, pos_bias)
    b, h, t, d = q.shape
    q, k, v = (x.contiguous() for x in (q, k, v))
    madd = mask_add(key_padding_mask, b, t, q.device).contiguous()
    return _launch_fwd(q, k, v, _f32(gate), _f32(pos_bias), madd, drop)


def _launch_fwd(q, k, v, gate, bias, madd, drop):
    b, h, t, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    lib = cuda_build.load()
    with torch.cuda.device(q.device):  # the launch goes to the current card
        err = lib.nrse_block_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), gate.data_ptr(),
            bias.data_ptr(), madd.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *drop.c_args(q.shape, q.device), b, h, t, d,
            1.0 / d ** 0.5, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "block_attention_fwd")
    global LAUNCHES
    LAUNCHES += 1
    return out, lse


def _kernel_bwd(q, k, v, gate, bias, madd, out, lse, do, drop):
    """K3: ``(dq, dk, dv, dgate, dbias)`` from kernel A's saved tensors
    (q, k, v contiguous bf16; gate, bias, madd, lse float32)."""
    require_no_grad(q, k, v, gate, bias, do,
                    what="block_attention_bwd (the raw K3 entry; gradients "
                         "go through block_gated_attention)")
    _check_cuda(q, k, v, gate, bias, madd, out, lse, do)
    b, h, t, d = q.shape
    q, k, v = (x.contiguous() for x in (q, k, v))
    gate, bias, madd, lse = (_f32(x) for x in (gate, bias, madd, lse))
    do = do.to(q.dtype).contiguous()
    out = out.to(q.dtype).contiguous()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dgate = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    dbias = torch.empty(h, t, t, dtype=torch.float32, device=q.device)
    # the pre-pass's do' = do·keep and delta = rowsum(do ⊙ out), and the
    # dbias partials the kernels sum in a fixed order
    dop = torch.empty_like(q)
    delta = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    plan = attention_bwd_plan(b, h, t, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    partial = (torch.empty(plan["partial"], dtype=torch.float32,
                           device=q.device) if plan["partial"] else None)
    lib = cuda_build.load()
    with torch.cuda.device(q.device):
        err = lib.nrse_block_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), gate.data_ptr(),
            bias.data_ptr(), madd.data_ptr(), do.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *drop.c_args(q.shape, q.device),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dgate.data_ptr(),
            dbias.data_ptr(), dop.data_ptr(), delta.data_ptr(),
            0 if partial is None else partial.data_ptr(), plan["group"],
            b, h, t, d,
            1.0 / d ** 0.5, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "block_attention_bwd")
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return dq, dk, dv, dgate, dbias


class _BlockAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, gate, pos_bias, madd, drop):
        ctx.dtypes = (gate.dtype, pos_bias.dtype)
        gate, bias = _f32(gate), _f32(pos_bias)
        if q.device.type == "cuda":
            _check_cuda(q, k, v, gate, bias, madd)
            q, k, v = (x.contiguous() for x in (q, k, v))
            out, lse = _launch_fwd(q, k, v, gate, bias, madd, drop)
        else:
            out, lse = gated_bias_attention_fwd(
                q, k, v, gate, bias, madd, drop.plain_mask(q.shape, q.device))
        ctx.drop = drop
        ctx.save_for_backward(q, k, v, gate, bias, madd, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, gate, bias, madd, out, lse = ctx.saved_tensors
        drop = ctx.drop
        if q.device.type == "cuda":
            grads = _kernel_bwd(q, k, v, gate, bias, madd, out, lse, do,
                                drop)
        else:
            grads = gated_bias_attention_bwd(
                q, k, v, gate, bias, madd, out, lse, do,
                drop.plain_mask(q.shape, q.device))
        dq, dk, dv, dgate, dbias = grads
        gate_dtype, bias_dtype = ctx.dtypes
        return (dq, dk, dv, dgate.to(gate_dtype), dbias.to(bias_dtype),
                None, None)


def block_gated_attention_lse(q, k, v, gate, pos_bias,
                              key_padding_mask: Optional[torch.Tensor] = None,
                              *, p_drop: float = 0.0,
                              dropout_seed: Optional[torch.Tensor] = None,
                              dropout_mask: Optional[torch.Tensor] = None,
                              dropout_window: Optional[Tuple[int, int]] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B, H, T, D], lse [B, H, T] float32)``; see
    :func:`block_gated_attention`.  ``out`` is differentiable; ``lse`` is
    the softmax's log-sum-exp (without dropout) and is not."""
    _check_inputs(q, k, v, gate, pos_bias, key_padding_mask)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no block attention for device {q.device}")
    if dropout_mask is not None:
        drop = _Drop(mask=dropout_mask)
    elif p_drop > 0.0:
        if not p_drop < 1.0:
            raise ValueError(f"dropout probability must be in [0, 1), got "
                             f"{p_drop}")
        if dropout_seed is None:
            raise ValueError("p_drop > 0 requires dropout_seed")
        philox.check_seed(dropout_seed, q.device)
        _, h, _, d = q.shape
        drop = _Drop(seed=dropout_seed, p=p_drop,
                     window=philox.check_window(dropout_window, h * d))
    else:
        drop = _Drop()
    b, _, t, _ = q.shape
    madd = mask_add(key_padding_mask, b, t, q.device).contiguous()
    return _BlockAttention.apply(q, k, v, gate, pos_bias, madd, drop)


def block_gated_attention(q, k, v, gate, pos_bias,
                          key_padding_mask: Optional[torch.Tensor] = None,
                          *, p_drop: float = 0.0,
                          dropout_seed: Optional[torch.Tensor] = None,
                          dropout_mask: Optional[torch.Tensor] = None,
                          dropout_window: Optional[Tuple[int, int]] = None):
    """Gated-bias attention at T ≤ 384, differentiable.

    Args:
      q, k, v: ``[B, H, T, D]``; on the card bf16 with D = 64.
      gate: ``[B, H, T]`` per-query bias gate.
      pos_bias: dense ``[H, T, T]`` (``rel_pos_bias.compute_position_bias``).
      key_padding_mask: optional ``[B, T]`` (1 = valid key).
      p_drop / dropout_seed: dropout of the output inside the kernel, the
        mask drawn from Philox under the seed pair the 2-element int32
        ``dropout_seed`` on q's device holds (``ops/philox.py``; K1's mask
        over the merged ``[B, T, C]`` layout), read by the kernels when they
        run, and drawn again in the backward.
      dropout_mask: an explicit float32 ``{0, 1/(1−p)}`` ``[B, H, T, D]``
        keep mask instead (the tests' path).
      dropout_window: ``(C_global, c0)`` when the H heads are a shard of
        a layer's (tensor parallelism): they are the merged columns from
        ``c0`` (``h0·D``) of that layer's ``[B, T, C_global]``, whose mask
        they draw the slice of (K3 draws it again).
    Returns ``[B, H, T, D]`` in v's dtype.
    """
    return block_gated_attention_lse(
        q, k, v, gate, pos_bias, key_padding_mask, p_drop=p_drop,
        dropout_seed=dropout_seed, dropout_mask=dropout_mask,
        dropout_window=dropout_window)[0]
