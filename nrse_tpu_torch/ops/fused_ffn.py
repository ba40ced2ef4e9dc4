"""Fused transformer FFN: kernel B's forward and K2's backward.

Port of ``nrse_tpu/ops/fused_ffn.py:110-518`` and ``dump_masks`` (:527):
``dense → exact-erf GELU → activation dropout → cast to the working dtype
→ dense → hidden dropout``.  The weights stay in torch's ``[out, in]``
layout (``nn.Linear.weight``): ``w1 [F, C]``, ``w2 [C, F]``.

Which kernel runs where:
  * serving (and any call that needs no gradient, such as the BYOL target
    tower): kernel B alone (``csrc/fused_ffn_fwd.cu``: two wgmma products
    fed by TMA, ``csrc/wgmma_gemm.cuh``, see :func:`ffn_fwd_plan`), with
    the dropout sites when ``p > 0`` and nothing saved;
  * training: :class:`FusedFFN`, whose forward is kernel B's training
    entry (both dropout sites, ``h1`` and the dropped GELU output ``gd``
    kept in bf16) and whose backward is K2 (``csrc/fused_ffn_bwd.cu``):
    the dx kernel (dx, db1, db2; its two products on wgmma fed by TMA,
    ``csrc/wgmma_gemm.cuh``, the weights cast and transposed by the
    kernel into scratch the wrapper allocates, see :func:`dx_plan`) and
    the dW kernel (dW1, dW2: both products in one launch of the same
    GEMM, its operands read MN-major, see :func:`dw_plan`).

Masks follow the Philox contract of ``ops/philox.py``: site 0 is the
activation site over ``[N, F]``, site 1 the hidden site over ``[N, C]``,
both under one seed pair.

Tensor parallelism splits the FFN by its F columns: a rank holds ``w1``'s
rows and ``b1``'s entries ``[f0, f0 + F)`` of ``F_global`` and ``w2``'s
columns of them (``shard = (F_global, f0)``).  Its output is then its
partial sum over its columns, in float32, which the caller sums across
the ranks and rounds once, as the whole layer's product is rounded once.
The activation site draws its slice of the whole layer's ``[N,
F_global]`` mask; the hidden site, over the output, draws the whole ``[N,
C]`` mask on every rank, which distributes over the sum (dropout is
linear in its input under one mask); ``b2`` is in the partial of the
shard at ``f0 = 0`` only, so that the sum holds it once, while its
gradient (the column sums of the masked output gradient) is returned on
every rank alike.  :func:`fused_ffn_masked` takes explicit float32
masks instead (the tests' path).  A CUDA tensor goes to the kernels; a CPU
tensor goes to :func:`ffn_plain_fwd` / :func:`ffn_plain_bwd`, whose masks
come from the Philox twin.  There is no fallback from one to the other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from nrse_tpu_torch.ops import fused_dropout, philox
from nrse_tpu_torch.ops._guard import require_no_grad
from nrse_tpu_torch.runtime import cuda_build

# the CUDA kernels' tile: C and F must be multiples of this; the row tile
# of the wgmma products of kernel B and K2's dx kernel (csrc/wgmma_gemm.cuh
# kBM)
TILE = 128
# csrc/wgmma_gemm.cuh: ring stages of 32 KB (two 128 x 64 bf16 tiles), 6
# of them, or 4 beside a 32 KB side tile per consumer warpgroup (kernel B's
# GEMM1 stages h there for its TMA store), and the keep-bit words a
# consumer thread gets from the producer's spare warps (kKeepAuxWords)
GEMM_STAGES, GEMM_STAGES_SIDE = 6, 4
GEMM_STAGE_BYTES = 2 * TILE * 64 * 2
GEMM_SIDE_BYTES = TILE * TILE * 2
GEMM_CONSUMERS = 2
KEEP_AUX_WORDS = 4
# shared memory a block may use on the H100 (sm_90)
SMEM_LIMIT = 232448
# rows per partial column sum of dh2 in K2's dx kernel (csrc kDh2Rows)
DH2_ROWS = 16
SITE_ACT, SITE_HID = 0, 1

# Kernel launches made by this module since the counts were last reset:
# kernel B (forward), K2's dx kernel, K2's dW kernel.
LAUNCHES = 0
DX_LAUNCHES = 0
DW_LAUNCHES = 0

_NO_DROP, _PHILOX, _MASKS = 0, 1, 2


def gelu_grad(h: torch.Tensor) -> torch.Tensor:
    """GELU′(h) = Φ(h) + h·φ(h), exact erf."""
    cdf = 0.5 * (1.0 + torch.erf(h * 0.7071067811865476))
    return cdf + h * torch.exp(-0.5 * h * h) * 0.3989422804014327


def ffn_plain_fwd(x, w1, b1, w2, b2, keep_act=None, keep_hid=None,
                  out_dtype=None):
    """Plain PyTorch forward of ``x [N, C]``: products of the
    working-dtype operands accumulated in float32, bias, GELU and masks on
    the float32 sum, the GELU output rounded to x's dtype before the second
    product.  Returns ``(out, h1, gd)``: ``out`` in ``out_dtype`` (x's
    dtype unless given), ``h1`` the pre-GELU activation and ``gd`` the
    dropped GELU output, both rounded to x's dtype."""
    dt = x.dtype
    h1 = torch.matmul(x.float(), w1.to(dt).float().t()) + b1.float()
    g = F.gelu(h1, approximate="none")
    if keep_act is not None:
        g = g * keep_act
    gd = g.to(dt)
    o = torch.matmul(gd.float(), w2.to(dt).float().t()) + b2.float()
    if keep_hid is not None:
        o = o * keep_hid
    return o.to(out_dtype or dt), h1.to(dt), gd


def ffn_plain(x, w1, b1, w2, b2):
    """The deterministic plain forward (no dropout)."""
    return ffn_plain_fwd(x, w1, b1, w2, b2)[0]


def ffn_plain_bwd_dx(dout, h1, w1, w2, keep_act=None, keep_hid=None):
    """Plain PyTorch version of K2's dx kernel: ``(dx, db1, db2, dh1,
    dh2)``, dx, dh1 and dh2 in dout's dtype, db1 and db2 float32."""
    dt = dout.dtype
    dh2 = dout.float()
    if keep_hid is not None:
        dh2 = dh2 * keep_hid
    db2 = dh2.sum(0)
    dh2 = dh2.to(dt)
    dgd = torch.matmul(dh2.float(), w2.to(dt).float())
    if keep_act is not None:
        dgd = dgd * keep_act
    dh1 = dgd * gelu_grad(h1.float())
    db1 = dh1.sum(0)
    dh1 = dh1.to(dt)
    dx = torch.matmul(dh1.float(), w1.to(dt).float()).to(dt)
    return dx, db1, db2, dh1, dh2


def ffn_plain_bwd_dw(x, gd, dh1, dh2):
    """Plain PyTorch version of K2's dW kernel: ``(dw1 [F, C], dw2
    [C, F])`` in float32."""
    return (torch.matmul(dh1.float().t(), x.float()),
            torch.matmul(dh2.float().t(), gd.float()))


def ffn_plain_bwd(dout, x, h1, gd, w1, w2, keep_act=None, keep_hid=None):
    """Plain PyTorch backward, the arithmetic of K2: returns ``(dx, dw1,
    db1, dw2, db2)``, dx in x's dtype and the rest float32."""
    dx, db1, db2, dh1, dh2 = ffn_plain_bwd_dx(dout.to(x.dtype), h1, w1, w2,
                                              keep_act, keep_hid)
    dw1, dw2 = ffn_plain_bwd_dw(x, gd, dh1, dh2)
    return dx, dw1, db1, dw2, db2


class _Drop:
    """How one call gets its masks: none, Philox under a seed, or
    explicit masks."""

    def __init__(self, seed=None, p_act=0.0, p_hid=0.0, masks=None,
                 act_window=None):
        self.seed = seed  # a seed tensor (ops/philox.py), read on the device
        self.p_act, self.p_hid = float(p_act), float(p_hid)
        self.masks = masks
        self.act_window = act_window  # (F_global, f0) of a column shard
        if masks is not None:
            self.mode = _MASKS
        elif self.p_act > 0.0 or self.p_hid > 0.0:
            if seed is None:
                raise ValueError("dropout with p > 0 needs a seed")
            self.mode = _PHILOX
        else:
            self.mode = _NO_DROP

    def plain_masks(self, n, c, f, device):
        """``(keep_act [n, f] | None, keep_hid [n, c] | None)``."""
        if self.mode == _MASKS:
            return self.masks
        act = hid = None
        if self.mode == _PHILOX:
            pair = philox.seed_pair(self.seed)
            if self.p_act > 0.0:
                act = philox.dump_mask(pair, SITE_ACT, (n, f), self.p_act,
                                       device, self.act_window)
            if self.p_hid > 0.0:
                hid = philox.dump_mask(pair, SITE_HID, (n, c), self.p_hid,
                                       device)
        return act, hid

    def kernel_args(self, f: int):
        """The C entries' dropout arguments for ``f`` local columns: the
        masks, the seed tensor's pointer, the probabilities and keep
        scales, the mode and the activation site's window ``(F_global,
        f0)``."""
        ma = mh = 0
        if self.mode == _MASKS:
            ma, mh = (m.data_ptr() for m in self.masks)
        seed = 0 if self.mode != _PHILOX else self.seed.data_ptr()
        f_global, f0 = self.act_window or (f, 0)
        return (ma, mh, seed, self.p_act, self.p_hid,
                philox.keep_scale(self.p_act), philox.keep_scale(self.p_hid),
                self.mode, f_global, f0)


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _check_kernel(rows, w1, w2, b1, b2):
    n, c = rows.shape
    f = w1.shape[0]
    if rows.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16 activations, got "
                        f"{rows.dtype}")
    if c % TILE or f % TILE:
        raise ValueError(f"the CUDA kernel takes C and F that are multiples "
                         f"of {TILE}, got C={c} F={f}")
    if any(t.device != rows.device for t in (w1, b1, w2, b2)):
        raise ValueError("x and the FFN weights must share a device")
    return n, c, f


def _bf16(t):
    t = t.to(torch.bfloat16).contiguous()
    if t.data_ptr() % 16:
        raise ValueError("the CUDA kernel needs 16-byte aligned operands")
    return t


def _kernel_fwd(rows, w1, b1, w2, b2, drop: _Drop, save: bool,
                out_f32: bool = False):
    """Kernel B.  Returns ``(out, h1, gd)``; ``out`` float32 if
    ``out_f32``, else bf16; ``h1`` is None unless ``save``; ``gd`` is
    kernel B's h (the dropped GELU output)."""
    require_no_grad(rows, w1, b1, w2, b2, what="fused_ffn_fwd")
    n, c, f = _check_kernel(rows, w1, w2, b1, b2)
    rows, w1, w2 = _bf16(rows), _bf16(w1), _bf16(w2)
    b1 = b1.to(torch.float32).contiguous()
    b2 = b2.to(torch.float32).contiguous()
    train = save or drop.mode != _NO_DROP
    gd = torch.empty(ffn_fwd_plan(n, c, f, train)["h"], dtype=torch.bfloat16,
                     device=rows.device).view(n, f)
    h1 = torch.empty_like(gd) if save else None
    out = torch.empty(n, c, dtype=torch.float32 if out_f32 else rows.dtype,
                      device=rows.device)
    lib = cuda_build.load()
    with cuda_build.on_device(rows.device):  # launch on x's card
        if not train:
            err = lib.nrse_fused_ffn_fwd(
                rows.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), gd.data_ptr(), out.data_ptr(), int(out_f32),
                n, c, f, _stream())
        else:
            err = lib.nrse_fused_ffn_fwd_train(
                rows.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), gd.data_ptr(),
                0 if h1 is None else h1.data_ptr(), out.data_ptr(),
                int(out_f32), *drop.kernel_args(f), n, c, f, _stream())
    cuda_build.check(err, "fused_ffn_fwd")
    global LAUNCHES
    LAUNCHES += 1
    return out, h1, gd


def gemm_smem(side: bool, aux_words: int) -> int:
    """Dynamic shared memory of one block of ``csrc/wgmma_gemm.cuh``'s
    GEMM without f32 scratch: alignment slack, the ring, the side tiles
    (``side``), the mbarriers (two a stage, five a consumer) and each
    consumer's aux words."""
    stages = GEMM_STAGES_SIDE if side else GEMM_STAGES
    return (1024 + stages * GEMM_STAGE_BYTES
            + (GEMM_CONSUMERS * GEMM_SIDE_BYTES if side else 0)
            + 8 * (2 * stages + 5 * GEMM_CONSUMERS)
            + GEMM_CONSUMERS * 128 * 4 * aux_words)


def ffn_fwd_plan(n: int, c: int, f: int, train: bool = False) -> dict:
    """What kernel B (``csrc/fused_ffn_fwd.cu``) works on for ``n`` rows:
    the 128-row tiles, the 128 x 128 output tiles of GEMM1 (``x · W1ᵀ``,
    [n, f], h staged in a side tile) and GEMM2 (``h · W2ᵀ``, [n, c]), each
    GEMM's shared memory (the training entry's epilogues get the keep bits
    as aux words, the serving entry's none), and the bf16 elements of h,
    the scratch between them."""
    row_tiles = -(-n // TILE)
    aux = KEEP_AUX_WORDS if train else 0
    return {"row_tiles": row_tiles,
            "gemm1_tiles": row_tiles * (f // TILE),
            "gemm2_tiles": row_tiles * (c // TILE),
            "gemm1_smem": gemm_smem(True, aux),
            "gemm2_smem": gemm_smem(False, aux),
            "h": n * f}


def dx_plan(n: int, c: int, f: int) -> dict:
    """What K2's dx kernel (``csrc/fused_ffn_bwd.cu``) works on for ``n``
    rows: the dh2 pass's row chunks, the 128-row tiles of the two wgmma
    products and their tile counts (128 x 128 output tiles), and the f32
    scratch the wrapper allocates (the dh2 partials, then reused for
    dh1's, one per chunk or tile and column)."""
    chunks = -(-n // DH2_ROWS)
    row_tiles = -(-n // TILE)
    return {"dh2_chunks": chunks, "row_tiles": row_tiles,
            "dgd_tiles": row_tiles * (f // TILE),
            "dx_tiles": row_tiles * (c // TILE),
            "scratch": max(chunks * c, row_tiles * f)}


def dw_plan(n: int, c: int, f: int, sms: int) -> dict:
    """What K2's dW kernel (``csrc/fused_ffn_bwd.cu``) works on for ``n``
    rows on a card of ``sms`` SMs: the 64-row K-tiles each output tile's
    main loop walks (the last one ragged, zero-filled by TMA), the 128 x
    128 output tiles of dW1 ``[f, c]`` and dW2 ``[c, f]`` in one launch,
    and the persistent blocks the wrapper launches (one an SM, at most the
    tiles), each taking every ``blocks``-th tile.  It needs no scratch."""
    tiles = 2 * (f // TILE) * (c // TILE)
    return {"k_tiles": -(-n // 64), "dw1_tiles": (f // TILE) * (c // TILE),
            "tiles": tiles, "blocks": min(tiles, sms)}


def _weight(w):
    """A weight as the dx kernel reads it: float32, contiguous, 16-byte
    aligned (the kernel casts it to bf16 and transposes it itself)."""
    w = w.float().contiguous()
    if w.data_ptr() % 16:
        raise ValueError("the CUDA kernel needs 16-byte aligned operands")
    return w


def _kernel_bwd_dx(dout, h1, w1, w2, drop: _Drop):
    """K2's dx kernel: ``(dx, db1, db2, dh1, dh2)``."""
    dout, h1 = _bf16(dout), _bf16(h1)
    w1, w2 = _weight(w1), _weight(w2)
    n, c = dout.shape
    f = w1.shape[0]
    dev = dout.device
    # the weights cast to bf16 and transposed, by the kernel
    w1t = torch.empty(c, f, dtype=torch.bfloat16, device=dev)
    w2t = torch.empty(f, c, dtype=torch.bfloat16, device=dev)
    dh2 = torch.empty(n, c, dtype=torch.bfloat16, device=dev)
    dh1 = torch.empty(n, f, dtype=torch.bfloat16, device=dev)
    dx = torch.empty_like(dh2)
    db1 = torch.empty(f, dtype=torch.float32, device=dev)
    db2 = torch.empty(c, dtype=torch.float32, device=dev)
    part = torch.empty(dx_plan(n, c, f)["scratch"], dtype=torch.float32,
                       device=dev)
    lib = cuda_build.load()
    with cuda_build.on_device(dev):
        err = lib.nrse_fused_ffn_bwd_dx(
            dout.data_ptr(), h1.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            w1t.data_ptr(), w2t.data_ptr(),
            *drop.kernel_args(f), dh2.data_ptr(), dh1.data_ptr(),
            dx.data_ptr(), db1.data_ptr(), db2.data_ptr(), part.data_ptr(),
            n, c, f, _stream())
    cuda_build.check(err, "fused_ffn_bwd_dx")
    global DX_LAUNCHES
    DX_LAUNCHES += 1
    return dx, db1, db2, dh1, dh2


def _kernel_bwd_dw(x, gd, dh1, dh2):
    """K2's dW kernel: ``(dw1 [F, C], dw2 [C, F])`` float32."""
    x, gd, dh1, dh2 = (_bf16(t) for t in (x, gd, dh1, dh2))
    n, c = x.shape
    f = gd.shape[1]
    dw1 = torch.empty(f, c, dtype=torch.float32, device=x.device)
    dw2 = torch.empty(c, f, dtype=torch.float32, device=x.device)
    plan = dw_plan(n, c, f, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    lib = cuda_build.load()
    with cuda_build.on_device(x.device):
        err = lib.nrse_fused_ffn_bwd_dw(
            x.data_ptr(), gd.data_ptr(), dh1.data_ptr(), dh2.data_ptr(),
            dw1.data_ptr(), dw2.data_ptr(), n, c, f, plan["blocks"],
            _stream())
    cuda_build.check(err, "fused_ffn_bwd_dw")
    global DW_LAUNCHES
    DW_LAUNCHES += 1
    return dw1, dw2


def _forward(rows, w1, b1, w2, b2, drop: _Drop, save: bool, shard=None):
    """``(out, h1, gd)``; for a ``shard`` the partial sum in float32, b2
    in it only at ``f0 = 0``."""
    if shard is not None and shard[1] != 0:
        b2 = torch.zeros_like(b2)
    if rows.device.type == "cuda":
        return _kernel_fwd(rows, w1, b1, w2, b2, drop, save,
                           out_f32=shard is not None)
    if rows.device.type != "cpu":
        raise ValueError(f"no fused FFN for device {rows.device}")
    n, c = rows.shape
    act, hid = drop.plain_masks(n, c, w1.shape[0], rows.device)
    return ffn_plain_fwd(rows, w1, b1, w2, b2, act, hid,
                         torch.float32 if shard is not None else None)


class FusedFFN(torch.autograd.Function):
    """The FFN pair with its dropout sites; the backward is K2 on the card
    and :func:`ffn_plain_bwd` on the CPU.  Saves ``x``, ``h1`` and ``gd``
    (bf16 on the card) and the seed or masks, not the masks of a seed.  A
    ``shard`` (see the module docstring) returns its float32 partial sum,
    and b2 gets its gradient on every shard."""

    @staticmethod
    def forward(ctx, rows, w1, b1, w2, b2, drop, shard=None):
        out, h1, gd = _forward(rows, w1, b1, w2, b2, drop, save=True,
                               shard=shard)
        ctx.save_for_backward(rows, h1, gd, w1, w2)
        ctx.drop = drop
        ctx.dtypes = (w1.dtype, b1.dtype, w2.dtype, b2.dtype)
        return out

    @staticmethod
    def backward(ctx, dout):
        rows, h1, gd, w1, w2 = ctx.saved_tensors
        drop = ctx.drop
        if rows.device.type == "cuda":
            dx, db1, db2, dh1, dh2 = _kernel_bwd_dx(dout, h1, w1, w2, drop)
            dw1, dw2 = _kernel_bwd_dw(rows, gd, dh1, dh2)
        else:
            n, c = rows.shape
            act, hid = drop.plain_masks(n, c, w1.shape[0], rows.device)
            dx, dw1, db1, dw2, db2 = ffn_plain_bwd(dout, rows, h1, gd, w1,
                                                   w2, act, hid)
        t1, tb1, t2, tb2 = ctx.dtypes
        return (dx, dw1.to(t1), db1.to(tb1), dw2.to(t2), db2.to(tb2), None,
                None)


def _check_weights(x, w1, b1, w2, b2):
    c = x.shape[-1]
    f = w1.shape[0]
    if w1.shape != (f, c) or w2.shape != (c, f) or b1.shape != (f,) \
            or b2.shape != (c,):
        raise ValueError(
            f"FFN weights do not match x[..., {c}]: w1 {tuple(w1.shape)}, "
            f"b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}, "
            f"b2 {tuple(b2.shape)}")


def _apply(x, w1, b1, w2, b2, drop: _Drop, shard=None):
    _check_weights(x, w1, b1, w2, b2)
    rows = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        out = FusedFFN.apply(rows, w1, b1, w2, b2, drop, shard)
    else:
        out = _forward(rows, w1, b1, w2, b2, drop, save=False,
                       shard=shard)[0]
    return out.reshape(x.shape)


def fused_ffn(x, w1, b1, w2, b2, seed: Optional[torch.Tensor] = None,
              p_act: float = 0.0, p_hid: float = 0.0,
              shard: Optional[Tuple[int, int]] = None):
    """``dropout(dense2(dropout(gelu(dense1(x)))))`` for ``x [..., C]``,
    ``w1 [F, C]``, ``b1 [F]``, ``w2 [C, F]``, ``b2 [C]``; the masks from
    Philox under the pair the seed tensor ``seed`` (2 int32 words on x's
    device, ``ops/philox.py``) holds when the kernels run, when ``p_act``
    or ``p_hid`` is above 0.  Returns
    x's shape and dtype; differentiable in x and the weights.  With
    ``shard = (F_global, f0)`` the weights are the columns ``[f0, f0 + F)``
    of a layer ``F_global`` wide (tensor parallelism, see the module
    docstring), and the result is their float32 partial sum."""
    if shard is not None:
        shard = (int(shard[0]), int(shard[1]))
    window = None if shard is None else philox.check_window(shard,
                                                            w1.shape[0])
    if seed is not None:
        philox.check_seed(seed, x.device)
    return _apply(x, w1, b1, w2, b2,
                  _Drop(seed, p_act, p_hid, act_window=window), shard)


def fused_ffn_masked(x, w1, b1, w2, b2, mask_act, mask_hid):
    """:func:`fused_ffn` with explicit float32 ``{0, 1/(1−p)}`` masks,
    ``mask_act [..., F]`` and ``mask_hid [..., C]`` (the masks get no
    gradient)."""
    f, c = w1.shape
    n = x.numel() // c
    masks = (mask_act.reshape(-1, f).to(torch.float32).contiguous(),
             mask_hid.reshape(-1, c).to(torch.float32).contiguous())
    if masks[0].shape != (n, f) or masks[1].shape != (n, c) or any(
            m.device != x.device for m in masks):
        raise ValueError(f"masks must be [..., {f}] and [..., {c}] over x's "
                         f"{n} rows, on x's device")
    return _apply(x, w1, b1, w2, b2, _Drop(masks=masks))


def dump_masks(seed: torch.Tensor, n: int, c: int, f: int, p_act: float,
               p_hid: float, shard=None):
    """``(keep_act [n, f], keep_hid [n, c])``: the float32 masks
    :func:`fused_ffn` applies for this seed tensor, shape and ``shard``, on
    the seed's device (from the dump kernel on a CUDA device, from the
    Philox twin elsewhere)."""
    return (fused_dropout.dump_dropout_mask(seed, (n, f), p_act, SITE_ACT,
                                            shard),
            fused_dropout.dump_dropout_mask(seed, (n, c), p_hid, SITE_HID))
