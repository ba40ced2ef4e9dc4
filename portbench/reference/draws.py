"""The random draws of a training step, worked out from the seed alone.

A frozen copy of the dropout contract the port states (Philox4x32-10,
Salmon et al., SC'11): the mask of an element depends only on the seed
pair of its stream, its site and its flat index; one Philox draw serves
four consecutive elements; an element is kept when its word's top 24 bits
read at least ``p`` as a fraction of 2^24, and a kept value is scaled by
``1 / (1 - p)`` rounded in float32.  Each stream's seed pair is the first
two Philox words of the counter ``(step, tower, layer, site)`` under the
64-bit root seed.  The host draws (LayerDrop's keep list, SpecAugment's
spans, the SER head's dropout) come from CPU ``torch.Generator``s seeded
from the stream ``(step, tower, 0x10000 + stream)``.

Nothing here is imported from the program: the reference works every
draw out again from the run's seed.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF

# the dropout sites of a layer, and the encoder-level layer index
SITE_ATTN, SITE_HIDDEN, SITE_FFN = 0, 1, 2
ENCODER = 0xFFFF
# the FFN seed's two sites: the activation [N, F] and the output [N, C]
FFN_ACT, FFN_OUT = 0, 1
# host streams of a tower's step
STREAM_LAYERDROP, STREAM_SPEC_AUGMENT, STREAM_HEAD_DROPOUT = 0, 1, 2


def _mulhilo(a: int, b):
    lo_part = b * (a & 0xFFFF)
    hi_part = b * (a >> 16)
    lo = (lo_part + ((hi_part & 0xFFFF) << 16)) & MASK32
    hi = (hi_part + (lo_part >> 16)) >> 16
    return hi, lo


def philox4x32(k0: int, k1: int, c0, c1, c2, c3):
    """Philox4x32-10 of the counter under the key (ints or int64 tensors
    holding 32-bit values)."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + W0) & MASK32
        k1 = (k1 + W1) & MASK32
    return c0, c1, c2, c3


def stream_seed(root: int, *ids: int) -> Tuple[int, int]:
    c = [int(i) & MASK32 for i in ids] + [0] * (4 - len(ids))
    out = philox4x32(root & MASK32, (root >> 32) & MASK32, *c)
    return int(out[0]), int(out[1])


def keep_scale(p: float) -> float:
    return float(np.float32(1.0) / (np.float32(1.0) - np.float32(p)))


def dropout_mask(pair: Tuple[int, int], site: int, shape, p: float,
                 device) -> torch.Tensor:
    """The float32 ``{0, 1/(1-p)}`` mask of a tensor of ``shape`` over its
    flat element index."""
    n = int(np.prod(shape))
    g = torch.arange((n + 3) >> 2, dtype=torch.int64, device=device)
    words = philox4x32(pair[0], pair[1], g & MASK32, g >> 32,
                       torch.full_like(g, site), torch.zeros_like(g))
    bits = torch.stack(words, dim=-1).reshape(-1)[:n]
    u = (bits >> 8).to(torch.float32) * (2.0 ** -24)
    keep = u >= torch.tensor(p, dtype=torch.float32, device=device)
    return (keep.to(torch.float32) * keep_scale(p)).reshape(shape)


class StepDraws:
    """Every draw of one tower's training forward at one step."""

    def __init__(self, seed: int, step: int, tower: int = 0):
        self.seed, self.step, self.tower = int(seed), int(step), int(tower)

    def pair(self, layer: int, site: int) -> Tuple[int, int]:
        return stream_seed(self.seed, self.step, self.tower, layer, site)

    def mask(self, layer: int, site: int, sub: int, shape, p: float,
             device) -> torch.Tensor:
        return dropout_mask(self.pair(layer, site), sub, shape, p, device)

    def generator(self, stream: int) -> torch.Generator:
        k0, k1 = stream_seed(self.seed, self.step, self.tower,
                             0x10000 + stream)
        return torch.Generator().manual_seed((k1 << 32) | k0)

    def layer_keep(self, layers: int, p: float) -> List[bool]:
        if p <= 0.0:
            return [True] * layers
        u = torch.rand(layers, generator=self.generator(STREAM_LAYERDROP))
        keep = (u >= p).tolist()
        keep[0] = True
        return keep

    def time_mask(self, batch: int, length: int, prob: float, span: int,
                  min_masks: int) -> torch.Tensor:
        """SpecAugment's ``[B, T]`` spans: ``max(min_masks,
        round(prob*T/span))`` spans a row, uniform starts."""
        gen = self.generator(STREAM_SPEC_AUGMENT)
        n_spans = max(min_masks, int(prob * length / span + 0.5))
        starts = torch.randint(0, max(1, length - span), (batch, n_spans),
                               generator=gen)
        idx = torch.arange(length)[None, None, :]
        return ((idx >= starts[..., None])
                & (idx < starts[..., None] + span)).any(dim=1)

    def head_keep(self, layers: int, batch: int, hidden: int,
                  p: float) -> torch.Tensor:
        gen = self.generator(STREAM_HEAD_DROPOUT)
        keep = torch.zeros(layers, batch, hidden, dtype=torch.bool)
        for i in range(layers):
            keep[i] = torch.rand((batch, hidden), generator=gen) >= p
        return keep
