"""A serving bucket as one captured CUDA graph.

The JAX package serves each batch bucket as one compiled program: its
export writes ``embed_b{B}.stablehlo`` per bucket and its ``ServingModel``
deserializes them once and calls one per forward
(``nrse_tpu/serve/export.py:113-227, 250``).  The port's counterpart is a
:class:`BucketProgram`: the bucket's static inputs on the device (``audio
[B, clip]`` float32 and ``mask [B, clip]`` int32), and on a CUDA device
the ``torch.cuda.CUDAGraph`` of one forward on them with its static
outputs, captured once when the server loads and replayed per request, so
a request costs one graph launch instead of every kernel and library call
of the forward dispatched from Python.

  * Capture follows PyTorch's rules: the forward runs once eagerly on a
    side stream first (which builds and loads the kernels' library, fixes
    cuDNN's algorithm and makes cuBLAS's workspace), then once under
    capture.  A capture that fails raises, naming the bucket, with the
    failing op's error chained: there is no eager fallback on the card.
  * The buckets of one server share one memory pool
    (``torch.cuda.graph_pool_handle()``), captured largest first: they
    replay one at a time, so the pool holds about the largest bucket's
    activations, not their sum.  A replay may overwrite what another
    bucket's replay left in the pool, its outputs included: a caller copies
    the outputs out before the next replay of any bucket.
  * A graph bakes in device addresses (the kernels' pointers, and the TMA
    descriptors that kernels A and B, K5 and K6 encode on the host at
    launch), so the static buffers, the pool and the module's weights keep
    their addresses for the program's life: nothing may re-make a weight
    outside the graph after capture.  Work the forward does per call, such
    as a kernel's weight layout, is captured with it and redone on each
    replay.
  * :meth:`BucketProgram.load` rewrites the whole of both inputs on every
    request, padding rows included, so a smaller request never sees a
    larger one's rows.

A :class:`ProgramCache` holds the programs of one forward keyed by
``(batch, samples)`` in one pool, captured when a shape first comes (or
ahead, :meth:`ProgramCache.prepare`): the SER trainers' eval step and the
SER evaluator's buckets, the counterpart of JAX compiling its jitted
forward once per shape.

On the CPU there is no graph: :meth:`BucketProgram.run` calls the forward
on the static buffers.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch


class BucketProgram:
    """One bucket of ``batch`` rows of ``clip`` samples: the static inputs
    and, on a CUDA device, the graph of ``forward(audio, mask)`` on them
    (``mask`` None where ``with_mask`` is False; int32 unless
    ``mask_dtype`` says otherwise), captured into ``pool``.  ``replays``
    counts the graph's replays."""

    def __init__(self, forward: Callable[..., Tuple[torch.Tensor, ...]],
                 batch: int, clip: int, device, with_mask: bool = True,
                 pool=None, mask_dtype: torch.dtype = torch.int32):
        self.forward = forward
        self.batch, self.clip = int(batch), int(clip)
        self.device = torch.device(device)
        self.audio = torch.zeros(self.batch, self.clip, dtype=torch.float32,
                                 device=self.device)
        self.mask = torch.ones(self.batch, self.clip, dtype=mask_dtype,
                               device=self.device) if with_mask else None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Optional[Tuple[torch.Tensor, ...]] = None
        self.replays = 0
        if self.device.type == "cuda":
            self._capture(pool)

    def _capture(self, pool) -> None:
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):  # warm-up
                self.forward(self.audio, self.mask)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, pool=pool):
                    outputs = self.forward(self.audio, self.mask)
            except Exception as e:
                raise RuntimeError(
                    f"capturing the serving bucket of {self.batch} x "
                    f"{self.clip} samples into a CUDA graph failed: {e}"
                ) from e
        self.graph, self.outputs = graph, tuple(outputs)

    def load(self, audio, mask) -> None:
        """Write a whole ``[batch, clip]`` request (numpy arrays or
        tensors) into the static inputs, padding rows included (``mask`` is
        ignored where the program has none)."""
        self.audio.copy_(_tensor(audio))
        if self.mask is not None:
            self.mask.copy_(_tensor(mask))

    def run(self) -> Tuple[torch.Tensor, ...]:
        """The forward's outputs on the static inputs: the graph replayed
        (its static outputs, valid until the next replay of any bucket of
        the pool), or on the CPU the forward called."""
        if self.graph is None:
            return tuple(self.forward(self.audio, self.mask))
        self.graph.replay()
        self.replays += 1
        return self.outputs


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


class ProgramCache:
    """The :class:`BucketProgram` of ``forward`` for each ``(batch,
    samples)`` shape, in one pool: called like ``forward(audio, mask)``
    (tensors or arrays of one shape), it writes them into that shape's
    static inputs and runs the program, returning copies of its outputs
    (a tensor, or a tuple where ``forward`` returns one), so that a later
    replay of any shape leaves them alone.  A program is captured when its
    shape first comes, or ahead by :meth:`prepare`; ``captured`` counts
    them."""

    def __init__(self, forward: Callable, device, with_mask: bool = True,
                 mask_dtype: torch.dtype = torch.int32):
        self.device = torch.device(device)
        self.forward = forward
        self.with_mask, self.mask_dtype = with_mask, mask_dtype
        self.pool = torch.cuda.graph_pool_handle() \
            if self.device.type == "cuda" else None
        self.programs: Dict[Tuple[int, int], BucketProgram] = {}
        self._single = None
        self.captured = 0

    def _outputs(self, audio, mask):
        out = self.forward(audio, mask)
        self._single = not isinstance(out, tuple)
        return (out,) if self._single else out

    def program(self, batch: int, samples: int) -> BucketProgram:
        """The program of this shape, captured on its first call."""
        key = (int(batch), int(samples))
        if key not in self.programs:
            self.programs[key] = BucketProgram(
                self._outputs, key[0], key[1], self.device, self.with_mask,
                self.pool, self.mask_dtype)
            self.captured += self.device.type == "cuda"
        return self.programs[key]

    def prepare(self, shapes: Iterable[Tuple[int, int]]) -> None:
        """Capture the programs of ``shapes``, largest first, so that the
        pool holds about the largest one's activations."""
        for b, n in sorted(shapes, key=lambda k: k[0] * k[1], reverse=True):
            self.program(b, n)

    def __call__(self, audio, mask=None
                 ) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
        program = self.program(*audio.shape)
        program.load(audio, mask)
        out = tuple(None if t is None else t.clone() for t in program.run())
        return out[0] if self._single else out
