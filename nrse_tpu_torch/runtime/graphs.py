"""A forward as one captured CUDA graph per shape of its inputs.

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
  * :meth:`BucketProgram.load` rewrites the whole of every input on each
    request, padding rows included, so a smaller request never sees a
    larger one's rows.

A :class:`ProgramCache` holds the programs of one forward keyed by the
shapes of its inputs, in one pool, captured when a shape first comes (or
ahead, :meth:`ProgramCache.prepare`): the counterpart of JAX compiling
its jitted forward once per shape.  Its inputs are a tuple of static
tensors with their dtypes (:data:`AUDIO_MASK`, ``(audio [B, T], mask [B,
T])``, for serving, the SER trainers' eval step, the SER evaluator's
buckets and the fine-tune's dev step; ``(clean, noise, snr)`` for the BYOL
eval step; an input may be absent, None, as a server without masks or an
encoder called without one has it).

On the CPU there is no graph: :meth:`BucketProgram.run` calls the forward
on the static buffers.

Every holder of captured graphs (a :class:`ProgramCache` on a card, a
train step's ``train.step_graphs.StepGraphs``) registers itself with
:func:`hold`, and :func:`release_graphs` frees the graphs of all that are
alive, however they are still referenced: NCCL's end of a group waits
for every graph holding its collectives, so ``parallel.distributed.
leave`` calls it before it destroys the group.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

# an input of a program: its dtype and the value its static buffer starts
# with (what the warm-up and the capture read), or None for an input that
# is always absent
Input = Optional[Tuple[torch.dtype, float]]
Shape = Optional[Tuple[int, ...]]


def audio_inputs(with_mask: bool = True,
                 mask_dtype: torch.dtype = torch.int32
                 ) -> Tuple[Input, Input]:
    """``(audio float32 zeros, mask of ones | absent)``: the inputs of a
    forward of ``(waveforms [B, T], mask [B, T])``."""
    return (torch.float32, 0.0), ((mask_dtype, 1) if with_mask else None)


AUDIO_MASK = audio_inputs()

# the live holders of captured graphs in this process
_HOLDERS: "weakref.WeakSet" = weakref.WeakSet()


def hold(holder) -> None:
    """Register ``holder`` as holding captured graphs: its ``release()``
    frees them and returns how many."""
    _HOLDERS.add(holder)


def release_graphs() -> int:
    """Free the graphs of every live holder (a state the caller keeps, a
    traceback's frames, a half-built step's), then wait for the card;
    returns the graphs freed.  A holder captures anew when next used."""
    n = sum(holder.release() for holder in list(_HOLDERS))
    if n:
        torch.cuda.synchronize()
    return n


class BucketProgram:
    """One program of ``forward(*inputs)`` on static inputs of ``shapes``
    (one shape per entry of ``specs``; None for an absent input, passed
    to ``forward`` as None) and, on a CUDA device, the graph of one call
    on them, captured into ``pool``.  ``replays`` counts the graph's
    replays."""

    def __init__(self, forward: Callable[..., Tuple[torch.Tensor, ...]],
                 specs: Sequence[Input], shapes: Sequence[Shape], device,
                 pool=None):
        self.forward = forward
        self.device = torch.device(device)
        self.inputs = tuple(
            None if spec is None else torch.full(
                shape, spec[1], dtype=spec[0], device=self.device)
            for spec, shape in zip(specs, shapes))
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Optional[Tuple[torch.Tensor, ...]] = None
        self.replays = 0
        if self.device.type == "cuda":
            self._capture(pool)

    @property
    def audio(self) -> torch.Tensor:
        """The first input: an audio program's ``[batch, clip]`` waveforms."""
        return self.inputs[0]

    @property
    def mask(self) -> Optional[torch.Tensor]:
        """The second input: an audio program's mask (None: absent)."""
        return self.inputs[1]

    @property
    def batch(self) -> int:
        return self.inputs[0].shape[0]

    @property
    def clip(self) -> int:
        return self.inputs[0].shape[1]

    def _capture(self, pool) -> None:
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):  # warm-up
                self.forward(*self.inputs)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            try:
                # thread-local: NCCL's watchdog thread queries events while
                # a program holding a tensor-parallel encoder's collectives
                # is captured
                with torch.cuda.graph(graph, pool=pool,
                                      capture_error_mode="thread_local"):
                    outputs = self.forward(*self.inputs)
            except Exception as e:
                shapes = [None if x is None else tuple(x.shape)
                          for x in self.inputs]
                raise RuntimeError(
                    f"capturing the program of inputs {shapes} into a CUDA "
                    f"graph failed: {e}") from e
        self.graph, self.outputs = graph, tuple(outputs)

    def load(self, *inputs) -> None:
        """Write a whole request (numpy arrays or tensors, one per input)
        into the static inputs, padding rows included (an input the
        program has not is ignored)."""
        for buf, x in zip(self.inputs, inputs):
            if buf is not None:
                buf.copy_(_tensor(x))

    def run(self) -> Tuple[torch.Tensor, ...]:
        """The forward's outputs on the static inputs: the graph replayed
        (its static outputs, valid until the next replay of any program of
        the pool), or on the CPU the forward called."""
        if self.graph is None:
            return tuple(self.forward(*self.inputs))
        self.graph.replay()
        self.replays += 1
        return self.outputs


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


class ProgramCache:
    """The :class:`BucketProgram` of ``forward`` for each tuple of input
    shapes, in one pool.  ``inputs`` gives each input's dtype and start
    value (:data:`AUDIO_MASK` by default; None for an input that is always
    absent).  Called like ``forward(*inputs)`` (tensors or arrays), it
    writes them into that shape's static inputs and runs the program,
    returning copies of its outputs (a tensor, or a tuple where
    ``forward`` returns one), so that a later replay of any shape leaves
    them alone.  A program is captured when its shapes first come, or
    ahead by :meth:`prepare`; ``captured`` counts them."""

    def __init__(self, forward: Callable, device,
                 inputs: Sequence[Input] = AUDIO_MASK):
        self.device = torch.device(device)
        self.forward = forward
        self.specs = tuple(inputs)
        self.pool = torch.cuda.graph_pool_handle() \
            if self.device.type == "cuda" else None
        self.programs: Dict[Tuple[Shape, ...], BucketProgram] = {}
        self._single = None
        self.captured = 0
        if self.pool is not None:
            hold(self)

    def release(self) -> int:
        """Free every program's graph (:func:`release_graphs`; each shape
        captured again when it next comes); returns how many."""
        graphs = [p.graph for p in self.programs.values()
                  if p.graph is not None]
        for graph in graphs:
            graph.reset()
        self.programs.clear()
        return len(graphs)

    def _outputs(self, *inputs):
        out = self.forward(*inputs)
        self._single = not isinstance(out, tuple)
        return (out,) if self._single else out

    def program(self, *shapes: Shape) -> BucketProgram:
        """The program of these input shapes, captured on its first
        call."""
        key = tuple(None if spec is None or shape is None
                    else tuple(int(d) for d in shape)
                    for spec, shape in zip(self.specs, shapes))
        if key not in self.programs:
            self.programs[key] = BucketProgram(
                self._outputs, self.specs, key, self.device, self.pool)
            self.captured += self.device.type == "cuda"
        return self.programs[key]

    def prepare(self, keys: Iterable[Tuple[Shape, ...]]) -> None:
        """Capture the programs of ``keys`` (tuples of input shapes),
        largest first, so that the pool holds about the largest one's
        activations."""
        def size(key):
            return sum(int(np.prod(s)) for s in key if s is not None)

        for key in sorted(keys, key=size, reverse=True):
            self.program(*key)

    def __call__(self, *inputs
                 ) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
        inputs = inputs + (None,) * (len(self.specs) - len(inputs))
        program = self.program(*(None if x is None else x.shape
                                 for x in inputs))
        program.load(*inputs)
        out = tuple(None if t is None else t.clone() for t in program.run())
        return out[0] if self._single else out
