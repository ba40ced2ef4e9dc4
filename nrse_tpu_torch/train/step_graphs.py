"""A training step on the WavLM encoder as CUDA graphs, one per part.

The JAX package runs each training step as one jitted program: the SER
trainers' step (``nrse_tpu/train/emotion_trainer.py:149``) and the baseline
fine-tune's micro-step (``nrse_tpu/baseline/train_ft_cat_ser.py:205``,
MultiSteps' accumulate and, on every k-th micro-step, its AdamW apply).
It skips a layer that LayerDrop drops inside the program
(``nrse_tpu/models/wavlm.py:826-851``, ``nn.cond``).  LayerDrop draws a new
keep set every step (with p = 0.1 over 23 droppable layers, about 91% of
steps drop one), so one graph of the whole step would need a capture per
keep set.  Here the step is cut into parts, each captured once per
trainable key and batch shape, and the host replays the parts of the
layers the step keeps, so a dropped layer launches nothing.  One class,
:class:`StepGraphs`, holds the parts of every such step; what differs
between models comes from the caller:

  * ``front``: the flat gradient buffer zeroed, then the caller's front
    (the SER step z-norms the waveform first, the fine-tune's dataset
    already did) ending in ``WavLMModel.front``: the frontend, the
    projection, SpecAugment, the positional conv, the encoder-level
    dropout and the relative position bias;
  * ``layer i forward``, for each layer: with autograd where the layer
    takes part in the backward (its parameters train, or the encoder's
    other parameters do, which needs its input's gradient), under
    ``no_grad`` otherwise, so a frozen layer runs with no graph and no K3,
    K2 or K5 backward for it;
  * where the caller gives a second, forward-only tower
    (:class:`ForwardTower`: the BYOL target): its ``front`` and its
    ``layer i forward``, under ``no_grad``, replayed by that tower's own
    keep list;
  * ``head``: ``WavLMModel.back`` (with autograd where the encoder trains;
    the forward-only tower's under ``no_grad``), then the caller's head
    and loss (the SER trunks and ``emotion_loss``; the fine-tune's ASP,
    ``EmotionRegression`` and ``ce_weight_category``; BYOL's online heads,
    the target's projector and ``byol_loss``), and their backward (the
    head's parameter gradients and the last layer's output gradient);
  * ``layer i backward``, for each layer that takes part, from the top
    down: the layer's parameter gradients added into their ``.grad``
    views of the flat buffer (the ``+=`` autograd's ``AccumulateGrad``
    makes), its input gradient, and its position-bias gradient added into
    one accumulator in the order autograd sums it;
  * ``front backward``, where the encoder's other parameters train;
  * ``reduce``, where the caller gives one: what sums the step over a
    mesh's data axis (the gradients, the loss), every step;
  * the caller's optimizer parts, in order, each replayed only on the
    steps the caller names: the SER step's and BYOL's ``optimizer`` (the
    global norm and K4, BYOL's with the target's EMA) every step; the
    fine-tune's ``accumulate`` every micro-step and ``apply`` (K4 over the
    mean, the mean zeroed) on every k-th.

Under an NCCL mesh the parts hold the step's collectives as the eager step
runs them (the heads' global BatchNorm statistics and the loss's global
denominator in ``head``, a tensor-parallel layer's ``copy_to_model`` and
``reduce_from_model`` in its forward and backward, the forward-only
tower's included, the data axis's sums in ``reduce``, the model group's
norm in ``optimizer``), and every rank replays them in one order: the
host picks the parts from LayerDrop's keep lists, drawn without a batch
axis and so the same on every rank, which the capture checks (one
``all_reduce`` of their checksum; a rank whose lists differ raises, where
a replay would hang).  The groups' NCCL communicators exist before any
capture (``parallel.mesh.make_mesh``).

Each part reads static buffers: the batch (copied in before the front),
the step's staged inputs (the seed table, the spans, the head's dropout
masks, K4's scalars, MultiSteps' divisor; written before the replay in one
copy), its input hidden state or gradient (copied from the part the host
ran before it), and the parameters and their gradients in the state's flat
buffers.  The copies between the parts are the only launches outside the
graphs, one a kept layer each way; no kernel wrapper launches outside
them.  The parts share one memory pool and are captured in the order they
replay (forwards from the bottom, the forward-only tower's, the head,
backwards from the top, the optimizer parts), so a part only reuses
memory of a part that runs before it in every step.

A capture warms every part up once on a side stream first (cuBLAS's
workspace, cuDNN's choice for the positional conv); ``reduce`` is warmed
up too (it sums gradients the next front zeroes), the optimizer parts
are not, since they would update the state, and the buffers
the parts change in place (the BYOL heads' BatchNorm statistics) are put
back after it, so the first replayed step advances them once.  A capture
that fails raises, naming the step and the part; there is no eager
fallback.
"""

from __future__ import annotations

import dataclasses
import time
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
)

import torch

from nrse_tpu_torch.models.wavlm import TrainRNG, WavLMModel
from nrse_tpu_torch.parallel.mesh import DataMesh, replicas_agree
from nrse_tpu_torch.runtime.graphs import hold


@dataclasses.dataclass
class ForwardTower:
    """A second encoder that a step runs forward only, under ``no_grad``
    (the BYOL target; its parts are named ``target ...``):
    ``front(inputs, rng)`` returns its ``WavLMModel.front`` triple;
    ``rng`` is the first step's staged stream of this tower (its table and
    draws, written in place every later step)."""

    wavlm: WavLMModel
    front: Callable
    rng: TrainRNG


class StepGraphs:
    """The captured train step of one ``key`` (the caller's: the trainable
    key, the batch shape, ...).

    ``wavlm`` is the model's encoder and ``groups`` its parameters as
    ``[the encoder's non-layer parameters, layer 0, ..., layer L − 1, the
    head's]``; ``trainable`` is ``(first, rest)``: the layers from
    ``first`` up train, and with ``rest`` the encoder's other parameters
    do too.  ``front(inputs, rng)`` returns ``WavLMModel.front``'s
    ``(hidden, pos_bias, frame_mask)``; ``head(back, inputs, rng)`` the
    loss of the encoder's ``WavLMModel.back`` output ``(sequence,
    pooled)`` (with a ``tower``, ``head(back, inputs, rng, tower_back)``,
    the last the tower's, without a graph); ``optimizer`` the ``(name,
    fn)`` parts after the backward, each ``fn()`` returning a tensor, a
    tuple of tensors or None; ``reduce(loss)`` (or None) the part between
    the backward and the optimizer parts, given the head's loss.
    ``inputs`` (a mapping of tensors: the batch and whatever else the
    step reads per step) gives the static inputs' shapes and the first
    step's values; ``rng`` is that step's staged stream (its table and its
    draws, which every later step writes in place); ``grads`` the flat
    gradient buffer the front zeroes.  On a card the parts are captured
    here; ``capture_s`` is the capture's seconds by the host clock,
    warm-up included.  ``label`` names the step in a capture's error.
    ``tower``: a :class:`ForwardTower` run beside the encoder; ``buffers``
    the tensors the parts change in place besides the gradients (the
    BatchNorm statistics), which the warm-up puts back; ``mesh`` the
    step's (None: one process), whose ranks' keep lists a capture checks
    with :func:`check_keep_lists`."""

    def __init__(self, wavlm: WavLMModel,
                 groups: Sequence[Sequence[torch.nn.Parameter]],
                 trainable: Tuple[int, bool],
                 front: Callable, head: Callable,
                 optimizer: Sequence[Tuple[str, Callable[[], Any]]],
                 inputs: Mapping[str, torch.Tensor], rng: TrainRNG,
                 grads: torch.Tensor, key: Any = None, label: str = "",
                 tower: Optional[ForwardTower] = None,
                 buffers: Sequence[torch.Tensor] = (),
                 reduce: Optional[Callable[[torch.Tensor], Any]] = None,
                 mesh: Optional[DataMesh] = None):
        self.key, self.label = key, label
        self.wavlm, self.front_fn, self.head_fn = wavlm, front, head
        self.optimizer = list(optimizer)
        self.reduce = reduce
        self.grads = grads
        self.tower = tower
        self.buffers = list(buffers)
        self.layers = list(wavlm.encoder.layers)
        n = len(self.layers)
        first, rest = trainable
        self.rest = bool(rest)
        # a layer takes part in the backward where its parameters train or
        # the encoder's other parameters need its input's gradient
        self.trains = [self.rest or i >= first for i in range(n)]
        self.encoder_grad = any(self.trains)
        groups = [[p for p in g if p.requires_grad] for g in groups]
        self.front_params, self.layer_params = groups[0], groups[1:-1]
        self.head_params = (groups[0] if self.rest else []) + groups[-1]
        self.inputs = {k: torch.empty_like(v) for k, v in inputs.items()}
        self.rng = rng
        self.graphs: Dict[str, torch.cuda.CUDAGraph] = {}
        self.outputs: Dict[str, Any] = {}
        self.capture_s = None
        self._load(inputs)
        if grads.device.type == "cuda":
            keeps = [rng.draws.keep] + ([tower.rng.draws.keep] if tower
                                        else [])
            check_keep_lists(mesh, keeps, label)
            self._capture(grads.device)

    def warm_up(self) -> None:
        """Every part but the optimizer's once, eagerly, every layer run,
        then ``buffers`` put back (a capture's warm-up; on the CPU, where
        nothing is captured, the parts' arithmetic against the eager
        step, ``reduce`` included)."""
        saved = [b.clone() for b in self.buffers]
        self._build(None)
        with torch.no_grad():
            for b, s in zip(self.buffers, saved):
                b.copy_(s)

    def release(self) -> int:
        """Free the captured parts (``runtime.graphs.release_graphs``);
        returns how many.  The step's key goes with them, so its trainer
        captures anew when it next runs."""
        for graph in self.graphs.values():
            graph.reset()
        n = len(self.graphs)
        self.graphs.clear()
        self.key = object()
        return n

    def _capture(self, device) -> None:
        hold(self)  # a capture that fails leaves its parts to release
        t0 = time.perf_counter()
        with torch.cuda.device(device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.warm_up()
            torch.cuda.current_stream().wait_stream(side)
            self._drop_graphs()
            self._build(torch.cuda.graph_pool_handle(), optimizer=True)
            self._drop_graphs()
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0

    def _drop_graphs(self) -> None:
        """Detach the static tensors a build left: its forwards' outputs
        keep their autograd graphs for its backward parts, and a graph
        keeps each parameter's AccumulateGrad node alive, with the stream
        the node was made on.  Kept, the warm-up's nodes (the side
        stream's) would serve the capture's backward on the capture
        stream, and the capture's a later warm-up: autograd then joins
        the two streams and warns that the node's stream does not match
        the incoming gradient's.  Dropped, each build makes its own."""
        def off(t):
            return None if t is None else t.detach()

        self.h0 = off(self.h0)
        self.h_in = [off(t) for t in self.h_in]
        self.h_out = [off(t) for t in self.h_out]
        self.h_last = off(self.h_last)

    def _part(self, name: str, fn: Callable, pool):
        """``fn()`` eagerly (``pool`` None: the warm-up) or captured into a
        graph of the pool, kept under ``name``."""
        if pool is None:
            return fn()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                out = fn()
        except Exception as e:
            raise RuntimeError(
                f"capturing {self.label} (batch "
                f"{tuple(next(iter(self.inputs.values())).shape)}) failed "
                f"in part {name!r}: {e}") from e
        self.graphs[name] = graph
        return out

    def _build(self, pool, optimizer: bool = False,
               keep: Optional[Tuple[Sequence[bool], ...]] = None) -> None:
        """Run (``pool`` None) or capture every part in replay order, the
        optimizer parts with ``optimizer`` (run eagerly with them and
        ``buffers`` advanced: the step the graphs hold).  Every layer runs,
        or (run only) those that ``keep``, the encoder's keep list and the
        tower's, keeps: the parts a replay of that step runs."""
        part, rest, rng, inputs = self._part, self.rest, self.rng, self.inputs
        wavlm, front_params = self.wavlm, self.front_params
        enc_rng = wavlm.train_rng(rng)  # None where the encoder evaluates
        warm = pool is None

        def front():
            self.grads.zero_()
            with torch.set_grad_enabled(rest):
                return self.front_fn(inputs, enc_rng)

        h0, pos_bias, frame_mask = part("front", front, pool)
        self.h0 = h0
        # the layers' view of the bias: a leaf whose gradient they return
        pb = pos_bias.detach().requires_grad_(rest)
        self.dpos = torch.zeros_like(pos_bias) if rest else None

        keep = keep or (None, None)
        self.h_in, self.h_out, self.h_last = self._forwards(
            "", self.layers, self.trains, h0, pb, frame_mask, enc_rng, pool,
            keep[0])
        tower_back = self._build_tower(pool, keep[-1]) if self.tower \
            else None

        def head():
            if rest:  # the layers' bias gradients add up from here
                self.dpos.zero_()
            with torch.set_grad_enabled(self.encoder_grad):
                back = wavlm.back(self.h_last, frame_mask)
            extra = (tower_back(),) if tower_back else ()
            with torch.enable_grad():
                loss = self.head_fn(back, inputs, rng, *extra)
                wrt = [self.h_last] if self.encoder_grad else []
                grads = torch.autograd.grad(loss, wrt + self.head_params,
                                            allow_unused=True)
            _accumulate(self.head_params, grads[len(wrt):])
            return loss.detach(), grads[0] if wrt else None

        self.loss, g = part("head", head, pool)
        self.g_last = g

        self.g_out, self.d_in = {}, {}
        for i in reversed(range(len(self.layers))):
            if not self.trains[i] or self.h_out[i] is None:  # or dropped
                continue
            g_out = torch.empty_like(self.h_out[i])
            if warm:
                with torch.no_grad():
                    g_out.copy_(g)
            params = self.layer_params[i]

            def bwd(i=i, g_out=g_out, params=params):
                wrt = [self.h_in[i]] + ([pb] if rest else [])
                grads = torch.autograd.grad(self.h_out[i], wrt + params,
                                            g_out, allow_unused=True)
                _accumulate(params, grads[len(wrt):])
                if rest:
                    with torch.no_grad():
                        self.dpos.add_(grads[1])
                return grads[0]

            g = part(f"layer {i} backward", bwd, pool)
            self.g_out[i], self.d_in[i] = g_out, g

        if rest:
            self.g_h0 = torch.empty_like(h0)
            if warm:
                with torch.no_grad():
                    self.g_h0.copy_(g)

            def front_bwd():
                grads = torch.autograd.grad([h0, pos_bias], front_params,
                                            [self.g_h0, self.dpos],
                                            allow_unused=True)
                _accumulate(front_params, grads)

            part("front backward", front_bwd, pool)

        if self.reduce is not None:
            with torch.no_grad():
                self.outputs["reduce"] = part(
                    "reduce", lambda: self.reduce(self.loss), pool)

        if not optimizer:  # a warm-up: the optimizer would update the state
            return
        for name, fn in self.optimizer:
            with torch.no_grad():
                self.outputs[name] = part(name, fn, pool)

    def _forwards(self, prefix: str, layers, grad: Sequence[bool], h0,
                  pos_bias, frame_mask, rng, pool,
                  keep: Optional[Sequence[bool]] = None
                  ) -> Tuple[list, list, torch.Tensor]:
        """Run or capture each of ``layers``' forwards as a part
        ``{prefix}layer i forward``, with autograd where ``grad[i]``, each
        on a static input the host fills with the layer below's output
        (run: with real values; a layer ``keep`` drops is not run, its
        input and output None); returns the static inputs, the outputs
        and the static input of what follows the last layer."""
        h_in, h_out, h = [], [], h0
        for i, layer in enumerate(layers):
            if keep is not None and not keep[i]:
                h_in.append(None)
                h_out.append(None)
                continue
            x = torch.empty_like(h0).requires_grad_(grad[i])
            if pool is None:
                with torch.no_grad():
                    x.copy_(h)

            def fwd(layer=layer, x=x, grad=grad[i]):
                with torch.set_grad_enabled(grad):
                    return layer(x, pos_bias, frame_mask, rng)

            h = self._part(f"{prefix}layer {i} forward", fwd, pool)
            h_in.append(x)
            h_out.append(h)
        last = torch.empty_like(h0).requires_grad_(any(grad))
        if pool is None:
            with torch.no_grad():
                last.copy_(h)
        return h_in, h_out, last

    def _replay_forwards(self, prefix: str, h, keep: Sequence[bool],
                         h_in, h_out, last) -> List[int]:
        """Replay the forwards of :meth:`_forwards`' parts ``prefix`` that
        ``keep`` keeps, from ``h``, into ``last``; returns the layers
        run."""
        kept = []
        for i, k in enumerate(keep):
            if k:
                h_in[i].copy_(h)
                self.graphs[f"{prefix}layer {i} forward"].replay()
                h = h_out[i]
                kept.append(i)
        last.copy_(h)
        return kept

    def _build_tower(self, pool, keep: Optional[Sequence[bool]] = None
                     ) -> Callable:
        """Run or capture the forward-only tower's front and layers (after
        the encoder's forwards, before the head; run, those ``keep``
        keeps); returns the head's call of the tower's ``back`` on its
        last layer's output."""
        tower = self.tower
        rng = tower.wavlm.train_rng(tower.rng)

        def front():
            with torch.no_grad():
                return tower.front(self.inputs, rng)

        h0, pos_bias, frame_mask = self._part("target front", front, pool)
        layers = tower.wavlm.encoder.layers
        self.t_h0 = h0
        self.t_h_in, self.t_h_out, self.t_last = self._forwards(
            "target ", layers, [False] * len(layers), h0, pos_bias,
            frame_mask, rng, pool, keep)

        def back():
            with torch.no_grad():
                return tower.wavlm.back(self.t_last, frame_mask)

        return back

    def _load(self, inputs: Mapping[str, torch.Tensor]) -> None:
        with torch.no_grad():
            for k, v in self.inputs.items():
                v.copy_(inputs[k])

    def run(self, inputs: Mapping[str, torch.Tensor], rng: TrainRNG,
            optimizer: Sequence[str], tower_rng: Optional[TrainRNG] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One step on ``inputs`` whose staged values ``rng`` (and
        ``tower_rng``, the forward-only tower's) says were written: the
        inputs copied in, the parts of the layers ``rng.draws.keep`` keeps
        replayed (the tower's by its own list), ``reduce`` where there is
        one, then the ``optimizer`` parts named.  Returns copies of the
        head's loss and of those parts' outputs (the ones that return a
        tensor or a tuple of them), ``reduce``'s under its name."""
        self._load(inputs)
        graphs = self.graphs
        graphs["front"].replay()
        with torch.no_grad():
            kept = self._replay_forwards("", self.h0, rng.draws.keep,
                                         self.h_in, self.h_out, self.h_last)
            if self.tower:
                graphs["target front"].replay()
                self._replay_forwards("target ", self.t_h0,
                                      tower_rng.draws.keep, self.t_h_in,
                                      self.t_h_out, self.t_last)
            graphs["head"].replay()
            g = self.g_last
            for i in reversed(kept):
                if not self.trains[i]:
                    continue
                self.g_out[i].copy_(g)
                graphs[f"layer {i} backward"].replay()
                g = self.d_in[i]
            if self.rest:
                self.g_h0.copy_(g)
                graphs["front backward"].replay()
            parts = list(optimizer)
            if self.reduce is not None:
                parts.insert(0, "reduce")
            for name in parts:
                graphs[name].replay()
            return self.loss.clone(), {
                name: _copy(self.outputs[name]) for name in parts
                if self.outputs[name] is not None}


def check_keep_lists(mesh: Optional[DataMesh],
                     keeps: Sequence[Sequence[bool]], label: str) -> None:
    """Raise unless every rank of ``mesh`` holds the same LayerDrop keep
    lists ``keeps`` (one ``all_reduce`` of their checksum over the world;
    nothing alone): the ranks' replays pick their parts from them, and a
    rank that replays another layer's collectives than the others hangs
    them all."""
    if mesh is None or not mesh.distributed:
        return
    bits = torch.tensor([int(k) for keep in keeps for k in keep],
                        dtype=torch.int32, device=mesh.device)
    if not replicas_agree(mesh, [bits]):
        raise RuntimeError(
            f"{label}: the ranks' LayerDrop keep lists differ (rank "
            f"{mesh.rank}'s: {[list(map(int, k)) for k in keeps]}); every "
            "rank must replay the same layers' collectives")


def _copy(out):
    """A copy of a part's output: a tensor or a tuple of tensors."""
    if isinstance(out, tuple):
        return tuple(t.clone() for t in out)
    return out.clone()


def _accumulate(params: List[torch.nn.Parameter], grads) -> None:
    """``p.grad += g`` for each gradient autograd returned (None: unused),
    as autograd's ``AccumulateGrad`` adds into an existing ``.grad``."""
    with torch.no_grad():
        for p, g in zip(params, grads):
            if g is not None:
                p.grad.add_(g)


def encoder_parameter_groups(model: torch.nn.Module, encoder: str,
                             layers: int
                             ) -> List[List[torch.nn.Parameter]]:
    """``model``'s parameters as :class:`StepGraphs` takes them: those of
    its WavLM ``encoder`` (the submodule's name) outside the layers (the
    relative-position table, which the front uses for every layer,
    included), each of its ``layers`` layers', and the rest (the head's)."""
    groups: List[List[torch.nn.Parameter]] = [[] for _ in range(layers)]
    rest, heads = [], []
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] != encoder:
            heads.append(p)
        elif parts[1:3] == ["encoder", "layers"] \
                and not name.endswith("rel_attn_embed.weight"):
            groups[int(parts[3])].append(p)
        else:
            rest.append(p)
    return [rest] + groups + [heads]

