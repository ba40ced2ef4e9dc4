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
  * ``head``: ``WavLMModel.back`` (with autograd where the encoder trains),
    then the caller's head and loss (the SER trunks and ``emotion_loss``;
    the fine-tune's ASP, ``EmotionRegression`` and ``ce_weight_category``),
    and their backward (the head's parameter gradients and the last
    layer's output gradient);
  * ``layer i backward``, for each layer that takes part, from the top
    down: the layer's parameter gradients added into their ``.grad``
    views of the flat buffer (the ``+=`` autograd's ``AccumulateGrad``
    makes), its input gradient, and its position-bias gradient added into
    one accumulator in the order autograd sums it;
  * ``front backward``, where the encoder's other parameters train;
  * the caller's optimizer parts, in order, each replayed only on the
    steps the caller names: the SER step's ``optimizer`` (the global norm
    and K4) every step; the fine-tune's ``accumulate`` every micro-step and
    ``apply`` (K4 over the mean, the mean zeroed) on every k-th.

Each part reads static buffers: the batch (copied in before the front),
the step's staged inputs (the seed table, the spans, the head's dropout
masks, K4's scalars, MultiSteps' divisor; written before the replay in one
copy), its input hidden state or gradient (copied from the part the host
ran before it), and the parameters and their gradients in the state's flat
buffers.  The copies between the parts are the only launches outside the
graphs, one a kept layer each way; no kernel wrapper launches outside
them.  The parts share one memory pool and are captured in the order they
replay (forwards from the bottom, the head, backwards from the top, the
optimizer parts), so a part only reuses memory of a part that runs before
it in every step.

A capture warms every part up once on a side stream first (cuBLAS's
workspace, cuDNN's choice for the positional conv); the optimizer parts
are not warmed up, since they would update the state.  A capture that
fails raises, naming the step and the part; there is no eager fallback.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Mapping, Sequence, Tuple

import torch

from nrse_tpu_torch.models.wavlm import TrainRNG, WavLMModel


class StepGraphs:
    """The captured train step of one ``key`` (the caller's: the trainable
    key, the batch shape, ...).

    ``wavlm`` is the model's encoder and ``groups`` its parameters as
    ``[the encoder's non-layer parameters, layer 0, ..., layer L − 1, the
    head's]``; ``trainable`` is ``(first, rest)``: the layers from
    ``first`` up train, and with ``rest`` the encoder's other parameters
    do too.  ``front(inputs, rng)`` returns ``WavLMModel.front``'s
    ``(hidden, pos_bias, frame_mask)``; ``head(seq, inputs, rng)`` the
    loss of the encoder's sequence; ``optimizer`` the ``(name, fn)``
    parts after the backward, each ``fn()`` returning a tensor or None.
    ``inputs`` (a mapping of tensors: the batch and whatever else the
    step reads per step) gives the static inputs' shapes and the first
    step's values; ``rng`` is that step's staged stream (its table and its
    draws, which every later step writes in place); ``grads`` the flat
    gradient buffer the front zeroes.  On a card the parts are captured
    here; ``capture_s`` is the capture's seconds by the host clock,
    warm-up included.  ``label`` names the step in a capture's error."""

    def __init__(self, wavlm: WavLMModel,
                 groups: Sequence[Sequence[torch.nn.Parameter]],
                 trainable: Tuple[int, bool],
                 front: Callable, head: Callable,
                 optimizer: Sequence[Tuple[str, Callable[[], Any]]],
                 inputs: Mapping[str, torch.Tensor], rng: TrainRNG,
                 grads: torch.Tensor, key: Any = None, label: str = ""):
        self.key, self.label = key, label
        self.wavlm, self.front_fn, self.head_fn = wavlm, front, head
        self.optimizer = list(optimizer)
        self.grads = grads
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
            self._capture(grads.device)

    def warm_up(self) -> None:
        """Every part but the optimizer's once, eagerly, every layer run (a
        capture's warm-up; on the CPU, where nothing is captured, the
        parts' arithmetic against the eager step)."""
        self._build(None)

    def _capture(self, device) -> None:
        t0 = time.perf_counter()
        with torch.cuda.device(device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.warm_up()
            torch.cuda.current_stream().wait_stream(side)
            self._build(torch.cuda.graph_pool_handle())
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0

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
                f"{tuple(self.inputs['input_values'].shape)}) failed in "
                f"part {name!r}: {e}") from e
        self.graphs[name] = graph
        return out

    def _build(self, pool) -> None:
        """Run (``pool`` None) or capture every part in replay order."""
        part, rest, rng, inputs = self._part, self.rest, self.rng, self.inputs
        wavlm, front_params = self.wavlm, self.front_params
        warm = pool is None

        def front():
            self.grads.zero_()
            with torch.set_grad_enabled(rest):
                return self.front_fn(inputs, rng)

        h0, pos_bias, frame_mask = part("front", front, pool)
        self.h0 = h0
        # the layers' view of the bias: a leaf whose gradient they return
        pb = pos_bias.detach().requires_grad_(rest)
        self.dpos = torch.zeros_like(pos_bias) if rest else None

        self.h_in, self.h_out = [], []
        h = h0
        for i, layer in enumerate(self.layers):
            h_in = torch.empty_like(h0).requires_grad_(self.trains[i])
            if warm:  # real values for the warm-up
                with torch.no_grad():
                    h_in.copy_(h)

            def fwd(layer=layer, h_in=h_in, grad=self.trains[i]):
                with torch.set_grad_enabled(grad):
                    return layer(h_in, pb, frame_mask, rng)

            h = part(f"layer {i} forward", fwd, pool)
            self.h_in.append(h_in)
            self.h_out.append(h)

        self.h_last = torch.empty_like(h0).requires_grad_(self.encoder_grad)
        if warm:
            with torch.no_grad():
                self.h_last.copy_(h)

        def head():
            if rest:  # the layers' bias gradients add up from here
                self.dpos.zero_()
            with torch.set_grad_enabled(self.encoder_grad):
                seq, _ = wavlm.back(self.h_last, frame_mask)
            with torch.enable_grad():
                loss = self.head_fn(seq, inputs, rng)
                wrt = [self.h_last] if self.encoder_grad else []
                grads = torch.autograd.grad(loss, wrt + self.head_params,
                                            allow_unused=True)
            _accumulate(self.head_params, grads[len(wrt):])
            return loss.detach(), grads[0] if wrt else None

        self.loss, g = part("head", head, pool)
        self.g_last = g

        self.g_out, self.d_in = {}, {}
        for i in reversed(range(len(self.layers))):
            if not self.trains[i]:
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

        if warm:  # the optimizer would update the state
            return
        for name, fn in self.optimizer:
            with torch.no_grad():
                self.outputs[name] = part(name, fn, pool)

    def _load(self, inputs: Mapping[str, torch.Tensor]) -> None:
        with torch.no_grad():
            for k, v in self.inputs.items():
                v.copy_(inputs[k])

    def run(self, inputs: Mapping[str, torch.Tensor], rng: TrainRNG,
            optimizer: Sequence[str]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One step on ``inputs`` whose staged values ``rng`` says were
        written: the inputs copied in, the parts of the layers
        ``rng.draws.keep`` keeps replayed, then the ``optimizer`` parts
        named.  Returns copies of the loss and of those parts' outputs
        (the ones that return a tensor)."""
        self._load(inputs)
        graphs = self.graphs
        graphs["front"].replay()
        h, kept = self.h0, []
        with torch.no_grad():
            for i, keep in enumerate(rng.draws.keep):
                if not keep:
                    continue
                self.h_in[i].copy_(h)
                graphs[f"layer {i} forward"].replay()
                h = self.h_out[i]
                kept.append(i)
            self.h_last.copy_(h)
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
            for name in optimizer:
                graphs[name].replay()
            return self.loss.clone(), {
                name: self.outputs[name].clone() for name in optimizer
                if isinstance(self.outputs[name], torch.Tensor)}


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

