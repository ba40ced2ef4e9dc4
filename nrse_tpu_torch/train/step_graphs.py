"""The SER trainers' train step as CUDA graphs, one per part of the step.

The JAX package runs the step as one jitted program
(``nrse_tpu/train/emotion_trainer.py:149``), and skips a layer that
LayerDrop drops inside it (``nrse_tpu/models/wavlm.py:826-851``,
``nn.cond``).  LayerDrop draws a new keep set every step (with p = 0.1
over 23 droppable layers, about 91% of steps drop one), so one graph of
the whole step would need a capture per keep set.  Here the step is cut
into parts, each captured once per trainable key and batch shape, and the
host replays the parts of the layers the step keeps, so a dropped layer
launches nothing:

  * ``front``: the flat gradient buffer zeroed, the waveform's z-norm, the
    frontend, the projection, SpecAugment, the positional conv, the
    encoder-level dropout and the relative position bias;
  * ``layer i forward``, for each layer: with autograd where the layer
    takes part in the backward (its parameters train, or the encoder's
    other parameters do, which needs its input's gradient), under
    ``no_grad`` otherwise, so the frozen prefix runs with no graph and no
    K3 or K2 for it;
  * ``head``: the final LayerNorm, the pooling, the trunks and the loss,
    and their backward (the head's parameter gradients and the last
    layer's output gradient);
  * ``layer i backward``, for each layer that takes part, from the top
    down: the layer's parameter gradients added into their ``.grad``
    views of the flat buffer (the ``+=`` autograd's ``AccumulateGrad``
    makes), its input gradient, and its position-bias gradient added into
    one accumulator in the order autograd sums it;
  * ``front backward``, where the encoder's other parameters train;
  * ``optimizer``: the global norm of the trainable segments and the K4
    launches, with the LR and bias corrections read from the staged slot.

Each part reads static buffers: the batch (copied in before the front), the
staged inputs of ``emotion_trainer.StepInputs`` (the seed table, the spans,
the trunks' masks, K4's scalars; written before the replay in one copy),
its input hidden state or gradient (copied from the part the host ran
before it), and the parameters and their gradients in the state's flat
buffers.  The copies between the parts are the only launches outside the
graphs, one a kept layer each way; no kernel wrapper launches outside
them.  The parts share one memory pool and are captured in the order they
replay (forwards from the bottom, the head, backwards from the top), so a
part only reuses memory of a part that runs before it in every step.

A capture warms every part up once on a side stream first (cuBLAS's
workspace, cuDNN's choice for the positional conv); the optimizer is not
warmed up, since it would update the state.  A capture that fails raises,
naming the step and the part; there is no eager fallback.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from nrse_tpu_torch.audio.features import zero_mean_unit_var
from nrse_tpu_torch.models.wavlm import TrainRNG
from nrse_tpu_torch.ops.fused_optimizer import (
    FusedAdamWSpec,
    fused_adamw_ema_update,
)
from nrse_tpu_torch.train.emotion_trainer import (
    emotion_loss,
    global_norm,
    parameter_groups,
)


class SERStepGraphs:
    """The captured train step of ``state`` for one ``key`` (the trainable
    key, the batch shape, the task, whether class weights are given):
    built by capturing the parts on ``batch`` with ``rng`` (the step's
    staged stream) and ``inputs`` (the ``emotion_trainer.StepInputs``
    staged for it: the trunks' masks, K4's host scalars), then
    :meth:`run` per step.  ``capture_s`` is the
    capture's seconds by the host clock, warm-up included."""

    def __init__(self, state, task: str, spec: FusedAdamWSpec,
                 segments: Sequence[Tuple[int, int]], batch: Mapping,
                 class_weights: Optional[torch.Tensor], rng: TrainRNG,
                 inputs, key: Tuple):
        self.key = key
        self.state, self.task, self.spec = state, task, spec
        self.segments = list(segments)
        self.k4, self.trunks = inputs.k4, inputs.trunks
        model = state.model
        wavlm = model.encoder
        self.layers = list(wavlm.encoder.layers)
        n = len(self.layers)
        first, rest = state.trainable
        self.rest = bool(rest)
        # a layer takes part in the backward where its parameters train or
        # the encoder's other parameters need its input's gradient
        self.trains = [self.rest or i >= first for i in range(n)]
        self.encoder_grad = any(self.trains)
        groups = [[p for p in g if p.requires_grad]
                  for g in parameter_groups(model)]
        self.front_params, self.layer_params = groups[0], groups[1:-1]
        self.head_params = groups[0] + groups[-1]
        self.inputs = {k: torch.empty_like(v) for k, v in batch.items()}
        self.weights = None if class_weights is None \
            else torch.empty_like(class_weights)
        self.rng = rng
        self.graphs: Dict[str, torch.cuda.CUDAGraph] = {}
        self.capture_s = None
        self._load(batch, class_weights)
        if state.params.device.type == "cuda":
            self._capture(state.params.device)

    def warm_up(self) -> None:
        """Every part but the optimizer once, eagerly, every layer run (a
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
                f"capturing the SER train step {self.state.step} (trainable "
                f"{self.state.trainable}, batch "
                f"{tuple(self.inputs['input_values'].shape)}) failed in "
                f"part {name!r}: {e}") from e
        self.graphs[name] = graph
        return out

    def _build(self, pool) -> None:
        """Run (``pool`` None) or capture every part in replay order."""
        state, part, rest, rng = self.state, self._part, self.rest, self.rng
        inputs, weights = self.inputs, self.weights
        model = state.model
        wavlm = model.encoder
        front_params, head_params = self.front_params, self.head_params
        warm = pool is None

        def front():
            state.grads.zero_()
            with torch.set_grad_enabled(rest):
                x = zero_mean_unit_var(inputs["input_values"])
                return wavlm.front(x, inputs["attention_mask"], rng)

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
            with torch.enable_grad():
                seq, _ = wavlm.back(self.h_last, frame_mask)
                logits, dims = model.head(seq, inputs["attention_mask"],
                                          self.task, rng, self.trunks)
                loss = emotion_loss(self.task, logits, dims, inputs,
                                    weights)
                wrt = [self.h_last] if self.encoder_grad else []
                grads = torch.autograd.grad(loss, wrt + head_params,
                                            allow_unused=True)
            _accumulate(head_params, grads[len(wrt):])
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

        def optimizer():
            with torch.no_grad():
                gn = global_norm(state.grads, self.segments)
                for lo, hi in self.segments:
                    fused_adamw_ema_update(
                        state.grads[lo:hi], state.params[lo:hi],
                        state.mu[lo:hi], state.nu[lo:hi], None, self.spec,
                        state.step, gn, rest=self.k4)
                return gn

        self.grad_norm = part("optimizer", optimizer, pool)

    def _load(self, batch: Mapping, class_weights) -> None:
        with torch.no_grad():
            for k, v in self.inputs.items():
                v.copy_(batch[k])
            if self.weights is not None:
                self.weights.copy_(class_weights)

    def run(self, batch: Mapping, class_weights,
            rng: TrainRNG) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step on ``batch`` whose inputs ``rng`` says were staged:
        the batch copied in, the parts of the layers ``rng.draws.keep``
        keeps replayed.  Returns copies of ``(loss, grad_norm)``."""
        self._load(batch, class_weights)
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
            graphs["optimizer"].replay()
            return self.loss.clone(), self.grad_norm.clone()


def _accumulate(params: List[torch.nn.Parameter], grads) -> None:
    """``p.grad += g`` for each gradient autograd returned (None: unused),
    as autograd's ``AccumulateGrad`` adds into an existing ``.grad``."""
    with torch.no_grad():
        for p, g in zip(params, grads):
            if g is not None:
                p.grad.add_(g)
