"""Where the tensor-parallel BYOL step departs from one rank's, on one card.

Two ranks share the card over gloo at ``{data: 1, model: 2}``; rank 0
first runs the same steps at ``model: 1`` from the same weights
(WavLM-large, ``chip_smoke.py``'s batch of 36 × 5 s, random features
off and then on), ``STEPS`` steps each: from the second step on each run
starts from its own parameters, so a step's difference holds the drift
of the steps before it.  For each configuration and step it prints:

  * the relative distance ``|a − b| / |b|`` of each encoder layer's
    output, the pooled embeddings, the projector's and the predictor's
    outputs of both towers, and of the gradient at each layer's output;
  * grad_norm of both, ``|Δg|² / |g|²`` over every gradient, the share of
    the gradients that are 0 in exact arithmetic, and the twelve
    parameters whose gradients differ most;
  * the same for three controls, one-rank runs that change only the
    order of sums: with cuBLAS's reduced-precision bf16 reductions off;
    with every projection summed as two float32 halves of its input
    (``chip_smoke._split_linear``, phase 20(a)'s control); and with that
    and the gate's projection's weight and bias gradients summed as
    model: 2 sums them, two 8-head halves each rounded to bf16 and added
    in float32 (:class:`_GateHalves`);
  * per gradient tensor, ``|Δg| / |g|`` of the sharded step against each
    of the last two controls': their medians, how many tensors the
    sharded step moves more than twice as far, and the twelve with the
    largest ratio (the gradients that are 0 in exact arithmetic left
    out); and each layer's ``gru_rel_pos_linear`` gradients in the three
    runs, with the spread of their ratio to the last control over the
    layers;
  * the cancellation in each layer's gate bias gradient in the one-rank
    run: ``|g| / Σ|terms|``, where ``g`` is the sum over the batch, the
    heads and the frames of the gradient at the gate projection's output
    (in float64) and the terms are its elements; beside it the model: 2
    run's error of that bias against the gate-halves control's.

Run from the root of a checkout, on a machine with the card:

    python3 tools/tp_divergence.py [layers] [--running-stats]

(``layers`` cuts the encoder's depth, default 24; ``--running-stats``
puts the heads' BatchNorms on their running statistics in every run, as
phase 9's cross-check against float32 does; ``--steps N``, default 3.)
"""

import argparse
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from nrse_tpu_torch.models import wavlm as wavlm_module  # noqa: E402
from nrse_tpu_torch.models.wavlm import WavLMConfig  # noqa: E402
from nrse_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from nrse_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

STEPS = 3

# gradients that are 0 in exact arithmetic (a Dense bias feeding a
# BatchNorm, the key bias under the softmax, the final LayerNorm's bias
# before pooling and BatchNorm)
ZERO = ("projector.dense_0.bias", "projector.dense_1.bias",
        "predictor.dense_0.bias", "predictor.dense_1.bias",
        "projector.bn_1.bias", "encoder.encoder.layer_norm.bias",
        "attention.k_proj.bias")


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _record(state, rec: dict) -> list:
    """Forward hooks that keep each encoder layer's output (and the
    gradient at it), the pooled embeddings and the heads' outputs."""
    def keep(name, grad=False):
        def hook(module, args, out):
            t = out[1] if name.endswith("pooled") else out
            rec[name] = t.detach().float().cpu()
            if grad and t.requires_grad:
                t.register_hook(lambda g: rec.__setitem__(
                    "grad." + name, g.detach().float().cpu()))
        return hook

    hooks = []
    for tower in ("online", "target"):
        net = getattr(state, tower)
        for i, layer in enumerate(net.encoder.encoder.layers):
            hooks.append(layer.register_forward_hook(
                keep(f"{tower}.layer{i}", grad=True)))
        hooks.append(net.encoder.register_forward_hook(
            keep(f"{tower}.pooled")))
        hooks.append(net.projector.register_forward_hook(
            keep(f"{tower}.projector")))
    hooks.append(state.online.predictor.register_forward_hook(
        keep("online.predictor")))
    return hooks


def _step(state, step, data, layers: bool = True) -> dict:
    """One step's record: with ``layers`` each layer's output and the
    gradient at it, the pooled embeddings and the heads' outputs; always
    grad_norm and every gradient in the ``model: 1`` layout."""
    rec = {}
    hooks = _record(state, rec) if layers else []
    m = step(state, data)
    for h in hooks:
        h.remove()
    rec["grad_norm"] = float(m["grad_norm"])
    rec["grads"] = {k: v.detach().float().cpu().clone() for k, v in
                    state.gathered(state.grads, "online").items()}
    return rec


def _compare(label: str, got: dict, ref: dict) -> None:
    cs.log(f"[tp divergence] {label}: grad_norm {got['grad_norm']} vs "
           f"{ref['grad_norm']}")
    for k in ref:
        if k not in ("grad_norm", "grads", "cancel") and k in got:
            cs.log(f"[tp divergence]   {k}: {_rel(got[k], ref[k]):.3e}")
    d = {k: float(((got["grads"][k] - g) ** 2).sum())
         for k, g in ref["grads"].items()}
    n = {k: float((g ** 2).sum()) for k, g in ref["grads"].items()}
    zero = sum(v for k, v in d.items() if k.endswith(ZERO))
    total = sum(d.values())
    cs.log(f"[tp divergence]   |Δg|²/|g|² {total / sum(n.values()):.3e}; "
           f"of |Δg|² in the exactly-zero gradients "
           f"{zero / max(total, 1e-30):.3e}")
    for k in sorted(d, key=d.get, reverse=True)[:12]:
        cs.log(f"[tp divergence]   {k}: |Δg|² {d[k]:.3e}, |g|² {n[k]:.3e}, "
               f"rel {(d[k] / max(n[k], 1e-30)) ** 0.5:.3e}")


def _per_tensor(label: str, got: dict, control: dict, ref: dict,
                name: str) -> None:
    """Each gradient tensor's ``|Δg| / |g|`` against ``ref``, of ``got``
    beside ``control``'s (the ``name`` control)."""
    rel = {}
    for k, g in ref["grads"].items():
        if k.endswith(ZERO):
            continue
        n = float(g.norm().clamp_min(1e-30))
        rel[k] = (float((got["grads"][k] - g).norm()) / n,
                  float((control["grads"][k] - g).norm()) / n)
    ratio = {k: a / max(b, 1e-30) for k, (a, b) in rel.items()}
    med = [float(torch.tensor([v[i] for v in rel.values()]).median())
           for i in (0, 1)]
    cs.log(f"[tp divergence] {label}: per tensor |Δg|/|g| median "
           f"{med[0]:.3e} (model: 2) vs {med[1]:.3e} ({name} control), "
           f"ratio median "
           f"{float(torch.tensor(list(ratio.values())).median()):.3f}; "
           f"{sum(r > 2 for r in ratio.values())} of {len(ratio)} tensors "
           f"moved more than twice the control's")
    for k in sorted(ratio, key=ratio.get, reverse=True)[:12]:
        cs.log(f"[tp divergence]   {k}: {rel[k][0]:.3e} vs {rel[k][1]:.3e} "
               f"({ratio[k]:.2f}x)")


def _gate_rows(label: str, got: dict, split: dict, gate: dict,
               ref: dict) -> None:
    """``|Δg| / |g|`` of each layer's ``gru_rel_pos_linear`` gradients
    in the sharded step and the two controls; then, for the weights and
    for the biases, the ratio of the sharded step's to the last
    control's over the layers: its median, and how many layers lie above
    twice and below half of it (layers whose gradient is 0, dropped by
    LayerDrop, left out); then each layer's gate bias cancellation (the
    one-rank run's) beside that ratio, and the ratio's median over the
    more cancelled half of the layers and over the rest."""
    ratios = {"weight": [], "bias": []}
    bias = {}
    for k, g in ref["grads"].items():
        if "gru_rel_pos_linear" not in k:
            continue
        n = float(g.norm().clamp_min(1e-30))
        a, b, c = (float((run["grads"][k] - g).norm()) / n
                   for run in (got, split, gate))
        cs.log(f"[tp divergence] {label}: {k}: model: 2 {a:.3e}, split "
               f"{b:.3e}, split + gate halves {c:.3e}")
        if float(g.norm()) > 0 and c > 0:
            ratios[k.rsplit(".", 1)[1]].append(a / c)
            if k.endswith(".bias"):
                bias[_layer_of(k)] = a / c
    for kind, r in ratios.items():
        if r:
            cs.log(f"[tp divergence] {label}: gru_rel_pos_linear.{kind} "
                   f"over {len(r)} layers, model: 2 / the gate-halves "
                   f"control: median {float(torch.tensor(r).median()):.3f}"
                   f", above 2x in {sum(x > 2 for x in r)}, below 0.5x in "
                   f"{sum(x < 0.5 for x in r)}")
    cancel = {i: c for i, c in ref.get("cancel", {}).items() if i in bias}
    if not cancel:
        return
    for i in sorted(cancel):
        cs.log(f"[tp divergence] {label}: layer {i} gate bias: |g| / "
               f"Σ|terms| {cancel[i]:.3e}, model: 2 / gate-halves control "
               f"{bias[i]:.3f}")
    order = sorted(cancel, key=cancel.get)
    half = len(order) // 2
    med = [float(torch.tensor([bias[i] for i in part]).median())
           for part in (order[:max(half, 1)], order[half:])]
    cs.log(f"[tp divergence] {label}: the gate bias's ratio to the "
           f"gate-halves control, median over the {max(half, 1)} layers of "
           f"most cancellation (|g| / Σ|terms| {cancel[order[0]]:.2e}–"
           f"{cancel[order[max(half, 1) - 1]]:.2e}) {med[0]:.3f}, over the "
           f"other {len(order) - half} {med[1]:.3f}")


def _layer_of(name: str) -> int:
    """The encoder layer of a parameter name (``...layers.<i>....``)."""
    parts = name.split(".")
    return int(parts[parts.index("layers") + 1])


class _GateTerms:
    """``torch.nn.functional`` as ``models.wavlm`` sees it, recording the
    cancellation in each online layer's gate bias gradient: the gradient
    at the gate projection's output ``[B, H, T, 8]`` summed over ``B, H,
    T`` (the bias's gradient) against the sum of its elements' magnitudes,
    in float64, as ``|g| / Σ|terms|`` over the 8 outputs; ``layer`` holds
    the index of the layer running (a forward pre-hook sets it)."""

    def __init__(self, out: dict):
        self.out, self.layer = out, None

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    def linear(self, x, weight, bias=None):
        y = torch.nn.functional.linear(x, weight, bias)
        if x.dim() == 4 and weight.shape[0] == 8 and y.requires_grad:
            layer = self.layer

            def hook(g):
                g = g.double()
                total = g.sum((0, 1, 2)).norm()
                terms = g.abs().sum((0, 1, 2)).norm()
                self.out[layer] = float(total / terms.clamp_min(1e-300))
            y.register_hook(hook)
        return y


class _GateHalves:
    """``torch.nn.functional`` as ``models.wavlm`` sees it, with the
    gate's projection (``F.linear`` of ``[B, H, T, head_dim]`` to 8
    outputs) taken as two products over the halves of the heads, the
    weight and bias reaching each through float32: each half's weight and
    bias gradient is rounded to bf16 and the two are added in float32, as
    ``copy_to_model`` adds the two ranks' at model: 2 (the sum is rounded
    to bf16 once more on its way to the float32 parameter, as one rank
    rounds its own sum once)."""

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    @staticmethod
    def linear(x, weight, bias=None):
        linear = torch.nn.functional.linear
        if x.dim() != 4 or weight.shape[0] != 8 or bias is None:
            return linear(x, weight, bias)
        h = x.shape[1] // 2
        w32, b32 = weight.float(), bias.float()
        return torch.cat([linear(part, w32.to(x.dtype), b32.to(x.dtype))
                          for part in (x[:, :h], x[:, h:])], dim=1)


def _heads_on_running_stats(state) -> None:
    for head in (state.online.projector, state.online.predictor,
                 state.target.projector):
        head.eval()


def _reference(key: str, cfg, sd, device, step, data, running: bool,
               steps: int) -> list:
    """``steps`` steps of one rank at ``model: 1``: as it is (``ref``,
    with each layer's gate bias cancellation), with cuBLAS's
    reduced-precision bf16 reductions off (``cublas``), with each
    projection in two float32 halves (``split``), or with that and the
    gate's gradients summed over two halves of the heads (``gate``)."""
    matmul = torch.backends.cuda.matmul
    linear, functional = wavlm_module._linear, wavlm_module.F
    matmul.allow_bf16_reduced_precision_reduction = key != "cublas"
    if key in ("split", "gate"):
        wavlm_module._linear = cs._split_linear
    if key == "gate":
        wavlm_module.F = _GateHalves()
    cancel = {}
    if key == "ref":
        wavlm_module.F = terms = _GateTerms(cancel)
    try:
        st = cs._byol_state(cfg, sd, device, 1024, 2048)
        if running:
            _heads_on_running_stats(st)
        if key == "ref":
            for i, layer in enumerate(st.online.encoder.encoder.layers):
                layer.register_forward_pre_hook(
                    lambda m, a, i=i: setattr(terms, "layer", i))
        out = []
        for k in range(steps):
            cancel.clear()
            rec = _step(st, step, data, layers=k == 0)
            rec["cancel"] = dict(cancel)
            out.append(rec)
        return out
    finally:
        matmul.allow_bf16_reduced_precision_reduction = True
        wavlm_module._linear, wavlm_module.F = linear, functional


def worker(rank: int, world: int, device: str, layers: int,
           running: bool, steps: int) -> None:
    device = cs._rank_device(device)
    data = cs._train_batch(cs.TRAIN_BATCH, cs.CLIP_SECONDS, device)
    # eager: the runs hook the modules, which a replay does not call
    step = cs.make_byol_train_step(cs._adamw_spec(), graphs=False)
    mesh = make_mesh(model=world, device=device, heads=16)
    full = WavLMConfig.large(num_hidden_layers=layers)
    heads = "running statistics" if running else "batch statistics"
    for name, cfg in (("off", cs._quiet(full)), ("on", full)):
        sd = cs.with_random_biases(cs.init_byol_state_dict(
            cfg, 1024, 2048, torch.Generator().manual_seed(cs.SEED)),
            cs.SEED)
        refs = {}
        if rank == 0:
            for key in ("ref", "cublas", "split", "gate"):
                refs[key] = _reference(key, cfg, sd, device, step, data,
                                       running, steps)
        dist.barrier()
        st = cs._byol_state(cfg, sd, device, 1024, 2048, mesh)
        if running:
            _heads_on_running_stats(st)
        runs = [_step(st, step, data, layers=k == 0) for k in range(steps)]
        for k, got in enumerate(runs):
            if rank != 0:
                break
            ref = {key: r[k] for key, r in refs.items()}
            label = (f"features {name}, {layers} layers, heads' BN on "
                     f"{heads}, step {k + 1} of {steps}")
            _compare(f"{label}, model: 2 against model: 1", got, ref["ref"])
            _compare(f"{label}, the control: model: 1 without "
                     "reduced-precision bf16 reductions", ref["cublas"],
                     ref["ref"])
            _compare(f"{label}, the control: model: 1 with each projection "
                     "in two float32 halves", ref["split"], ref["ref"])
            _compare(f"{label}, the control: model: 1 with each projection "
                     "in two float32 halves and the gate's gradients summed "
                     "over two halves of the heads", ref["gate"],
                     ref["ref"])
            _per_tensor(label, got, ref["split"], ref["ref"],
                        "split-projection")
            _per_tensor(label, got, ref["gate"], ref["ref"],
                        "split-projection and gate-halves")
            _gate_rows(label, got, ref["split"], ref["gate"], ref["ref"])
        del st, runs, refs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("layers", type=int, nargs="?", default=24)
    parser.add_argument("--running-stats", action="store_true")
    parser.add_argument("--steps", type=int, default=STEPS)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    cs.phase_device()
    cs.phase_build()
    run_ranks(worker, 2, ("cuda:0", args.layers, args.running_stats,
                          args.steps), threads=0, timeout=1500)
    return 0


if __name__ == "__main__":
    sys.exit(main())
