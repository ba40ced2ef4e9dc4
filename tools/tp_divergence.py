"""Where the tensor-parallel BYOL step departs from one rank's, on one card.

Two ranks share the card over gloo at ``{data: 1, model: 2}``; rank 0
first runs the same first step at ``model: 1`` from the same weights
(WavLM-large, ``chip_smoke.py``'s batch of 36 × 5 s, random features
off and then on).  For each configuration it prints:

  * the relative distance ``|a − b| / |b|`` of each encoder layer's
    output, the pooled embeddings, the projector's and the predictor's
    outputs of both towers, and of the gradient at each layer's output;
  * grad_norm of both, ``|Δg|² / |g|²`` over every gradient, the share of
    the gradients that are 0 in exact arithmetic, and the twelve
    parameters whose gradients differ most;
  * the same against a second one-rank run with cuBLAS's reduced-precision
    bf16 reductions off, a control of the library's own variation.

Run from the root of a checkout, on a machine with the card:

    python3 tools/tp_divergence.py [layers]

(``layers`` cuts the encoder's depth; default 24).
"""

import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from nrse_tpu_torch.models.wavlm import WavLMConfig  # noqa: E402
from nrse_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from nrse_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

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


def _step(state, step, data) -> dict:
    rec = {}
    hooks = _record(state, rec)
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
        if k not in ("grad_norm", "grads") and k in got:
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


def worker(rank: int, world: int, device: str, layers: int) -> None:
    device = cs._rank_device(device)
    data = cs._train_batch(cs.TRAIN_BATCH, cs.CLIP_SECONDS, device)
    step = cs.make_byol_train_step(cs._adamw_spec())
    mesh = make_mesh(model=world, device=device, heads=16)
    full = WavLMConfig.large(num_hidden_layers=layers)
    for name, cfg in (("off", cs._quiet(full)), ("on", full)):
        sd = cs.init_byol_state_dict(cfg, 1024, 2048,
                                     torch.Generator().manual_seed(cs.SEED))
        refs = {}
        if rank == 0:
            for reduced in (True, False):
                torch.backends.cuda.matmul\
                    .allow_bf16_reduced_precision_reduction = reduced
                st = cs._byol_state(cfg, sd, device, 1024, 2048)
                refs[reduced] = _step(st, step, data)
                del st
            torch.backends.cuda.matmul\
                .allow_bf16_reduced_precision_reduction = True
        dist.barrier()
        st = cs._byol_state(cfg, sd, device, 1024, 2048, mesh)
        got = _step(st, step, data)
        if rank == 0:
            _compare(f"features {name}, {layers} layers, model: 2 against "
                     "model: 1", got, refs[True])
            _compare(f"features {name}, the control: model: 1 without "
                     "reduced-precision bf16 reductions", refs[False],
                     refs[True])
        del st, got, refs


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cs.phase_device()
    cs.phase_build()
    run_ranks(worker, 2, ("cuda:0", int(argv[0]) if argv else 24),
              threads=0, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
