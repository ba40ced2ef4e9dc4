"""One tiny BYOL step over N gloo ranks on the CPU, data-parallel and
tensor-parallel.

The port of ``__graft_entry__.py::dryrun_multichip``: its data-parallel
half (a ``{data: N, model: 1}`` mesh) and its tensor-parallel half (``{data:
N/2, model: 2}``, for an even N; JAX's runs ``{data: 4, model: 2}`` on 8
devices, ``MULTICHIP_r05.json``).

    python -m nrse_tpu_torch.parallel.dryrun [N]

Each rank builds the tiny BYOL model from one seed with dropout, LayerDrop
and SpecAugment on (under the model axis, its shards of every layer),
keeps its data coordinate's rows of one global batch of ``2·N`` clips and
takes one train step; the ranks must report one loss, finite, and
replicas that agree (``train.byol_trainer.replicas_agree``: every rank in
the replicated state, each data group in its shards).
:func:`collectives_check` holds the collectives the data-parallel path
uses (``all_reduce`` sum and max, ``broadcast``) to their results on the
tensors of a device.
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from nrse_tpu_torch.models.convert import init_byol_state_dict
from nrse_tpu_torch.models.wavlm import WavLMConfig
from nrse_tpu_torch.ops.fused_optimizer import FusedAdamWSpec
from nrse_tpu_torch.parallel.distributed import all_reduce_sum
from nrse_tpu_torch.parallel.launch import run_ranks
from nrse_tpu_torch.parallel.mesh import make_mesh, shard_batch
from nrse_tpu_torch.train.byol_trainer import (
    create_train_state,
    make_byol_train_step,
    replicas_agree,
)

PROJ, PRED, SAMPLES = 32, 64, 4800  # 0.3 s: 239 tiny frames


def global_batch(n: int, seed: int = 0) -> Dict[str, torch.Tensor]:
    """``n`` clips of tones in noise, noise, and SNRs."""
    rng = np.random.default_rng(seed)
    ax = np.arange(SAMPLES) / 16000.0
    clean = (0.3 * np.sin(2 * np.pi * rng.uniform(80, 300, (n, 1)) * ax)
             + 0.02 * rng.standard_normal((n, SAMPLES)))
    noise = 0.2 * rng.standard_normal((n, SAMPLES))
    snr = rng.choice([2.0, 5.0, 10.0, 20.0], n)
    return {k: torch.from_numpy(v.astype(np.float32))
            for k, v in (("clean", clean), ("noise", noise), ("snr", snr))}


def _rank_step(rank: int, world: int, model: int = 1) -> Dict:
    cfg = WavLMConfig.tiny()  # dropout, LayerDrop, SpecAugment on
    mesh = make_mesh(model=model, device="cpu",
                     heads=cfg.num_attention_heads)
    state = create_train_state(
        cfg, init_byol_state_dict(cfg, PROJ, PRED,
                                  torch.Generator().manual_seed(0)),
        PROJ, PRED, "cpu", seed=0, mesh=mesh)
    step = make_byol_train_step(FusedAdamWSpec(schedule=1e-4))
    m = step(state, shard_batch(mesh, global_batch(2 * world)))
    return {"rank": rank, "loss": float(m["loss"]),
            "finite": bool(m["finite"]),
            "layers": (m["layers_online"], m["layers_target"]),
            "agree": replicas_agree(state)}


def collectives_check(rank: int, world: int, device: str) -> Dict:
    """The data-parallel path's collectives on ``device`` tensors in this
    rank's group: ``all_reduce`` sum of float32 and float64, ``all_reduce``
    max of int64, ``broadcast`` from rank 0, and the reduction with a
    gradient through a backward pass; raises where one gives a wrong
    result."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    got = {}
    for dtype in (torch.float32, torch.float64):
        x = torch.arange(5, dtype=dtype, device=dev) * (rank + 1)
        dist.all_reduce(x)
        want = torch.arange(5, dtype=dtype) * (world * (world + 1) // 2)
        got[f"sum_{dtype}"] = torch.equal(x.cpu(), want)
    m = torch.tensor([rank, -rank], dtype=torch.int64, device=dev)
    dist.all_reduce(m, op=dist.ReduceOp.MAX)
    got["max_int64"] = m.cpu().tolist() == [world - 1, 0]
    b = torch.full((3,), float(rank + 7), device=dev)
    dist.broadcast(b, 0)
    got["broadcast"] = bool((b.cpu() == 7.0).all())
    # the reduction with a gradient: y = world·x on every rank, each rank's
    # loss y·y, so x's gradient is 2·world²·x (the backward sums too)
    x = torch.arange(4.0, device=dev).requires_grad_()
    y = all_reduce_sum(x, make_mesh(device=dev))
    (y * y).sum().backward()
    got["backward"] = torch.equal(x.grad.cpu(),
                                  2.0 * world * world * torch.arange(4.0))
    if not all(got.values()):
        raise RuntimeError(f"rank {rank}: collectives on {device} over "
                           f"{dist.get_backend()}: {got}")
    return {"rank": rank, "backend": dist.get_backend(), "device": device,
            **got}


def dryrun_multiprocess(n: int, model: int = 1) -> Dict:
    """One step of the tiny BYOL model over ``n`` gloo ranks on the CPU at
    ``{data: n / model, model: model}``; raises unless every rank's loss is
    one finite value and the replicas agree.  Returns rank 0's report."""
    reports = run_ranks(_rank_step, n, (model,))
    losses = {r["loss"] for r in reports}
    if len(losses) != 1 or not all(r["finite"] and r["agree"]
                                   for r in reports):
        raise RuntimeError(f"the ranks disagree: {reports}")
    print(f"dryrun_multiprocess({n}, mesh={{'data': {n // model}, 'model': "
          f"{model}}}): loss={reports[0]['loss']:.4f} layers run "
          f"{reports[0]['layers']} OK", flush=True)
    return reports[0]


def main(n: int) -> None:
    """The data-parallel half over ``n`` ranks, then the tensor-parallel
    half at ``{data: n/2, model: 2}`` where ``n`` is even."""
    dryrun_multiprocess(n)
    if n % 2 == 0:
        dryrun_multiprocess(n, model=2)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
