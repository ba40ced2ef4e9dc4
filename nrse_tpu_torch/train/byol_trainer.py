"""The BYOL training step and eval step.

Port of ``nrse_tpu/train/byol_trainer.py:41-235`` with the JAX package's
fused optimizer (``fused_optimizer: FusedAdamWSpec``).  One train step:

  1. the two views on the device (``audio.augment.make_byol_views``);
  2. the online tower in training mode on the clean view;
  3. the target tower in training mode on the noisy view, without
     gradients, on its own random streams (the ``fold_in(·, 1)`` of
     ``nrse_tpu/models/byol.py:206-208``); its BatchNorm statistics advance
     too;
  4. ``byol_loss(pred, proj, weights=valid)``;
  5. the backward pass, into one flat float32 gradient buffer;
  6. ``grad_norm``, the global L2 norm of the online gradients;
  7. one K4 pass (``ops.fused_optimizer``): clip-scaled AdamW over every
     online parameter and the EMA of the target over the encoder and
     projector, in that order (``byol_trainer.py:129-144``).

The state keeps the online parameters, their gradients, ``mu``, ``nu`` and
the target's parameters as flat float32 buffers, the modules' parameters
and ``.grad`` being views into them; online order encoder, projector,
predictor, so the target is a prefix.  The random streams of a step come
from (root seed, step, tower) on the host (``models.wavlm.TrainRNG``).

Data parallelism (a state made with a ``parallel.mesh.DataMesh``): each
rank runs the step on its rows of the global batch; the loss is its part
of the global batch's (the global weight sum), the heads' BatchNorm takes
the global batch's statistics, and after the backward one ``all_reduce``
sums the flat gradient buffer, so ``grad_norm`` and K4 see the global
batch's gradient on every rank and the replicas stay bit-identical (what
the JAX package's GSPMD step computes on an N-wide ``data`` mesh,
``nrse_tpu/train/byol_trainer.py:19-20``).  No
``DistributedDataParallel``: its buckets would replace the ``.grad`` views
of the flat buffer K4 reads whole, and its averaging would divide by the
world size on top of the global denominators.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from nrse_tpu_torch.audio.augment import make_byol_views
from nrse_tpu_torch.models.byol import (
    ONLINE,
    TARGET,
    OnlineNetwork,
    TargetNetwork,
    byol_loss,
    byol_loss_per_sample,
    make_target,
)
from nrse_tpu_torch.models.heads import use_mesh
from nrse_tpu_torch.models.wavlm import TrainRNG, WavLMConfig
from nrse_tpu_torch.ops.fused_optimizer import (
    FusedAdamWSpec,
    fused_adamw_ema_update,
)
from nrse_tpu_torch.parallel.mesh import DataMesh
from nrse_tpu_torch.parallel.mesh import broadcast_state as _broadcast
from nrse_tpu_torch.parallel.mesh import replicas_agree as _replicas_agree


@dataclasses.dataclass
class BYOLTrainState:
    """Everything the train step carries.  ``step`` is also the Adam step
    count; ``seed`` is the root of every random stream; ``mesh`` the data
    mesh (None: one process)."""

    online: OnlineNetwork
    target: TargetNetwork
    params: torch.Tensor         # flat online parameters
    grads: torch.Tensor          # flat, the parameters' .grad
    mu: torch.Tensor
    nu: torch.Tensor
    target_params: torch.Tensor  # flat target parameters (a prefix's EMA)
    step: int = 0
    seed: int = 0
    mesh: Optional[DataMesh] = None

    def tensors(self) -> Dict[str, torch.Tensor]:
        """The tensors a checkpoint holds and the replicas share, by name:
        ``params``, ``mu``, ``nu``, ``target_params`` and each tower's
        buffers (``online.<name>``, ``target.<name>``: the BatchNorm
        running statistics)."""
        out = {k: getattr(self, k)
               for k in ("params", "mu", "nu", "target_params")}
        for tower, module in (("online", self.online),
                              ("target", self.target)):
            for name, buf in module.named_buffers():
                out[f"{tower}.{name}"] = buf
        return out


def flatten_params(params: List[nn.Parameter], device) -> torch.Tensor:
    """One float32 buffer holding ``params``, which become views of it."""
    flat = torch.empty(sum(p.numel() for p in params), dtype=torch.float32,
                       device=device)
    off = 0
    for p in params:
        n = p.numel()
        flat[off:off + n].copy_(p.detach().reshape(-1))
        p.data = flat[off:off + n].view_as(p)
        off += n
    return flat


def _load(module: nn.Module, state_dict: Mapping, device) -> nn.Module:
    # copies: the module's buffers (BatchNorm statistics) advance in place,
    # and must not write through into the caller's state dict
    sd = {k: torch.as_tensor(v).to(device=device, dtype=torch.float32,
                                   copy=True)
          for k, v in state_dict.items()}
    module.load_state_dict(sd, strict=True, assign=True)
    return module


def create_train_state(config: WavLMConfig, online_state_dict: Mapping,
                       projection_dim: int = 1024,
                       prediction_dim: int = 2048, device="cuda",
                       seed: int = 0,
                       target_state_dict: Optional[Mapping] = None,
                       compute_dtype: Optional[torch.dtype] = None,
                       mesh: Optional[DataMesh] = None) -> BYOLTrainState:
    """The state at step 0: float32 parameters on ``device`` (computing in
    ``compute_dtype``, default float32), the target a real copy of the
    online encoder and projector unless ``target_state_dict`` is given,
    ``mu = nu = 0``.  With a ``mesh``, the heads' BatchNorms take global
    statistics, and every rank starts from rank 0's state."""
    device = torch.device(device)
    online = _load(OnlineNetwork(config, projection_dim, prediction_dim,
                                 device="meta", compute_dtype=compute_dtype),
                   online_state_dict, device)
    if target_state_dict is None:
        target = make_target(online)
    else:
        target = _load(TargetNetwork(config, projection_dim, device="meta",
                                     compute_dtype=compute_dtype),
                       target_state_dict, device)
    target.requires_grad_(False)
    online_params = list(online.named_parameters())
    target_params = list(target.named_parameters())
    if [(n, p.shape) for n, p in online_params[:len(target_params)]] != \
            [(n, p.shape) for n, p in target_params]:
        raise ValueError("the target's parameters are not a prefix of the "
                         "online tower's")
    params = flatten_params([p for _, p in online_params], device)
    grads = torch.zeros_like(params)
    off = 0
    for _, p in online_params:
        p.grad = grads[off:off + p.numel()].view_as(p)
        off += p.numel()
    state = BYOLTrainState(
        online=online.train(), target=target.train(), params=params,
        grads=grads, mu=torch.zeros_like(params),
        nu=torch.zeros_like(params),
        target_params=flatten_params([p for _, p in target_params], device),
        seed=seed, mesh=mesh)
    if mesh is not None:
        use_mesh(online, mesh)
        use_mesh(target, mesh)
        broadcast_state(state)
    return state


def broadcast_state(state: BYOLTrainState) -> None:
    """Rank 0's state on every rank of the state's mesh (at the start and
    after a resume)."""
    if state.mesh is not None:
        _broadcast(state.mesh, state.tensors().values())


def replicas_agree(state: BYOLTrainState) -> bool:
    """True when every rank of the state's mesh holds the same bits in
    its flat buffers and BatchNorm statistics (one ``all_reduce`` of their
    checksums)."""
    if state.mesh is None:
        return True
    return _replicas_agree(state.mesh, state.tensors().values())


def make_byol_train_step(spec: FusedAdamWSpec
                         ) -> Callable[[BYOLTrainState, Dict], Dict]:
    """``train_step(state, batch) → metrics`` for ``batch = {"clean":
    [B, T], "noise": [B, T], "snr": [B]}`` on the state's device.  Updates
    the state in place.  The towers run in the modes they are in (the
    state is made in training mode).  The metrics ``loss``, ``grad_norm``,
    ``valid_fraction`` and ``finite`` are device tensors (nothing waits for
    the card), of the global batch under a mesh; ``layers_online`` and
    ``layers_target`` count the layers each tower ran under LayerDrop.
    Under a mesh ``batch`` holds this rank's rows."""

    def train_step(state: BYOLTrainState, batch: Dict) -> Dict:
        online, target, mesh = state.online, state.target, state.mesh
        rank, world = (mesh.rank, mesh.world) if mesh else (0, 1)
        clean, noisy, valid = make_byol_views(batch["clean"], batch["noise"],
                                              batch["snr"])
        state.grads.zero_()
        pred, _, _ = online(clean, TrainRNG(state.seed, state.step, ONLINE,
                                            rank, world))
        layers_online = online.encoder.encoder.layers_run
        with torch.no_grad():
            proj, _ = target(noisy, TrainRNG(state.seed, state.step, TARGET,
                                             rank, world))
        layers_target = target.encoder.encoder.layers_run
        loss = byol_loss(pred, proj, weights=valid, mesh=mesh)
        loss.backward()
        with torch.no_grad():
            loss = loss.detach()
            valid_fraction = valid.float().mean()
            if mesh is not None and mesh.distributed:
                dist.all_reduce(state.grads, group=mesh.group)
                pooled = torch.stack([loss, valid_fraction / world])
                dist.all_reduce(pooled, group=mesh.group)
                loss, valid_fraction = pooled[0], pooled[1]
            grad_norm = torch.linalg.vector_norm(state.grads)
            fused_adamw_ema_update(state.grads, state.params, state.mu,
                                   state.nu, state.target_params, spec,
                                   state.step, grad_norm)
        state.step += 1
        return {"loss": loss, "grad_norm": grad_norm,
                "valid_fraction": valid_fraction,
                "finite": torch.isfinite(loss) & torch.isfinite(grad_norm),
                "layers_online": layers_online,
                "layers_target": layers_target}

    return train_step


def make_byol_eval_step(embeddings: bool = False
                        ) -> Callable[[BYOLTrainState, Dict], Tuple]:
    """``eval_step(state, batch) → (loss [B], similarity [B])``: the BYOL
    loss per sample and the clean↔noisy cosine of the online encoder's
    pooled embeddings, from three encoder forwards in eval mode
    (``byol_trainer.py:183-235``).  With ``embeddings``, also those pooled
    clean and noisy embeddings ``[B, C]`` in float32, which JAX's
    ``make_byol_embed_step`` (``:238-261``) computes in a pass of its
    own."""

    @torch.no_grad()
    def eval_step(state: BYOLTrainState, batch: Dict):
        online, target = state.online, state.target
        modes = [(m, m.training) for m in online.modules()] + \
            [(m, m.training) for m in target.modules()]
        online.eval()
        target.eval()
        clean, noisy, _ = make_byol_views(batch["clean"], batch["noise"],
                                          batch["snr"])
        clean_emb = online.encoder(clean)[1].float()
        noisy_emb = online.encoder(noisy)[1].float()
        pred, _ = online.heads(clean_emb)
        proj = target.projector(target.encoder(noisy)[1].float())
        loss = byol_loss_per_sample(pred, proj)
        for m, training in modes:  # the train step finds its modes again
            m.training = training

        def unit(e):
            return e / torch.clamp_min(
                torch.linalg.vector_norm(e, dim=1, keepdim=True), 1e-10)

        sim = (unit(clean_emb) * unit(noisy_emb)).sum(1)
        if embeddings:
            return loss, sim, clean_emb, noisy_emb
        return loss, sim

    return eval_step
