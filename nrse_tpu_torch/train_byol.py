"""BYOL pretraining on one GPU or data-parallel over several: the port of
``train_byol.py:27-278``.

    python -m nrse_tpu_torch.train_byol --config <yaml or preset name> \\
        [--device cuda|cpu] [--batch_size N] [--epochs N] [--lr X] [--resume]
    torchrun --nproc_per_node=N -m nrse_tpu_torch.train_byol --config ...

A preset name resolves to the port's own copy of the JAX package's BYOL
presets (``nrse_tpu_torch/config/presets/*.yaml``); ``--config`` also
takes any YAML path, the JAX package's presets included.  The file loads
through ``config.config_utils.load_config`` (PyYAML, imported when a file
is read), with the JAX loader's defaults for the keys used here;
:func:`main` takes the config as a dict, so a caller needs no YAML.  The
orchestration is the JAX entry point's, in its order: seeds, loaders
(``data.loader``), the train state (seeded random weights,
``models.convert.init_byol_state_dict``) with AdamW + EMA
(``ops.fused_optimizer.FusedAdamWSpec``) on a cosine schedule over
``len(train_loader) × num_epochs`` steps, resume from the latest
checkpoint, then per epoch: the train step fed by the device prefetcher
(losses kept on the device until the epoch ends), validation
(``eval.evaluate_byol.validate_model``), early stopping, and the
``best_val_loss``, ``best_val_similarity`` and ``last_model`` checkpoints
(``train.checkpoint``; ``training.save_checkpoints: false`` skips them),
a ``utils.profiling.ThroughputMeter`` per epoch, experiment tracking
through ``utils.wandb_utils.get_wandb`` (disabled in every preset), and
the t-SNE plot of the embeddings (``eval.evaluate_byol.
visualize_embeddings``) every ``logging.visualization_interval`` epochs
and at the last one, into ``training.log_dir``.  Where scikit-learn or
matplotlib is absent (the card's machine has neither) the entry point
says once that the plot is skipped and why, and goes on: the plot is
host-side.

One process on one card (``device: cuda``, computing in bf16, the type
the kernels take) or on the CPU (float32, the plain paths), or N ranks,
one card each (``parallel``): the group is joined from the
``tpu.distributed`` block or torchrun's environment
(``parallel.distributed.maybe_initialize``), ``tpu.mesh`` must span every
rank, ``training.batch_size`` is the global batch and must divide over
the ranks; each rank loads its shard at the per-rank batch, the step
reduces gradients and statistics over the global batch, validation pools
its sums, and rank 0's early-stopping decision is broadcast.  Only rank 0
logs to wandb, writes checkpoints and prints the epoch lines; every rank
waits after a checkpoint.  The t-SNE plot is drawn only by a run of one
process, as in the JAX entry point.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
import time
from typing import Any, Dict, Optional

import torch

from nrse_tpu_torch.config.config_utils import (  # noqa: F401 (re-exported)
    PRESET_DIR,
    load_config,
    validate_config,
)
from nrse_tpu_torch.data.loader import DevicePrefetcher, create_dataloaders
from nrse_tpu_torch.eval.evaluate_byol import (
    validate_model,
    visualize_embeddings,
)
from nrse_tpu_torch.models.convert import init_byol_state_dict
from nrse_tpu_torch.models.wavlm import WavLMConfig
from nrse_tpu_torch.ops.fused_optimizer import FusedAdamWSpec
from nrse_tpu_torch.parallel.distributed import (
    barrier,
    broadcast_scalar,
    is_primary,
    maybe_initialize,
)
from nrse_tpu_torch.parallel.mesh import mesh_from_config
from nrse_tpu_torch.runtime.device import resolve_device
from nrse_tpu_torch.runtime.native import native_available
from nrse_tpu_torch.train.byol_trainer import (
    broadcast_state,
    create_train_state,
    make_byol_train_step,
)
from nrse_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from nrse_tpu_torch.train.early_stopping import EarlyStopping
from nrse_tpu_torch.train.schedules import cosine_annealing
from nrse_tpu_torch.utils.logging_utils import logger, setup_logger
from nrse_tpu_torch.utils.profiling import ThroughputMeter
from nrse_tpu_torch.utils.setup_utils import set_seed
from nrse_tpu_torch.utils.wandb_utils import get_wandb


def with_defaults(config: Dict[str, Any]) -> Dict[str, Any]:
    """A copy of ``config`` with the JAX loader's defaults filled in and
    ``device`` (default ``cuda``): ``config_utils.validate_config``."""
    return validate_config(copy.deepcopy(config))


def main(config: Dict[str, Any],
         encoder: Optional[WavLMConfig] = None) -> Dict[str, Any]:
    """Pretrain with ``config`` (the YAML layout, as a dict).  ``encoder``
    replaces the encoder that ``model.name`` names (e.g. a shallower one).

    Returns ``{"state": the BYOLTrainState, "epochs": [per-epoch metrics],
    "decoder": "native" or "python", "stopped_early": bool}``; each epoch's
    metrics hold ``epoch``, ``train_loss``, ``val_loss``,
    ``val_avg_similarity``, ``val_similarities``, ``steps``, ``s_per_step``
    and ``audio_sec_per_sec`` (host clock over the epoch's train steps,
    data loading included), ``step_time_s`` and
    ``audio_sec_per_sec_per_chip`` (the epoch's ``ThroughputMeter`` over
    the ranks' cards, as the JAX entry point logs them) and ``tsne`` (the
    plot's path, or None).

    Joins the group the config or torchrun's environment describes, and
    leaves it at the end if it joined it here."""
    config = with_defaults(config)
    joined = maybe_initialize(config)
    try:
        return _main(config, encoder)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _main(config: Dict[str, Any],
          encoder: Optional[WavLMConfig]) -> Dict[str, Any]:
    setup_logger(config)
    tr, data_cfg, model_cfg = (config["training"], config["data"],
                               config["model"])
    seed = int(tr["seed"])
    set_seed(seed)
    mesh = mesh_from_config(config, resolve_device(config["device"]))
    device = mesh.device
    if device.type == "cuda" and mesh.distributed:
        torch.cuda.set_device(device)
    batch_size = tr["batch_size"]
    mesh.local_batch(batch_size)  # the global batch divides over the ranks
    primary = is_primary()
    ckpt_dir = tr["checkpoint_dir"]
    os.makedirs(ckpt_dir, exist_ok=True)
    os.makedirs(tr["log_dir"], exist_ok=True)
    # experiment tracking only on rank 0
    wandb_mode = config["logging"]["wandb_mode"] if primary else "disabled"
    wandb = get_wandb(wandb_mode)
    wandb.init(project="noise-robust-speech-embeddings", config=config,
               mode=wandb_mode)

    # the loaders decode with the native C++ runtime where it loads
    decoder = "native" if native_available() else "python"
    logger.info(f"audio decoder: {decoder}")
    train_loader, val_loader = create_dataloaders(config)
    prefetch = int(config.get("tpu", {}).get("prefetch_depth", 2))

    enc = encoder or WavLMConfig.from_model_name(model_cfg["name"])
    num_epochs = int(tr["num_epochs"])
    total_steps = len(train_loader) * num_epochs
    lr = tr["learning_rate"]
    schedule = cosine_annealing(lr, total_steps) if total_steps else lr
    proj, pred = model_cfg["projection_dim"], model_cfg["prediction_dim"]
    state = create_train_state(
        enc, init_byol_state_dict(enc, proj, pred,
                                  torch.Generator().manual_seed(seed)),
        proj, pred, device, seed=seed,
        compute_dtype=torch.bfloat16 if device.type == "cuda"
        else torch.float32, mesh=mesh if mesh.distributed else None)
    spec = FusedAdamWSpec(schedule=schedule,
                          weight_decay=tr["weight_decay"],
                          ema_decay=model_cfg["ema_decay"])

    start_epoch, resumed_best = 0, {}
    if config.get("resume"):
        name = latest_checkpoint(ckpt_dir)
        if name:
            state, meta = restore_checkpoint(ckpt_dir, name, state)
            start_epoch = int(meta.get("epoch", -1)) + 1
            resumed_best = meta.get("best", {})
            broadcast_state(state)  # every rank from rank 0's bits
            logger.info(f"resumed from {name} at epoch {start_epoch}, step "
                        f"{state.step}")

    train_step = make_byol_train_step(spec)
    metric = tr["early_stopping_metric"]
    early_stopping = EarlyStopping(
        patience=tr["early_stopping_patience"],
        mode="min" if metric == "val_loss" else "max",
        min_delta=tr["early_stopping_min_delta"])
    best_val_loss = resumed_best.get("val_loss", float("inf"))
    best_val_similarity = resumed_best.get("val_similarity", 0.0)
    clip_seconds = data_cfg["max_audio_length"]
    save_ckpts = tr.get("save_checkpoints", True)
    history, stopped, plot = [], False, True

    for epoch in range(start_epoch, num_epochs):
        # losses stay on the device until the epoch ends: a float() per
        # step would make the host wait for the card every step
        step_losses = []
        meter = ThroughputMeter(n_chips=mesh.world)
        t0 = time.perf_counter()
        for batch in DevicePrefetcher(train_loader, device, prefetch):
            batch.pop("__count__")
            step_losses.append(train_step(state, batch)["loss"])
            meter.update(batch_size, clip_seconds)
        epoch_loss = float(torch.stack(step_losses).mean()) \
            if step_losses else 0.0
        dt = time.perf_counter() - t0
        steps = len(step_losses)
        s_per_step = dt / max(steps, 1)

        val_loss, val_metrics = validate_model(state, val_loader, config)
        record = {"epoch": epoch, "train_loss": epoch_loss,
                  "val_loss": val_loss,
                  "val_avg_similarity": val_metrics["val_avg_similarity"],
                  "val_similarities": val_metrics["val_similarities"],
                  "steps": steps, "s_per_step": s_per_step,
                  "audio_sec_per_sec":
                      batch_size * clip_seconds / s_per_step if steps
                      else 0.0,
                  "audio_sec_per_sec_per_chip":
                      meter.audio_sec_per_sec_per_chip,
                  "step_time_s": meter.step_time, "tsne": None}
        history.append(record)
        logger.info(f"epoch {epoch}: {record}")
        wandb.log({k: v for k, v in record.items()
                   if k not in ("val_similarities", "tsne")}
                  | {f"val_similarity_snr_{snr}": sim for snr, sim
                     in val_metrics["val_similarities"].items()})
        if primary:
            print(f"Epoch {epoch + 1}/{num_epochs} - Train Loss: "
                  f"{epoch_loss:.4f}, Val Loss: {val_loss:.4f}, Val Avg "
                  f"Similarity: {val_metrics['val_avg_similarity']:.4f}, "
                  f"{record['audio_sec_per_sec']:.1f} audio-sec/sec",
                  flush=True)

        stop_value = val_loss if metric == "val_loss" else \
            val_metrics["val_avg_similarity"]
        stop = early_stopping(stop_value)
        if mesh.world > 1:  # one decision for every rank: rank 0's
            stop = broadcast_scalar(1.0 if stop else 0.0) > 0.5

        viz_every = config["logging"]["visualization_interval"]
        # a single-process plot, as in the JAX entry point
        if plot and mesh.world == 1 and (
                (epoch + 1) % viz_every == 0 or epoch == num_epochs - 1):
            try:
                record["tsne"] = visualize_embeddings(
                    state, val_loader, tr["log_dir"],
                    f"tsne_embeddings_epoch_{epoch + 1}.png")
                wandb.log({"embeddings": wandb.Image(record["tsne"])})
            except ImportError as e:  # host-side only: the run goes on
                plot = False
                msg = (f"t-SNE plot of the embeddings skipped for this run:"
                       f" {e.name or e} is not installed")
                logger.warning(msg)
                print(msg, flush=True)

        meta = {"epoch": epoch, "loss": val_loss,
                "similarity": val_metrics["val_avg_similarity"],
                "best": {"val_loss": min(best_val_loss, val_loss),
                         "val_similarity": max(
                             best_val_similarity,
                             val_metrics["val_avg_similarity"])}}
        # the replicas are equal and the pooled metrics too: rank 0 saves
        # what every rank holds
        saves = []
        if val_loss < best_val_loss:
            best_val_loss = val_loss
            saves.append(("best_val_loss", "Saved best model checkpoint with "
                          f"validation loss: {best_val_loss:.4f}"))
        if val_metrics["val_avg_similarity"] > best_val_similarity:
            best_val_similarity = val_metrics["val_avg_similarity"]
            saves.append(("best_val_similarity", "Saved best model "
                          "checkpoint with validation similarity: "
                          f"{best_val_similarity:.4f}"))
        saves.append(("last_model", None))
        if save_ckpts:
            for name, line in saves:
                if primary:
                    save_checkpoint(ckpt_dir, name, state, meta)
                    if line:
                        print(line, flush=True)
            barrier()

        if stop:
            if primary:
                print(f"Early stopping triggered after epoch {epoch + 1}",
                      flush=True)
            stopped = True
            break

    wandb.finish()
    if primary:
        print("Training complete!", flush=True)
    return {"state": state, "epochs": history, "decoder": decoder,
            "stopped_early": stopped}


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="BYOL pretraining of the WavLM encoder on one GPU, or "
                    "on several under torchrun")
    parser.add_argument("--config", required=True,
                        help="YAML config file, or a preset name of "
                             "nrse_tpu_torch/config/presets")
    parser.add_argument("--device", default=None, help="cuda or cpu")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint in "
                             "training.checkpoint_dir")
    return parser.parse_args(argv)


def cli(argv=None) -> int:
    args = parse_args(argv)
    config = load_config(args.config)
    training = config.setdefault("training", {})
    if args.device is not None:
        config["device"] = args.device
    if args.batch_size is not None:
        training["batch_size"] = args.batch_size
    if args.epochs is not None:
        training["num_epochs"] = args.epochs
    if args.lr is not None:
        training["learning_rate"] = args.lr
    config["resume"] = args.resume
    main(config)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
