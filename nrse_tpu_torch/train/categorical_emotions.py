"""Categorical SER trainer (8-class MSP-Podcast), and the two-phase loop
the dimensional trainer shares.

Port of ``nrse_tpu/train/categorical_emotions.py:53-315`` (capability
parity with the reference's ``src/train/categorical_emotions.py:21-301``):
a BYOL encoder of the port's ``train_byol`` or of the reference's
``.pt`` checkpoints (or seeded random weights)
in an :class:`~nrse_tpu_torch.models.emotion.EmotionClassifier` → class
weights ``(total / (count·K))^1.5`` → phase 1, ``classifier_epochs`` with
the encoder frozen → phase 2 (``unfreeze_encoder``): phase 1's best
reloaded, optimizer state and count included, ``fine_tuning_lr``, the
layers unfrozen top-down per epoch (``gradual_unfreeze``, the default),
or every encoder parameter from epoch 0 (``gradual_unfreeze: false``, the
reference baseline's ``--freeze_ssl=False``); AdamW + ReduceLROnPlateau
(max) on the validation macro-F1; weighted masked CE; early stopping on
``patience`` epochs without a better F1; the best checkpoint of each
phase (``best_classifier_model``, ``best_fine_tuned_model``) and a
confusion-matrix plot beside it.  The validation (``_validate``,
``:108``) is numpy: macro-F1, the confusion matrix and the per-class
report with ``zero_division=0`` (``eval.metrics``).

One card (``device: cuda``, the encoder computing in bf16) or the CPU
(float32, the plain paths), or N ranks, one card each, data-parallel
(``nrse_tpu/train/categorical_emotions.py:218`` places its batches over
the mesh): the group comes from the ``tpu.distributed`` block or
torchrun's environment, every rank builds the same seeded global batch
(``emotion.batch_size``, which must divide over the ranks) and keeps its
rows (``emotion_trainer.make_batch_placer``); validation pools the
confusion counts, the CCC's moments and each batch's loss parts, so every
rank gets one rank's metrics and takes the same plateau, checkpoint and
stopping decisions.  Rank 0 alone logs to wandb, prints, plots and writes
checkpoints; every rank waits after a checkpoint.
``model.num_hidden_layers`` in the config cuts the encoder's depth (a key
of the port's; the evaluator reads the same config).  Plots are drawn only
where matplotlib (and seaborn, for the heatmap) import.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from nrse_tpu_torch.data.emotion_dataset import create_emotion_dataloaders
from nrse_tpu_torch.data.loader import DevicePrefetcher
from nrse_tpu_torch.eval.metrics import (
    confusion_matrix,
    macro_f1_from_confusion,
    report_from_confusion,
)
from nrse_tpu_torch.models.convert import (
    init_emotion_state_dict,
    load_reference_byol_checkpoint,
)
from nrse_tpu_torch.models.emotion import (
    EmotionClassifier,
    gradually_unfrozen_layers,
)
from nrse_tpu_torch.models.wavlm import WavLMConfig
from nrse_tpu_torch.parallel.distributed import (
    all_reduce_sum,
    barrier,
    is_primary,
    maybe_initialize,
)
from nrse_tpu_torch.parallel.mesh import DataMesh, mesh_from_config
from nrse_tpu_torch.runtime.device import resolve_device
from nrse_tpu_torch.train.checkpoint import (
    load_byol_encoder,
    restore_checkpoint,
    save_checkpoint,
)
from nrse_tpu_torch.train.emotion_trainer import (
    ReduceLROnPlateau,
    create_emotion_state,
    load_encoder_into_classifier,
    make_batch_placer,
    make_emotion_eval_step,
    make_emotion_train_step,
)
from nrse_tpu_torch.train.losses import (
    ce_weight_category,
    compute_class_weights,
)
from nrse_tpu_torch.utils.logging_utils import logger, setup_logger
from nrse_tpu_torch.utils.setup_utils import set_seed
from nrse_tpu_torch.utils.wandb_utils import get_wandb

EMOTION_NAMES = {
    0: "Anger", 1: "Happiness", 2: "Sadness", 3: "Fear",
    4: "Surprise", 5: "Disgust", 6: "Contempt", 7: "Neutral",
}
NUM_EMOTIONS = 8


def encoder_config_from(config) -> WavLMConfig:
    """The encoder ``model.name`` names, cut to ``model.num_hidden_layers``
    where the config sets it."""
    model = config["model"]
    cfg = WavLMConfig.from_model_name(model.get("name",
                                                "microsoft/wavlm-large"))
    if model.get("num_hidden_layers"):
        cfg = dataclasses.replace(
            cfg, num_hidden_layers=int(model["num_hidden_layers"]))
    return cfg


def build_classifier(config, device: torch.device, seed: int,
                     pretrained_encoder: bool = True) -> EmotionClassifier:
    """The classifier of the ``emotion`` block on ``device`` (bf16 compute
    on the card, float32 on the CPU): seeded random weights, the encoder
    from ``emotion.encoder_checkpoint`` if ``pretrained_encoder``."""
    em = config["emotion"]
    enc_cfg = encoder_config_from(config)
    hidden = em.get("hidden_dim", 1024)
    model = EmotionClassifier(
        enc_cfg, hidden_dim=hidden, dropout=em.get("dropout_rate", 0.3),
        num_emotions=NUM_EMOTIONS, device="meta",
        compute_dtype=torch.bfloat16 if device.type == "cuda"
        else torch.float32)
    sd = init_emotion_state_dict(enc_cfg, torch.Generator().manual_seed(seed),
                                 hidden, NUM_EMOTIONS)
    encoder = load_pretrained_encoder(config, enc_cfg) \
        if pretrained_encoder else None
    if encoder is not None:
        sd = load_encoder_into_classifier(sd, encoder)
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(device)


def load_pretrained_encoder(config, enc_cfg: WavLMConfig
                            ) -> Optional[Dict[str, torch.Tensor]]:
    """The online encoder of ``emotion.encoder_checkpoint``: a reference
    PyTorch BYOL ``.pt`` checkpoint, bridged through
    ``models.convert.load_reference_byol_checkpoint`` (as
    ``nrse_tpu/train/categorical_emotions.py:81-89`` bridges it), or a
    checkpoint directory of the port's ``train_byol``; or None, with a
    warning, where there is neither (training starts from seeded weights,
    as the JAX trainer starts from scratch)."""
    path = config["emotion"].get("encoder_checkpoint")
    if path and os.path.isfile(path) and str(path).endswith(".pt"):
        online, _ = load_reference_byol_checkpoint(path, enc_cfg)
        logger.info(f"bridged reference torch BYOL checkpoint {path}")
        return {k[len("encoder."):]: torch.from_numpy(v)
                for k, v in online.items() if k.startswith("encoder.")}
    if not path or not os.path.isdir(path):
        msg = (f"encoder checkpoint {path!r} not found: training from "
               "seeded random weights")
        logger.warning(msg)
        print(msg, flush=True)
        return None
    logger.info(f"loaded BYOL encoder from {path}")
    return load_byol_encoder(path, enc_cfg)


def pooled(values: torch.Tensor, mesh: Optional[DataMesh]) -> torch.Tensor:
    """``values`` summed over the ranks (the ranks' parts of a validation
    pass); itself without a mesh."""
    return all_reduce_sum(values.to(mesh.device) if mesh else values, mesh)


def placed_batches(loader, device, mesh: Optional[DataMesh]):
    """The loader's batches on ``device``: this rank's rows of each under
    a distributed mesh, all of them otherwise."""
    if mesh is not None and mesh.distributed:
        place_batch, _ = make_batch_placer(mesh, loader.batch_size)
        loader = map(place_batch, loader)
    return DevicePrefetcher(loader, device)


def _validate(model, val_loader, eval_step, class_weights, device,
              mesh: Optional[DataMesh] = None
              ) -> Tuple[float, float, np.ndarray, Dict]:
    """Full validation pass → ``(loss, macro_f1, confusion, report)``;
    under a ``mesh``, of every rank's rows (the confusion counts and each
    batch's loss parts pooled)."""
    classes = list(range(NUM_EMOTIONS))
    cm = np.zeros((NUM_EMOTIONS, NUM_EMOTIONS), np.int64)
    losses = []
    for batch in placed_batches(val_loader, device, mesh):
        count = batch.pop("__count__")
        logits = eval_step(model, batch)["logits"][:count]
        c = batch["C"][:count]
        losses.append(ce_weight_category(logits, c, class_weights, mesh))
        preds, labels = logits.argmax(-1).cpu().numpy(), c.cpu().numpy()
        valid = (labels >= 0) & (labels < NUM_EMOTIONS)
        cm += confusion_matrix(labels[valid], preds[valid], classes)
    cm = pooled(torch.from_numpy(cm), mesh).cpu().numpy()
    loss = float(pooled(torch.stack(losses), mesh).mean())
    f1 = macro_f1_from_confusion(cm)
    report = report_from_confusion(cm, [EMOTION_NAMES[i] for i in classes])
    return loss, float(f1), cm, report


def plot_confusion_matrix(cm, class_names, filename="confusion_matrix.png",
                          title="Confusion Matrix") -> bool:
    """Heatmap plot (reference ``categorical_emotions.py:486-496``);
    False, with one log line, where matplotlib or seaborn is missing."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import seaborn as sns
    except ImportError as e:
        logger.info(f"confusion-matrix plot skipped: {e}")
        return False
    plt.figure(figsize=(10, 8))
    sns.heatmap(cm, annot=True, fmt="d", cmap="Blues",
                xticklabels=class_names, yticklabels=class_names)
    plt.xlabel("Predicted")
    plt.ylabel("True")
    plt.title(title)
    plt.tight_layout()
    plt.savefig(filename)
    plt.close()
    return True


@dataclasses.dataclass
class TaskRecipe:
    """What the two trainers differ in: the task, the wandb project, the
    metric's name and its start value (below any reading), and three
    callables: ``validate(model, val_loader, eval_step, class_weights,
    device, mesh) → (loss, metric, extras)``, ``report(phase, epoch, epochs,
    train_loss, val_loss, metric, extras, lr) → (wandb record, line)`` and
    ``on_best(extras, log_dir, wandb)``, which draws the plots of a new
    best."""

    task: str
    project: str
    metric: str
    start: float
    validate: Callable
    report: Callable
    on_best: Callable


def train_emotion_task(config, recipe: TaskRecipe,
                       class_weights_fn: Optional[Callable] = None) -> Dict:
    """The two-phase loop both trainers share.  Returns ``{"best_<metric>",
    "epochs": [per-epoch records], "state"}``; a record holds ``phase``,
    ``epoch``, ``train_loss``, ``val_loss``, the metric, ``lr``, ``layers``
    (the unfrozen ones), ``steps``, ``s_per_step`` (host clock over the
    epoch's train steps, data loading included) and
    ``audio_sec_per_sec``.  Joins the group the config or torchrun's
    environment describes, and leaves it at the end if it joined it
    here."""
    joined = maybe_initialize(config)
    try:
        return _train_emotion_task(config, recipe, class_weights_fn)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _train_emotion_task(config, recipe: TaskRecipe,
                        class_weights_fn: Optional[Callable]) -> Dict:
    setup_logger(config)
    seed = set_seed(config["training"].get("seed", 42))
    em = config["emotion"]
    primary = is_primary()
    wandb_mode = config["logging"].get("wandb_mode", "disabled") \
        if primary else "disabled"
    wandb = get_wandb(wandb_mode)
    wandb.init(project=recipe.project, config=config, mode=wandb_mode)
    mesh = mesh_from_config(config,
                            resolve_device(config.get("device", "cuda")))
    device = mesh.device
    if device.type == "cuda" and mesh.distributed:
        torch.cuda.set_device(device)

    ckpt_dir = em["checkpoint_dir"]
    os.makedirs(ckpt_dir, exist_ok=True)
    log_dir = config["training"].get("log_dir", ckpt_dir)
    os.makedirs(log_dir, exist_ok=True)

    train_loader, val_loader = create_emotion_dataloaders(config)
    model = build_classifier(config, device, seed)
    state = create_emotion_state(model, seed)
    place_state = None
    if mesh.distributed:
        _, place_state = make_batch_placer(mesh, train_loader.batch_size)
        state = place_state(state)
    dp_mesh = state.mesh
    num_layers = model.encoder_config.num_hidden_layers

    weights = None
    if class_weights_fn is not None and em.get("use_class_weights", True):
        w = class_weights_fn(train_loader.dataset)
        logger.info(f"class weights: {w}")
        weights = torch.from_numpy(w).to(device)

    train_step = make_emotion_train_step(
        recipe.task, weight_decay=em.get("weight_decay", 1e-4))
    eval_step = make_emotion_eval_step(recipe.task)
    clip_seconds = config["data"]["max_audio_length"]
    history: List[Dict] = []

    def run_phase(phase: str, epochs: int, lr0: float, state,
                  unfreeze_schedule=None,
                  best_name: str = "best_classifier_model",
                  rest_scale: float = 0.0):
        plateau = ReduceLROnPlateau(
            lr0, mode="max", factor=0.5,
            patience=em.get("scheduler_patience", 2))
        best, patience_left = recipe.start, em.get("patience", 3)
        lr = lr0
        for epoch in range(epochs):
            layers = []
            if unfreeze_schedule is not None:
                layers = unfreeze_schedule(epoch, epochs)
                logger.info(f"[{phase}] epoch {epoch}: unfrozen layers "
                            f"{layers}")
            # losses stay on the device until the epoch ends
            step_losses = []
            t0 = time.perf_counter()
            for batch in placed_batches(train_loader, device, dp_mesh):
                batch.pop("__count__")
                step_losses.append(train_step(state, batch, weights, layers,
                                              lr, rest_scale)["loss"])
            epoch_loss = float(torch.stack(step_losses).mean()) \
                if step_losses else 0.0
            steps = len(step_losses)
            s_per_step = (time.perf_counter() - t0) / max(steps, 1)
            val_loss, metric, extras = recipe.validate(
                state.model, val_loader, eval_step, weights, device,
                dp_mesh)
            lr = plateau.step(metric)
            log, line = recipe.report(phase, epoch, epochs, epoch_loss,
                                      val_loss, metric, extras, lr)
            wandb.log(log)
            if primary:
                print(line, flush=True)
            history.append({
                "phase": phase, "epoch": epoch, "train_loss": epoch_loss,
                "val_loss": val_loss, recipe.metric: metric, "lr": lr,
                "layers": list(layers), "steps": steps,
                "s_per_step": s_per_step,
                "audio_sec_per_sec": train_loader.batch_size * clip_seconds
                / s_per_step if steps else 0.0})
            if metric > best:  # the pooled metric: every rank agrees
                best = metric
                patience_left = em.get("patience", 3)
                if primary:
                    save_checkpoint(ckpt_dir, best_name, state,
                                    {"epoch": epoch, recipe.metric: metric,
                                     "phase": phase})
                    recipe.on_best(extras, log_dir, wandb)
                barrier()
            else:
                patience_left -= 1
                if patience_left <= 0:
                    if primary:
                        print(f"[{phase}] early stopping at epoch "
                              f"{epoch + 1}", flush=True)
                    break
        return state, best

    # phase 1: the encoder frozen
    state, best = run_phase("classifier", em.get("classifier_epochs", 20),
                            em.get("learning_rate", 1e-4), state)

    # phase 2: gradual_unfreeze (default) is the reference trainer's
    # top-down schedule (categorical_emotions.py:206-226); false opens
    # every encoder parameter from epoch 0, conv frontend included (the
    # reference baseline's --freeze_ssl=False)
    if em.get("unfreeze_encoder", False):
        state, _ = restore_checkpoint(ckpt_dir, "best_classifier_model",
                                      state)
        if place_state is not None:  # every rank from rank 0's bits
            state = place_state(state)
        if em.get("gradual_unfreeze", True):
            def schedule(e, total):
                return gradually_unfrozen_layers(e, total, num_layers)
            full_encoder = False
        else:
            def schedule(e, total):
                return list(range(num_layers))
            full_encoder = True
        full_encoder = bool(em.get("train_full_encoder", full_encoder))
        state, best_ft = run_phase(
            "fine_tune", em.get("fine_tuning_epochs", 10),
            em.get("fine_tuning_lr", 5e-6), state,
            unfreeze_schedule=schedule, best_name="best_fine_tuned_model",
            rest_scale=1.0 if full_encoder else 0.0)
        best = max(best, best_ft)

    wandb.finish()
    return {f"best_{recipe.metric}": best, "epochs": history, "state": state}


def _report(phase, epoch, epochs, train_loss, val_loss, f1, extras, lr):
    log = {f"{phase}/train_loss": train_loss, f"{phase}/val_loss": val_loss,
           f"{phase}/val_f1": f1, f"{phase}/lr": lr, "epoch": epoch}
    line = (f"[{phase}] epoch {epoch + 1}/{epochs} "
            f"train_loss={train_loss:.4f} val_loss={val_loss:.4f} "
            f"macro_f1={f1:.4f} lr={lr:.2e}")
    return log, line


def _on_best(extras, log_dir, wandb) -> None:
    cm, _ = extras
    path = os.path.join(log_dir, "val_confusion_matrix.png")
    if plot_confusion_matrix(cm, [EMOTION_NAMES[i]
                                  for i in range(NUM_EMOTIONS)],
                             filename=path,
                             title="Validation Confusion Matrix"):
        wandb.log({"val_confusion_matrix": wandb.Image(path)})


def _validate_categorical(model, val_loader, eval_step, weights, device,
                          mesh=None):
    loss, f1, cm, report = _validate(model, val_loader, eval_step, weights,
                                     device, mesh)
    return loss, f1, (cm, report)


CATEGORICAL = TaskRecipe(task="categorical",
                         project="nrse-emotion-categorical", metric="f1",
                         start=-1.0, validate=_validate_categorical,
                         report=_report, on_best=_on_best)


def train_categorical_emotions(config) -> Dict:
    """Train the categorical classifier; returns ``{"best_f1", "epochs",
    "state"}`` (:func:`train_emotion_task`)."""
    return train_emotion_task(
        config, CATEGORICAL,
        lambda ds: compute_class_weights(ds.class_counts(), NUM_EMOTIONS))
