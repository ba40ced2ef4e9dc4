"""Baseline SER fine-tune on one GPU (the Odyssey-2024 challenge pipeline).

    python -m nrse_tpu_torch.baseline.train_ft_cat_ser --config <json> \\
        --model_path <dir> [--freeze_ssl true|false] [--epochs N] \\
        [--batch_size N] [--accumulation_steps K] [--lr X] \\
        [--byol_checkpoint <dir>] [--model_name microsoft/wavlm-large] \\
        [--max_seconds 10] [--device cuda|cpu]

Port of ``nrse_tpu/baseline/train_ft_cat_ser.py`` (capability parity with
the reference's ``baseline/train_ft_cat_ser_weighted_checkpoint.py``):

  * the config JSON names ``wav_dir`` and ``label_path``, a one-hot label
    CSV (``FileName, A, S, H, U, F, D, C, N [, Split_Set]``), read with the
    ``csv`` module;
  * class weights ``total / (K · freq)`` of the train split;
  * the corpus z-norm stats computed on (up to 2000) train WAVs and saved
    to ``<model_path>/train_norm_stat.pkl``, or read from it;
  * ``BaselineSER`` (WavLM → ASP → ``EmotionRegression``) from seeded
    weights (``models.convert.init_baseline_state_dict``), its encoder
    optionally taken from a BYOL checkpoint of the port's ``train_byol``
    (``--byol_checkpoint <ckpt_dir>/<name>``);
  * clips cropped at a random offset to ``--max_seconds`` (10 s: 499
    frames, the flash attention's K5 with its backward) and padded to it;
  * weighted CE with the encoder in training mode (dropout, LayerDrop,
    SpecAugment) and the head's dropout 0.5, every random draw from a
    ``TrainRNG`` of (seed, micro-step);
  * optax's ``MultiSteps(adamw(lr), every_k_schedule=k)``: the micro-steps'
    gradients averaged as optax does (``acc += (g − acc) / (n + 1)``) and
    one AdamW update on every k-th, with adamw's defaults (weight decay
    1e-4, eps outside √v̂, no clipping) and its rounding of the moments'
    rates (``FusedAdamWSpec.optax_rates``), through K4
    (``ops.fused_optimizer``) over one flat float32 buffer of every
    parameter, ssl first;
  * ``--freeze_ssl true`` keeps the JAX trainer's semantics: the ssl
    gradients are zero (the encoder runs under ``torch.no_grad()``, in
    training mode), and AdamW's decoupled decay still scales the ssl
    weights by ``1 − lr·wd`` at each update (ROADMAP Queue 3);
  * after each epoch the dev loss, the weighted CE of every dev batch in
    eval mode, the last batch padded with its last clip and taken whole,
    averaged over the batches; ``final_model`` (``train.checkpoint.
    save_model``, metadata ``epoch``, ``dev_loss``, ``freeze_ssl``) saved
    whenever it improves, for ``baseline.eval_cat_ser``.

A micro-step's inputs from the host (the kernels' seed table, LayerDrop's
keep list, SpecAugment's spans, the head's dropout masks, K4's LR and bias
corrections and MultiSteps' divisor ``n + 1``) are drawn as the model
draws them and written to the device in one copy before it
(:class:`StepInputs`); the micro-step reads them there.  On the card the
micro-step runs from CUDA graphs (``train.step_graphs``, the counterpart
of JAX's jitted ``train_step``), captured at the first micro-step of the
trainable key (end to end or frozen) and batch shape, the AdamW apply a
part of its own that the host replays on every k-th micro-step; the dev
step runs from one ``runtime.graphs.ProgramCache`` program a shape
(JAX's jitted ``dev_step``), built once per run.  ``graphs=False`` (a
function argument, no flag) asks for the eager forms; the CPU always runs
them.  Both forms give the same bits.

On the card (``--device cuda``, the default) the encoder computes in bf16;
on the CPU in float32 through the kernels' plain versions.
``--num_hidden_layers`` cuts the encoder's depth (the evaluator takes the
same flag).
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import math
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from nrse_tpu_torch.baseline.eval_cat_ser import encoder_config, load_audio_16k
from nrse_tpu_torch.baseline.pipeline import BaselineSER, make_baseline_forward
from nrse_tpu_torch.baseline.wavset import WavNormStats
from nrse_tpu_torch.data.loader import DevicePrefetcher, HostDataLoader
from nrse_tpu_torch.labels.parsing import BASELINE_EMOTIONS_MAP
from nrse_tpu_torch.models.convert import init_baseline_state_dict
from nrse_tpu_torch.models.wavlm import SeedTable, StagedDraws, TrainRNG
from nrse_tpu_torch.ops.fused_optimizer import (
    FusedAdamWSpec,
    fused_adamw_ema_update,
    host_scalars,
)
from nrse_tpu_torch.runtime.device import resolve_device
from nrse_tpu_torch.runtime.staging import Staging
from nrse_tpu_torch.train.byol_trainer import flatten_params
from nrse_tpu_torch.train.checkpoint import load_byol_encoder, save_model
from nrse_tpu_torch.train.losses import ce_weight_category
from nrse_tpu_torch.train.step_graphs import (
    StepGraphs,
    encoder_parameter_groups,
)

ONE_HOT_COLUMNS = list(BASELINE_EMOTIONS_MAP.keys())  # A,S,H,U,F,D,C,N
SAMPLE_RATE = 16000
NORM_STAT_FILES = 2000  # train WAVs the z-norm stats are taken over


def load_onehot_labels(label_path: str, split: Optional[str] = None
                       ) -> Tuple[List[str], np.ndarray]:
    """``(file names, one-hot labels [N, 8] float32)`` of the CSV's rows,
    those of ``split`` only where the CSV has a ``Split_Set`` column."""
    with open(label_path, newline="") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
        fields = reader.fieldnames or []
    if split and "Split_Set" in fields:
        rows = [r for r in rows if r["Split_Set"] == split]
    labels = np.array([[float(r[c]) for c in ONE_HOT_COLUMNS] for r in rows],
                      np.float32).reshape(len(rows), len(ONE_HOT_COLUMNS))
    return [r["FileName"] for r in rows], labels


def class_weights_from_onehot(labels: np.ndarray) -> np.ndarray:
    """``total / (K · freq)``, 1 for an absent class."""
    k = labels.shape[1]
    freq = labels.sum(axis=0)
    total = labels.sum()
    weights = np.where(freq > 0, total / (k * np.maximum(freq, 1)), 1.0)
    return weights.astype(np.float32)


def _load_wav(path: str, max_samples: int, rng: np.random.Generator
              ) -> Optional[Tuple[np.ndarray, int]]:
    """``(samples, length)`` of a 16 kHz mono clip cropped to
    ``max_samples`` at an offset drawn from ``rng`` (no draw when it is
    short enough), or None if it does not decode."""
    wav = load_audio_16k(path)
    if wav is None:
        return None
    if len(wav) > max_samples:
        start = int(rng.integers(0, len(wav) - max_samples + 1))
        wav = wav[start:start + max_samples]
    return wav.astype(np.float32), len(wav)


class BaselineWavDataset:
    """Fixed-shape z-normed waveform items from a one-hot label CSV, as
    ``HostDataLoader`` takes them."""

    def __init__(self, wav_dir: str, files: List[str], labels: np.ndarray,
                 stats: WavNormStats, max_seconds: float = 10.0):
        self.wav_dir = wav_dir
        self.files = files
        self.labels = labels
        self.stats = stats
        self.max_samples = int(max_seconds * SAMPLE_RATE)

    def __len__(self):
        return len(self.files)

    def sample(self, idx: int, rng: np.random.Generator
               ) -> Dict[str, np.ndarray]:
        path = os.path.join(self.wav_dir, self.files[idx])
        loaded = _load_wav(path, self.max_samples, rng)
        if loaded is None:
            wav, n = (np.full(self.max_samples, 1e-6, np.float32),
                      self.max_samples)
        else:
            wav, n = loaded
        x = np.zeros(self.max_samples, np.float32)
        x[:n] = self.stats.apply(wav[:n])
        mask = np.zeros(self.max_samples, np.float32)
        mask[:n] = 1.0
        return {"input_values": x, "attention_mask": mask,
                "label": self.labels[idx].argmax().astype(np.int32)}


def corpus_norm_stats(wav_dir: str, files: List[str], seed: int
                      ) -> WavNormStats:
    """Mean and std over the first :data:`NORM_STAT_FILES` train WAVs,
    whole."""
    rng = np.random.default_rng(seed)
    wavs = (w[0] for w in
            (_load_wav(os.path.join(wav_dir, f), 10 ** 9, rng)
             for f in files[:NORM_STAT_FILES]) if w is not None)
    return WavNormStats.from_waveforms(wavs)


@dataclasses.dataclass
class SERTrainState:
    """The fine-tune's state.  Every parameter of ``model`` is a view of
    ``params`` and its ``.grad`` a view of ``grads`` (one flat float32
    buffer each, ssl's ``n_ssl`` elements first); ``acc`` is MultiSteps'
    gradient mean, ``mu`` and ``nu`` AdamW's moments; ``mini_step`` counts
    the micro-steps since the last update, ``count`` the updates."""

    model: BaselineSER
    params: torch.Tensor
    grads: torch.Tensor
    acc: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    n_ssl: int
    mini_step: int = 0
    count: int = 0
    # the micro-step's staged inputs by batch shape, and its graphs
    # (train.step_graphs.StepGraphs) of the current key and shape
    inputs: Dict = dataclasses.field(default_factory=dict, repr=False)
    graphs: Optional[StepGraphs] = dataclasses.field(default=None,
                                                     repr=False)


def create_train_state(model: BaselineSER) -> SERTrainState:
    """The state at step 0 for ``model`` (moved to its device, in training
    mode); the moments and the gradient mean are zero."""
    params = list(model.parameters())
    device = params[0].device
    flat = flatten_params(params, device)
    grads = torch.zeros_like(flat)
    off = 0
    for p in params:
        p.grad = grads[off:off + p.numel()].view_as(p)
        off += p.numel()
    return SERTrainState(
        model=model.train(), params=flat, grads=grads,
        acc=torch.zeros_like(flat), mu=torch.zeros_like(flat),
        nu=torch.zeros_like(flat),
        n_ssl=sum(p.numel() for p in model.ssl.parameters()))


def adamw_spec(lr: float) -> FusedAdamWSpec:
    """optax ``adamw(lr)``'s defaults as K4's spec: b1 0.9, b2 0.999, eps
    1e-8 outside √v̂, weight decay 1e-4, no clipping, the moments' rates
    rounded as optax rounds them."""
    return FusedAdamWSpec(schedule=lr, weight_decay=1e-4, clip_norm=math.inf,
                          optax_rates=True)


def forward_train(model: BaselineSER, batch: Dict, rng: TrainRNG,
                  freeze_ssl: bool,
                  keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training-mode logits; with ``freeze_ssl`` the encoder runs without
    a graph, so its gradients stay zero.  ``keep``: the head's staged
    dropout masks (or None: drawn in the forward)."""
    x, mask = batch["input_values"], batch["attention_mask"]
    if not freeze_ssl:
        return model(x, mask, rng, keep)
    with torch.no_grad():
        seq, _ = model.ssl(x, mask, rng)
    return model.ser(model.pool(seq, mask), rng, keep)


class StepInputs:
    """A micro-step's inputs from the host for one batch shape, in one
    :class:`~nrse_tpu_torch.runtime.staging.Staging`: the kernels' seed
    table, SpecAugment's ``[B, T']`` spans, the head's ``[layers, B, H]``
    dropout keep masks (``head``; None without head dropout), K4's eight
    host scalars (``k4``) and MultiSteps' divisor ``n + 1`` as a float32
    scalar (``divisor``: exact, and a true division, as optax divides; on
    the CPU the bits of dividing by the integer, while CUDA's kernel
    multiplies by a host scalar's reciprocal, which can differ in the last
    bit).  :meth:`stage` draws a micro-step's as the model
    would (the same generators, in the same order), writes them and copies
    them over once, and returns the micro-step's ``TrainRNG`` reading the
    table and the encoder's draws."""

    def __init__(self, model: BaselineSER, batch: int, samples: int,
                 device):
        enc = model.encoder_config
        self.frames = int(enc.feature_lengths(samples))
        self.batch = batch
        slots = {"seeds": SeedTable.slot(enc.num_hidden_layers),
                 "k4": ((8,), torch.float32),
                 "divisor": ((), torch.float32)}
        self.spans = enc.has_masked_spec_embed
        if self.spans:
            slots["spans"] = ((batch, self.frames), torch.bool)
        head = model.ser
        if head.dropout > 0.0 and head.num_layers:
            slots["head"] = ((head.num_layers, batch, head.hidden_dim),
                             torch.bool)
        self.staging = Staging(device, slots)
        self.table = SeedTable(enc.num_hidden_layers, staging=self.staging)
        self.head = self.staging["head"] if "head" in slots else None
        self.k4, self.divisor = self.staging["k4"], self.staging["divisor"]

    def stage(self, state: "SERTrainState", rng: TrainRNG,
              spec: FusedAdamWSpec) -> TrainRNG:
        model, st = state.model, self.staging
        st.begin()
        self.table.fill(rng.seed, rng.step, rng.rank, rng.world)
        keep = model.ssl.encoder.layer_keep(rng)
        if self.spans:
            st.host("spans").copy_(model.ssl.time_mask(rng, self.batch,
                                                       self.frames))
        if self.head is not None:
            st.host("head").copy_(model.ser.head_keep(rng, self.batch))
        st.host("k4").copy_(torch.from_numpy(host_scalars(spec,
                                                          state.count)))
        st.host("divisor").fill_(state.mini_step + 1)
        st.push()
        draws = StagedDraws(tuple(keep),
                            st["spans"] if self.spans else None)
        return dataclasses.replace(rng, table=self.table, draws=draws)


def step_inputs(state: SERTrainState, batch: Dict) -> StepInputs:
    """The state's :class:`StepInputs` for this batch's shape."""
    shape = tuple(batch["input_values"].shape)
    if shape not in state.inputs:
        state.inputs[shape] = StepInputs(state.model, shape[0], shape[1],
                                         state.params.device)
    return state.inputs[shape]


def _accumulate(state: SERTrainState, inputs: StepInputs) -> None:
    """MultiSteps' mean of the micro-steps' gradients, in place: ``acc +=
    (g − acc) / (n + 1)``, the divisor read from its staged slot."""
    state.acc.add_((state.grads - state.acc) / inputs.divisor)


def _apply(state: SERTrainState, spec: FusedAdamWSpec,
           inputs: StepInputs) -> None:
    """The k-th micro-step's AdamW update over the mean (K4, its host
    scalars read from the staged slot), then the mean zeroed."""
    fused_adamw_ema_update(state.acc, state.params, state.mu, state.nu,
                           None, spec, state.count, rest=inputs.k4)
    state.acc.zero_()


def ft_step_graphs(state: SERTrainState, spec: FusedAdamWSpec,
                   freeze_ssl: bool, class_weights: torch.Tensor,
                   batch: Dict, rng: TrainRNG, inputs: StepInputs,
                   key) -> StepGraphs:
    """The micro-step of ``state`` for one ``key`` as ``train.step_graphs.
    StepGraphs``, captured on ``batch`` with ``rng`` (the micro-step's
    staged stream) and ``inputs`` (its ``StepInputs``): the front is the
    encoder's own (the dataset z-normed the waveform), the head ASP,
    ``EmotionRegression`` and the weighted CE, then the ``accumulate``
    part (every micro-step) and the ``apply`` part (every k-th).  Frozen,
    nothing of the encoder takes part in the backward, as its eager
    micro-step runs it under ``no_grad``."""
    model = state.model
    layers = model.encoder_config.num_hidden_layers

    def front(x, rng):
        return model.ssl.front(x["input_values"], x["attention_mask"], rng)

    def head(back, x, rng):
        logits = model.ser(model.pool(back[0], x["attention_mask"]), rng,
                           inputs.head)
        return ce_weight_category(logits, x["label"], class_weights)

    return StepGraphs(
        model.ssl, encoder_parameter_groups(model, "ssl", layers),
        (layers, False) if freeze_ssl else (0, True), front, head,
        [("accumulate", lambda: _accumulate(state, inputs)),
         ("apply", lambda: _apply(state, spec, inputs))],
        batch, rng, state.grads, key,
        f"the fine-tune's micro-step {state.mini_step} after update "
        f"{state.count} ({'frozen' if freeze_ssl else 'end to end'})")


def make_train_step(spec: FusedAdamWSpec, accumulation_steps: int,
                    freeze_ssl: bool, class_weights: torch.Tensor,
                    graphs: bool = True
                    ) -> Callable[[SERTrainState, Dict, TrainRNG],
                                  torch.Tensor]:
    """``train_step(state, batch, rng) → loss`` (a device scalar; nothing
    waits for the card): one micro-step of MultiSteps(adamw), in place,
    its host draws those of ``rng`` (staged in the state's
    :class:`StepInputs`).  Every ``accumulation_steps``-th call makes one
    K4 update.  With ``graphs`` (the default) a state on a card runs the
    captured micro-step (:func:`ft_step_graphs`); a capture that fails
    raises, naming the micro-step and the part."""
    token = object()  # this step's spec, k and weights: one key of graphs

    def train_step(state: SERTrainState, batch: Dict,
                   rng: TrainRNG) -> torch.Tensor:
        inputs = step_inputs(state, batch)
        rng = inputs.stage(state, rng, spec)
        n = state.mini_step
        apply = n == accumulation_steps - 1
        if graphs and state.params.device.type == "cuda":
            key = (token, freeze_ssl, tuple(batch["input_values"].shape))
            if state.graphs is None or state.graphs.key != key:
                state.graphs = None  # the previous key's graphs go first
                state.graphs = ft_step_graphs(
                    state, spec, freeze_ssl, class_weights, batch, rng,
                    inputs, key)
            loss, _ = state.graphs.run(
                batch, rng, ("accumulate", "apply") if apply
                else ("accumulate",))
        else:
            state.grads.zero_()
            logits = forward_train(state.model, batch, rng, freeze_ssl,
                                   inputs.head)
            loss = ce_weight_category(logits, batch["label"], class_weights)
            loss.backward()
            loss = loss.detach()
            with torch.no_grad():
                _accumulate(state, inputs)
                if apply:
                    _apply(state, spec, inputs)
        state.model.ssl.encoder.layers_run = sum(rng.draws.keep)
        if apply:
            state.count += 1
        state.mini_step = (n + 1) % accumulation_steps
        return loss

    return train_step


@torch.no_grad()
def dev_loss(model: BaselineSER, loader, device,
             class_weights: torch.Tensor,
             forward: Optional[Callable] = None) -> float:
    """The mean over the dev batches of each whole batch's weighted CE in
    eval mode (the padding rows of the last batch included, as the JAX
    trainer takes it).  ``forward``: the logits of ``(waveforms, mask)``
    in eval mode, ``baseline.pipeline.make_baseline_forward``'s (its
    program cache on the card), or None for the eager forward."""
    forward = forward or make_baseline_forward(model)
    model.eval()
    losses = []
    try:
        for batch in DevicePrefetcher(loader, device):
            logits = forward(batch["input_values"], batch["attention_mask"])
            losses.append(ce_weight_category(logits, batch["label"],
                                             class_weights))
    finally:
        model.train()
    # the batches' losses averaged in float64, as JAX's LogManager does
    return float(torch.stack(losses).double().mean()) if losses else 0.0


def train(config_path: str = "config_cat_noisy.json",
          model_path: str = "baseline_model",
          epochs: int = 10, batch_size: int = 32,
          accumulation_steps: int = 4, lr: float = 5e-6,
          freeze_ssl: bool = True, head_dim: int = 1024,
          pooling_type: str = "AttentiveStatisticsPooling",
          byol_checkpoint: Optional[str] = None,
          model_name: str = "microsoft/wavlm-large",
          max_seconds: float = 10.0,
          train_split: str = "Train", dev_split: str = "Development",
          num_workers: int = 8, seed: int = 7, device="cuda",
          num_hidden_layers: Optional[int] = None,
          graphs: bool = True) -> Dict:
    """Fine-tune and save ``final_model`` under ``model_path``.  Returns
    ``{"best_dev_loss", "best_epoch", "epochs": [per-epoch metrics],
    "state", "dev_forward"}``; each epoch's metrics hold ``epoch``,
    ``train_loss``, ``dev_loss``, ``steps`` (micro-steps), ``s_per_step``
    (host clock over the epoch's micro-steps, data loading included) and
    ``audio_sec_per_sec``.  ``dev_forward`` is the dev step's forward: a
    ``runtime.graphs.ProgramCache`` with ``graphs`` (on the card one
    captured program a dev batch shape, built once for every epoch), else
    the eager forward; ``graphs=False`` also runs the eager micro-step."""
    if pooling_type != "AttentiveStatisticsPooling":
        raise ValueError(f"pooling {pooling_type!r}: only "
                         "AttentiveStatisticsPooling is ported")
    device = resolve_device(device)
    with open(config_path) as f:
        cfg_json = json.load(f)
    wav_dir, label_path = cfg_json["wav_dir"], cfg_json["label_path"]
    os.makedirs(model_path, exist_ok=True)

    train_files, train_labels = load_onehot_labels(label_path, train_split)
    dev_files, dev_labels = load_onehot_labels(label_path, dev_split)
    weights = class_weights_from_onehot(train_labels)
    print("class weights:", weights, flush=True)

    stat_path = os.path.join(model_path, "train_norm_stat.pkl")
    if os.path.exists(stat_path):
        stats = WavNormStats.load(stat_path)
    else:
        stats = corpus_norm_stats(wav_dir, train_files, seed)
        stats.save(stat_path)
    print(f"norm stats: mean={stats.mean:.6f} std={stats.std:.6f}",
          flush=True)

    enc_cfg = encoder_config(model_name, num_hidden_layers)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = BaselineSER(enc_cfg, head_dim=head_dim, device="meta",
                        compute_dtype=dtype)
    sd = init_baseline_state_dict(enc_cfg, torch.Generator().manual_seed(seed),
                                  head_dim=head_dim)
    if byol_checkpoint:
        sd.update({f"ssl.{k}": v for k, v in
                   load_byol_encoder(byol_checkpoint, enc_cfg).items()})
        print(f"encoder from the BYOL checkpoint {byol_checkpoint}",
              flush=True)
    model.load_state_dict(sd, strict=True, assign=True)
    del sd
    state = create_train_state(model.to(device))
    w = torch.from_numpy(weights).to(device)
    train_step = make_train_step(adamw_spec(lr), accumulation_steps,
                                 freeze_ssl, w, graphs)
    # one program a dev batch shape, reading the weights K4 updates in
    # place; building it puts the model in eval mode
    dev_forward = make_baseline_forward(state.model, graphs)
    state.model.train()

    train_ds = BaselineWavDataset(wav_dir, train_files, train_labels, stats,
                                  max_seconds)
    dev_ds = BaselineWavDataset(wav_dir, dev_files, dev_labels, stats,
                                max_seconds)
    train_loader = HostDataLoader(train_ds, np.arange(len(train_ds)),
                                  batch_size, shuffle=True, seed=seed,
                                  num_workers=num_workers, drop_last=True)
    dev_loader = HostDataLoader(dev_ds, np.arange(len(dev_ds)), batch_size,
                                shuffle=False, seed=seed,
                                num_workers=num_workers, drop_last=False)

    best_dev, best_epoch = float("inf"), -1
    history, step = [], 0
    for epoch in range(epochs):
        # losses stay on the device until the epoch ends
        losses = []
        t0 = time.perf_counter()
        for batch in DevicePrefetcher(train_loader, device):
            batch.pop("__count__")
            losses.append(train_step(state, batch, TrainRNG(seed, step)))
            step += 1
        train_loss = float(torch.stack(losses).double().mean()) \
            if losses else 0.0
        dt = time.perf_counter() - t0
        dev = dev_loss(state.model, dev_loader, device, w, dev_forward)
        s_per_step = dt / max(len(losses), 1)
        history.append({
            "epoch": epoch, "train_loss": train_loss, "dev_loss": dev,
            "steps": len(losses), "s_per_step": s_per_step,
            "audio_sec_per_sec": batch_size * max_seconds / s_per_step
            if losses else 0.0})
        print(f"epoch {epoch + 1}/{epochs}: train_loss={train_loss:.4f} "
              f"dev_loss={dev:.4f} ({s_per_step:.4f} s per micro-step)",
              flush=True)
        if dev < best_dev:
            best_dev, best_epoch = dev, epoch
            save_model(model_path, "final_model", state.model,
                       {"epoch": epoch, "dev_loss": dev,
                        "freeze_ssl": freeze_ssl})
            print(f"saved final_model (dev_loss={dev:.4f})", flush=True)
    return {"best_dev_loss": best_dev, "best_epoch": best_epoch,
            "epochs": history, "state": state, "dev_forward": dev_forward}


def main(argv=None, graphs: bool = True) -> Dict:
    """The command line; ``graphs=False`` (no flag: JAX has none) runs
    the eager micro-step and dev step, the captured forms' yardstick."""
    parser = argparse.ArgumentParser(
        description="Fine-tune the baseline SER pipeline (WavLM + ASP + "
                    "head) on a one-hot label CSV")
    parser.add_argument("--config", default="config_cat_noisy.json")
    parser.add_argument("--model_path", default="baseline_model")
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--accumulation_steps", type=int, default=4)
    parser.add_argument("--lr", type=float, default=5e-6)
    parser.add_argument("--freeze_ssl", type=lambda s: s.lower() != "false",
                        default=True)
    parser.add_argument("--head_dim", type=int, default=1024)
    parser.add_argument("--pooling_type", default="AttentiveStatisticsPooling")
    parser.add_argument("--byol_checkpoint", default=None,
                        help="a BYOL checkpoint directory of the port's "
                             "train_byol (<checkpoint_dir>/<name>)")
    parser.add_argument("--model_name", default="microsoft/wavlm-large")
    parser.add_argument("--num_hidden_layers", type=int, default=None,
                        help="cut the encoder to its first N layers")
    parser.add_argument("--max_seconds", type=float, default=10.0)
    parser.add_argument("--device", default="cuda", help="cuda or cpu")
    args = parser.parse_args(argv)
    return train(args.config, args.model_path, args.epochs, args.batch_size,
                 args.accumulation_steps, args.lr, args.freeze_ssl,
                 args.head_dim, args.pooling_type, args.byol_checkpoint,
                 args.model_name, args.max_seconds, device=args.device,
                 num_hidden_layers=args.num_hidden_layers, graphs=graphs)


if __name__ == "__main__":
    main()
