"""The Odyssey-2024 SER fine-tune as ``nrse_tpu_torch.baseline.
train_ft_cat_ser`` runs it on one card: ``BaselineWavDataset`` through
``HostDataLoader`` → ``DevicePrefetcher`` feeding ``make_train_step``'s
captured micro-step (end to end), one AdamW update every
``accumulation_steps`` micro-steps.

Set-up writes the corpus, takes the corpus statistics, makes the weights,
builds the state and runs the first update's micro-steps through the
window's own call and feed (the first captures the micro-step); the window
then runs the same call on the same iterator."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench import corpus, loop, weights, yardstick
from portbench.entries.byol import wavlm_config
from portbench.reference import draws as D
from portbench.reference import models as ref


def class_weights(labels: np.ndarray, k: int) -> np.ndarray:
    """``total / (K · count)`` of each class present, 1 for an absent one."""
    count = np.bincount(labels, minlength=k).astype(np.float64)
    return np.where(count > 0, len(labels) / (k * np.maximum(count, 1)),
                    1.0).astype(np.float32)


class Cell:
    kind = "train"

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config

    def setup(self) -> None:
        from nrse_tpu_torch.baseline.pipeline import BaselineSER
        from nrse_tpu_torch.baseline.train_ft_cat_ser import (
            BaselineWavDataset,
            adamw_spec,
            corpus_norm_stats,
            create_train_state,
            make_train_step,
        )
        from nrse_tpu_torch.data.loader import DevicePrefetcher

        ctx, cfg = self.ctx, self.cfg
        enc, head, opt, data = (cfg["encoder"], cfg["head"],
                                cfg["optimizer"], cfg["data"])
        made = corpus.clips(ctx.traffic, ctx.seed)["clips"]
        wav_dir, files = corpus.write_group(ctx.tmp, "clips", made)
        del made
        k = head["num_classes"]
        labels = corpus.labels(ctx.traffic, len(files), ctx.seed)
        onehot = np.eye(k, dtype=np.float32)[labels]
        self.weights = class_weights(labels, k)
        stats = corpus_norm_stats(wav_dir, files, ctx.seed % 2**32)
        dataset = BaselineWavDataset(wav_dir, files, onehot, stats,
                                     data["max_seconds"])
        self.batch = int(data["batch_size"])
        self.k = int(opt["accumulation_steps"])
        feed = loop.Endless(dataset, len(files), self.batch, ctx.seed)
        self.enc_cfg = wavlm_config(enc)
        dtype = torch.bfloat16 if ctx.device.type == "cuda" \
            else torch.float32
        model = BaselineSER(self.enc_cfg, head_dim=head["head_dim"],
                            num_classes=k, dropout=head["dropout"],
                            device="meta", compute_dtype=dtype)
        sd = weights.make(weights.ser_shapes(enc, head), ctx.seed,
                          ctx.device, enc)
        model.load_state_dict(sd, strict=True, assign=True)
        del sd
        self.state = state = create_train_state(model.to(ctx.device))
        self.train_step = make_train_step(
            adamw_spec(opt["learning_rate"]), self.k, False,
            torch.from_numpy(self.weights).to(ctx.device))
        self.batches = iter(DevicePrefetcher(feed, ctx.device))
        self.named = list(state.model.named_parameters())
        self.micro = 0
        p0 = state.params.to("cpu", copy=True)
        self.checked: List[Dict] = []
        losses = []
        for _ in range(self.k):  # the first update's micro-steps
            batch = next(self.batches)
            batch.pop("__count__")
            self.checked.append({k_: v.cpu() for k_, v in batch.items()})
            losses.append(self._step(batch)["loss"])
        one_minus = float(np.float32(1.0) - np.float32(opt["b1"]))
        self.readings = {
            "loss": [float(x) for x in losses],
            "grad": loop.leaf_norms(self.named, state.mu, 1.0 / one_minus),
            "change": loop.leaf_norms(self.named, state.params, base=p0)}
        del p0

    def _step(self, batch: Dict) -> Dict:
        from nrse_tpu_torch.models.wavlm import TrainRNG

        step = self.micro
        loss = self.train_step(self.state, batch,
                               TrainRNG(self.ctx.seed, step))
        self.micro += 1
        mask = batch["attention_mask"]
        return {"step": step, "loss": loss, "finite": torch.isfinite(loss),
                "lengths": mask.sum(-1), "samples": mask.numel()}

    def window(self, seconds: float, spans, steps=None) -> Dict:
        run = loop.run_steps(self._step, self.batches, seconds, spans, steps)
        recs = run["records"]
        finite = torch.stack([r["finite"] for r in recs]).cpu()
        lengths = torch.stack([r["lengths"] for r in recs]).cpu()
        for r, n in zip(recs, lengths):
            r["lengths"] = n
        audio = float(lengths.double().sum()) \
            / self.cfg["data"]["sample_rate"]
        return {"records": recs, "elapsed": run["elapsed"],
                "attempted": len(recs), "failed": int((~finite).sum()),
                "metrics": {"train_audio_s_per_s": audio / run["elapsed"]}}

    def observe(self, run: Dict, obs: Dict, spans) -> None:
        enc, head = self.cfg["encoder"], self.cfg["head"]
        c, f, h = (enc["hidden_size"], enc["intermediate_size"],
                   enc["num_attention_heads"])
        samples = self.checked[0]["input_values"].shape[1]
        t_pad = yardstick.frames(enc, samples)[-1]
        flop = ffn = attn = mask = computed = 0.0
        for r in run["records"]:
            layers = sum(D.StepDraws(self.ctx.seed, r["step"], 0).layer_keep(
                enc["num_hidden_layers"], enc["layerdrop"]))
            for n in r["lengths"].tolist():
                fwd = yardstick.encoder_forward_flop(enc, int(n), layers)
                t = yardstick.frames(enc, int(n))[-1]
                flop += yardstick.train_flop(fwd) \
                    + 3 * yardstick.ser_head_flop(enc, head, t)
                mask += n
            computed += r["samples"]
            ffn += layers * yardstick.ffn_least(self.batch * t_pad, c, f,
                                                "train")
            attn += layers * yardstick.attention_least(
                self.batch, h, t_pad, c // h, "train", t_pad <= 384)
        obs.update({"steps": len(run["records"]), "model_flop": flop,
                    "ffn_least_s": ffn, "attention_least_s": attn,
                    "mask_samples": mask, "computed_samples": computed,
                    "host_wait_s": spans.seconds.get("loader_wait", 0.0)})

    def release(self) -> None:
        self.batches.close()
        del self.state, self.train_step, self.batches
        loop.free_card()

    def check(self, q=None) -> Dict:
        cfg, ctx = self.cfg, self.ctx
        params = weights.make(weights.ser_shapes(cfg["encoder"],
                                                 cfg["head"]),
                              ctx.seed, ctx.device, cfg["encoder"])
        batches = [{k: v.to(ctx.device) for k, v in b.items()}
                   for b in self.checked]
        kw = {} if q is None else {"q": q}
        out = ref.ft_follow(cfg, params, batches, ctx.seed,
                            torch.from_numpy(self.weights).to(ctx.device),
                            **kw)
        del params, batches
        loop.free_card()
        return out
