"""BYOL pretraining as ``nrse_tpu_torch.train_byol`` runs it on one card:
``HostDataLoader`` → ``DevicePrefetcher`` over ``NoiseRobustSpeechDataset``
feeding ``make_byol_train_step``'s captured step.

Set-up writes the corpus, makes the weights, builds the state and takes
the first ``check_steps`` steps through the window's own call and feed
(the first captures the step), keeping what the check compares; the window
then runs the same step on the same iterator."""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from portbench import corpus, loop, weights, yardstick
from portbench.reference import draws as D
from portbench.reference import models as ref


def wavlm_config(enc: Dict):
    from nrse_tpu_torch.models.wavlm import WavLMConfig

    fields = {f.name for f in dataclasses.fields(WavLMConfig)}
    return WavLMConfig(**{k: v for k, v in enc.items() if k in fields})


class Cell:
    kind = "train"

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config

    def setup(self) -> None:
        from nrse_tpu_torch.data.loader import DevicePrefetcher
        from nrse_tpu_torch.data.noisy_speech_dataset import (
            NoiseRobustSpeechDataset,
        )
        from nrse_tpu_torch.ops.fused_optimizer import FusedAdamWSpec
        from nrse_tpu_torch.train.byol_trainer import (
            create_train_state,
            make_byol_train_step,
        )
        from nrse_tpu_torch.train.schedules import cosine_annealing

        ctx, cfg = self.ctx, self.cfg
        enc, model, opt, data = (cfg["encoder"], cfg["model"],
                                 cfg["optimizer"], cfg["data"])
        wl = ctx.workload
        made = corpus.clips(ctx.traffic, ctx.seed)
        clean_dir, _ = corpus.write_group(ctx.tmp, "clean", made["clean"])
        noise_dir, _ = corpus.write_group(ctx.tmp, "noise", made["noise"])
        del made
        dataset = NoiseRobustSpeechDataset(
            clean_dir, noise_dir, data["sample_rate"],
            data["max_audio_length"], data["snr_range"])
        self.batch = int(data["batch_size"])
        self.samples = int(data["max_audio_length"] * data["sample_rate"])
        feed = loop.Endless(dataset, len(dataset), self.batch, ctx.seed)
        self.enc_cfg = wavlm_config(enc)
        sd = weights.make(weights.byol_shapes(enc, model), ctx.seed,
                          ctx.device, enc)
        for name, shape in weights.byol_shapes(enc, model):
            if ".bn_" in name and name.endswith(".weight"):
                pre = name[:-len("weight")]
                sd[pre + "running_mean"] = torch.zeros(shape,
                                                       device=ctx.device)
                sd[pre + "running_var"] = torch.ones(shape,
                                                     device=ctx.device)
        dtype = torch.bfloat16 if ctx.device.type == "cuda" \
            else torch.float32
        self.state = state = create_train_state(
            self.enc_cfg, sd, model["projection_dim"],
            model["prediction_dim"], ctx.device, seed=ctx.seed,
            compute_dtype=dtype)
        del sd
        spec = FusedAdamWSpec(
            schedule=cosine_annealing(opt["learning_rate"],
                                      opt["schedule_steps"]),
            weight_decay=opt["weight_decay"], clip_norm=opt["clip_norm"],
            b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
            ema_decay=model["ema_decay"], optax_rates=opt["optax_rates"])
        self.b1 = opt["b1"]
        self.train_step = make_byol_train_step(spec)
        self.batches = iter(DevicePrefetcher(feed, ctx.device))
        self.online = list(state.online.named_parameters())
        self.target = list(state.target.named_parameters())
        p0 = state.params.to("cpu", copy=True)
        t0 = state.target_params.to("cpu", copy=True)
        self.checked: List[Dict] = []
        losses = []
        for i in range(wl["check_steps"]):
            batch = next(self.batches)
            batch.pop("__count__")
            self.checked.append({k: v.cpu() for k, v in batch.items()})
            out = self.train_step(state, batch)
            losses.append(out["loss"])
            if i == 0:  # mu = (1 - b1) ghat after the first update
                one_minus = float(np.float32(1.0) - np.float32(self.b1))
                grad = loop.leaf_norms(self.online, state.mu,
                                       1.0 / one_minus)
        change = {"online." + k: v for k, v in loop.leaf_norms(
            self.online, state.params, base=p0).items()}
        change.update({"target." + k: v for k, v in loop.leaf_norms(
            self.target, state.target_params, base=t0).items()})
        self.readings = {"loss": [float(x) for x in losses], "grad": grad,
                         "change": change}
        del p0, t0
        loop.sync()

    def _step(self, batch: Dict) -> Dict:
        step = self.state.step
        out = self.train_step(self.state, batch)
        return {"step": step, "finite": out["finite"]}

    def window(self, seconds: float, spans, steps=None) -> Dict:
        run = loop.run_steps(self._step, self.batches, seconds, spans, steps)
        recs = run["records"]
        finite = torch.stack([r["finite"] for r in recs]).cpu()
        audio = len(recs) * self.batch * self.samples \
            / self.cfg["data"]["sample_rate"]
        return {"records": recs, "elapsed": run["elapsed"],
                "attempted": len(recs), "failed": int((~finite).sum()),
                "metrics": {"train_audio_s_per_s": audio / run["elapsed"]}}

    def observe(self, run: Dict, obs: Dict, spans) -> None:
        """What the per-layer readers take from a traced window."""
        enc, model = self.cfg["encoder"], self.cfg["model"]
        b, t = self.batch, yardstick.frames(enc, self.samples)[-1]
        c, f, h = (enc["hidden_size"], enc["intermediate_size"],
                   enc["num_attention_heads"])
        heads = yardstick.byol_heads_flop(model["projection_dim"],
                                          model["prediction_dim"], c)
        proj = yardstick.byol_heads_flop(model["projection_dim"], 0, c)
        flop = ffn = attn = 0.0
        for r in run["records"]:
            on = sum(D.StepDraws(self.ctx.seed, r["step"], 0).layer_keep(
                enc["num_hidden_layers"], enc["layerdrop"]))
            tg = sum(D.StepDraws(self.ctx.seed, r["step"], 1).layer_keep(
                enc["num_hidden_layers"], enc["layerdrop"]))
            fo = yardstick.encoder_forward_flop(enc, self.samples, on)
            ft = yardstick.encoder_forward_flop(enc, self.samples, tg)
            flop += b * (yardstick.train_flop(fo) + 3 * heads
                         + ft["conv0"] + ft["rest"] + proj)
            ffn += on * yardstick.ffn_least(b * t, c, f, "train") \
                + tg * yardstick.ffn_least(b * t, c, f, "target")
            attn += on * yardstick.attention_least(
                b, h, t, c // h, "train", t <= 384) \
                + tg * yardstick.attention_least(b, h, t, c // h, "fwd",
                                                 t <= 384)
        obs.update({"steps": len(run["records"]), "model_flop": flop,
                    "ffn_least_s": ffn, "attention_least_s": attn,
                    "mask_samples": None, "computed_samples": None,
                    "host_wait_s": spans.seconds.get("loader_wait", 0.0)})

    def release(self) -> None:
        self.batches.close()
        del self.state, self.train_step, self.batches
        loop.free_card()

    def check(self, q=None) -> Dict:
        """The reference (or, with ``q``, the control) over the checked
        batches from the same weights: its readings."""
        cfg, ctx = self.cfg, self.ctx
        params = weights.make(weights.byol_shapes(cfg["encoder"],
                                                  cfg["model"]),
                              ctx.seed, ctx.device, cfg["encoder"])
        batches = [{k: v.to(ctx.device) for k, v in b.items()}
                   for b in self.checked]
        kw = {} if q is None else {"q": q}
        out = ref.byol_follow(cfg, params, batches, ctx.seed, **kw)
        del params, batches
        loop.free_card()
        return out
