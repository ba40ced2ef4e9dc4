"""The SER evaluator as ``nrse_tpu_torch.baseline.eval_cat_ser`` runs it:
``bucketed_forward_timed`` in its default copy mode over a
``ProgramCache`` of ``BaselineSER``'s forward, pass after pass over one
list of clips held in host memory.

The cache is handed to the evaluator through a thin proxy that counts
what each forward is given (in traced runs, the mask's samples); set-up
captures the list's bucket shapes and runs one untimed pass."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench import corpus, loop, trace, weights, yardstick
from portbench.entries.byol import wavlm_config
from portbench.reference import models as ref


class Forward:
    """``forward(x, mask)`` → the cache's logits; with ``spans`` on, each
    call is a span and its mask's samples are summed on the device."""

    def __init__(self, cache, spans: trace.Spans):
        self.cache, self.spans = cache, spans
        self.shapes: List = []
        self.mask = []

    def __call__(self, x, mask):
        if not self.spans.on:
            return self.cache(x, mask)
        with self.spans("forward"):
            self.shapes.append(tuple(x.shape))
            self.mask.append(mask.sum())
            return self.cache(x, mask)


class Cell:
    kind = "eval"

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config

    def setup(self) -> None:
        from nrse_tpu_torch.baseline.pipeline import (
            BaselineSER,
            bucket_length,
            make_baseline_forward,
        )
        from nrse_tpu_torch.baseline.wavset import WavNormStats

        ctx, cfg, wl = self.ctx, self.cfg, self.ctx.workload
        enc, head = cfg["encoder"], cfg["head"]
        made = corpus.clips(ctx.traffic, ctx.seed)
        wavs = [w for group in ctx.traffic["groups"]
                for w in made[group["name"]]]
        order = np.random.default_rng(
            [ctx.seed & (2**64 - 1), 0xE7]).permutation(len(wavs))
        stats = WavNormStats.from_waveforms(wavs)
        self.loaded = [(int(i), stats.apply(wavs[i])) for i in order]
        self.seconds_of = {i: len(w) / cfg["data"]["sample_rate"]
                           for i, w in self.loaded}
        self.batch = int(cfg["data"]["batch_size"])
        dtype = torch.bfloat16 if ctx.device.type == "cuda" \
            else torch.float32
        model = BaselineSER(wavlm_config(enc), head_dim=head["head_dim"],
                            num_classes=head["num_classes"],
                            dropout=head["dropout"], device="meta",
                            compute_dtype=dtype)
        model.load_state_dict(weights.make(weights.ser_shapes(enc, head),
                                           ctx.seed, ctx.device, enc),
                              strict=True, assign=True)
        self.model = model.to(ctx.device)
        self.cache = make_baseline_forward(self.model, graphs=True)
        self.cache.prepare(((self.batch, bucket_length(len(w))),) * 2
                           for _, w in self.loaded)
        self.spans = trace.Spans(False)
        self.forward = Forward(self.cache, self.spans)
        self._pass()  # untimed: every copy path warm

    def _pass(self):
        from nrse_tpu_torch.baseline.eval_cat_ser import (
            bucketed_forward_timed,
        )

        with self.spans("pass"):
            results, _, _ = bucketed_forward_timed(
                self.forward, self.loaded, self.batch, self.ctx.device)
        return results

    def window(self, seconds: float, spans, steps=None) -> Dict:
        self.spans.on = spans.on
        self.spans.seconds, self.spans.counts = spans.seconds, spans.counts
        self.forward.shapes, self.forward.mask = [], []
        passes, clips, audio, failed = 0, 0, 0.0, 0
        t0 = time.perf_counter()
        with trace.window_range(spans):
            while True:
                results = self._pass()
                passes += 1
                for i, logits in results:
                    clips += 1
                    audio += self.seconds_of[i]
                    failed += int(not np.isfinite(logits).all())
                if (steps is not None and passes >= steps) or (
                        steps is None
                        and time.perf_counter() - t0 >= seconds):
                    break
            loop.sync()
            elapsed = time.perf_counter() - t0
        self.readings = {i: logits for i, logits in results}
        return {"records": [], "passes": passes, "elapsed": elapsed,
                "attempted": clips, "failed": failed,
                "metrics": {"eval_audio_s_per_s": audio / elapsed}}

    def observe(self, run: Dict, obs: Dict, spans) -> None:
        enc, head = self.cfg["encoder"], self.cfg["head"]
        c, f = enc["hidden_size"], enc["intermediate_size"]
        flop = sum(
            yardstick.encoder_forward_flop(enc, len(w),
                                           enc["num_hidden_layers"])["rest"]
            + yardstick.encoder_forward_flop(enc, len(w), 0)["conv0"]
            + yardstick.ser_head_flop(enc, head,
                                      yardstick.frames(enc, len(w))[-1])
            for _, w in self.loaded) * run["passes"]
        ffn = sum(enc["num_hidden_layers"] * yardstick.ffn_least(
            b * yardstick.frames(enc, t)[-1], c, f, "serve")
            for b, t in self.forward.shapes)
        mask = float(torch.stack(self.forward.mask).double().sum().cpu())
        computed = float(sum(b * t for b, t in self.forward.shapes))
        obs.update({"passes": run["passes"], "model_flop": flop,
                    "ffn_least_s": ffn, "attention_least_s": None,
                    "mask_samples": mask, "computed_samples": computed,
                    "host_wait_s": None})

    def release(self) -> None:
        del self.forward, self.cache, self.model
        loop.free_card()

    def check(self, q=None) -> Dict:
        """The reference's logits of every clip of the window's last pass,
        at its bucket length with its mask, in blocks of rows."""
        from nrse_tpu_torch.baseline.pipeline import bucket_length

        cfg, ctx = self.cfg, self.ctx
        params = weights.make(weights.ser_shapes(cfg["encoder"],
                                                 cfg["head"]),
                              ctx.seed, ctx.device, cfg["encoder"])
        kw = {} if q is None else {"q": q}
        buckets: Dict[int, list] = {}
        for i, w in self.loaded:
            buckets.setdefault(bucket_length(len(w)), []).append((i, w))
        block = self.ctx.workload["reference_rows"]
        out = {}
        for blen, items in sorted(buckets.items()):
            for s in range(0, len(items), block):
                chunk = items[s:s + block]
                x = torch.zeros(len(chunk), blen)
                m = torch.zeros(len(chunk), blen)
                for j, (_, w) in enumerate(chunk):
                    x[j, :len(w)] = torch.from_numpy(w[:blen])
                    m[j, :len(w)] = 1.0
                logits = ref.eval_logits(cfg, params, x.to(ctx.device),
                                         m.to(ctx.device), **kw).cpu()
                for j, (i, _) in enumerate(chunk):
                    out[i] = logits[j].numpy()
        del params
        loop.free_card()
        return out
