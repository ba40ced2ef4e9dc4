"""Export and serve the WavLM embedder and the SER classifier.

Port of ``nrse_tpu/serve/export.py`` (``export_embedder`` :113-180,
``export_classifier`` :183-227, ``ServingModel`` :230-318, the export CLI
:325-364).  Artifact layout, one directory:

    manifest.json   — kind (``embed`` or ``classify``), buckets,
                      with_mask, clip_seconds, sample_rate, outputs,
                      encoder_config, weights (the keys of the JAX
                      package's unbaked layout), and for the classifier
                      task, hidden_dim and num_emotions
    params.pt       — the state dict (the embedder's in HF ``WavLMModel``
                      layout, the classifier's that of
                      ``models.emotion.EmotionClassifier``), loaded once
                      when the server starts

Serving traffic is ragged: :class:`ServingModel` pads each request to the
clip length with a mask, routes it to the smallest batch bucket that fits,
chunks requests larger than the biggest bucket, and slices the padding
rows off the results.

The JAX artifact holds one compiled program per bucket
(``embed_b{B}.stablehlo``).  Its counterpart here is a CUDA graph per
bucket (a ``runtime.graphs.BucketProgram`` of one ``ProgramCache``),
captured when the server loads on the card, all buckets in the cache's
one memory pool, and replayed per request; a
graph holds device addresses and cannot be written to a file, so the
artifact stays as it is and every load captures anew.  A capture that
fails raises.  On the CPU each bucket runs the module's forward.

    python -m nrse_tpu_torch.serve.export --config <preset or yaml> \\
        --checkpoint <train_byol checkpoint_dir>/best_val_loss \\
        --out <dir> --batch-sizes 1,8 [--device cuda|cpu]

writes an embedder artifact of a BYOL checkpoint's online encoder, then
serves one request from it on the device as a check.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from nrse_tpu_torch.models.emotion import TASKS, EmotionClassifier
from nrse_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from nrse_tpu_torch.runtime.device import resolve_device
from nrse_tpu_torch.runtime.graphs import ProgramCache, audio_inputs

_MANIFEST = "manifest.json"
_WEIGHTS = "params.pt"
# the classifier's outputs for each task (JAX's ``export.py:213-216``)
CLASSIFIER_OUTPUTS = {
    "categorical": ["categorical_logits"],
    "dimensional": ["dimensional_values"],
    "both": ["categorical_logits", "dimensional_values"]}


def _cpu_tensors(state_dict: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v)
            else v.detach().cpu() for k, v in state_dict.items()}


def _write(module: nn.Module, sd: Dict[str, torch.Tensor], out_dir: str,
           manifest: Dict) -> str:
    """Strict-load ``sd`` into ``module`` (built on ``meta``), then write
    the weights and the manifest."""
    module.load_state_dict(sd, strict=True, assign=True)
    os.makedirs(out_dir, exist_ok=True)
    torch.save(sd, os.path.join(out_dir, _WEIGHTS))
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump({**manifest, "weights": _WEIGHTS}, f, indent=2)
    return out_dir


def export_embedder(state_dict: Mapping[str, object], config: WavLMConfig,
                    out_dir: str, batch_sizes: Sequence[int] = (1, 8),
                    clip_seconds: float = 5.0,
                    sample_rate: int = 16000) -> str:
    """Write the deterministic embedder's serving artifact to ``out_dir``.

    ``state_dict``: the port's WavLM state dict (torch tensors or numpy
    arrays, e.g. from ``models.convert``).  It is checked by a strict load
    before anything is written."""
    return _write(WavLMModel(config, device="meta"), _cpu_tensors(state_dict),
                  out_dir, {
                      "kind": "embed",
                      "buckets": sorted(int(b) for b in batch_sizes),
                      "with_mask": True, "clip_seconds": clip_seconds,
                      "sample_rate": sample_rate,
                      "outputs": ["sequence", "pooled"],
                      "encoder_config": dataclasses.asdict(config)})


def export_classifier(state_dict: Mapping[str, object],
                      encoder_config: WavLMConfig, out_dir: str,
                      batch_sizes: Sequence[int] = (1, 8),
                      clip_seconds: float = 5.0, sample_rate: int = 16000,
                      task: str = "both", hidden_dim: int = 1024,
                      num_emotions: int = 8) -> str:
    """Write the SER classifier's serving artifact (audio + mask → the
    categorical logits ``[B, num_emotions]``, the A/V/D values ``[B, 3]``,
    or both, per ``task``) to ``out_dir``.

    ``state_dict``: an :class:`~nrse_tpu_torch.models.emotion.
    EmotionClassifier` state dict, checked by a strict load before
    anything is written."""
    if task not in TASKS:
        raise ValueError(f"task must be one of {TASKS}, got {task!r}")
    module = EmotionClassifier(encoder_config, hidden_dim,
                               num_emotions=num_emotions, device="meta")
    return _write(module, _cpu_tensors(state_dict), out_dir, {
        "kind": "classify", "buckets": sorted(int(b) for b in batch_sizes),
        "with_mask": True, "clip_seconds": clip_seconds,
        "sample_rate": sample_rate, "task": task,
        "outputs": CLASSIFIER_OUTPUTS[task],
        "encoder_config": dataclasses.asdict(encoder_config),
        "hidden_dim": hidden_dim, "num_emotions": num_emotions})


class ServingModel:
    """Loads an artifact directory once and serves ragged batches on
    ``device``: the encoder in bf16 on a CUDA device (the kernels' type),
    in float32 on the CPU (the plain paths, the reference); the
    classifier's pooling statistics and trunks work in float32 on both.
    ``programs`` holds each bucket's :class:`~nrse_tpu_torch.runtime.
    graphs.BucketProgram` from the :class:`~nrse_tpu_torch.runtime.graphs.
    ProgramCache` ``cache``: on a CUDA device every bucket is captured
    here, largest first, into the cache's one pool.
    """

    def __init__(self, artifact_dir: str, device="cuda"):
        with open(os.path.join(artifact_dir, _MANIFEST)) as f:
            self.manifest = json.load(f)
        self.kind = self.manifest.get("kind")
        if self.kind not in ("embed", "classify"):
            raise ValueError(f"not a serving artifact: {self.kind!r}")
        self.device = resolve_device(device)
        dtype = (torch.bfloat16 if self.device.type == "cuda"
                 else torch.float32)
        self.config = WavLMConfig(**self.manifest["encoder_config"])
        self.buckets = sorted(int(b) for b in self.manifest["buckets"])
        self.with_mask = self.manifest.get("with_mask", True)
        self.clip_samples = int(self.manifest["clip_seconds"]
                                * self.manifest["sample_rate"])
        self.task = self.manifest.get("task")
        sd = torch.load(os.path.join(artifact_dir, self.manifest["weights"]),
                        map_location="cpu", weights_only=True)
        if self.kind == "embed":
            model = WavLMModel(self.config, device="meta")
        else:
            model = EmotionClassifier(
                self.config, self.manifest["hidden_dim"],
                num_emotions=self.manifest["num_emotions"], device="meta")
        model.load_state_dict(sd, strict=True, assign=True)
        # weights move to the device and the working dtype once, here; the
        # classifier's heads stay float32
        encoder = model if self.kind == "embed" else model.encoder
        encoder.to(dtype=dtype)
        self.model = model.to(self.device).eval()
        self.cache = ProgramCache(self.forward, self.device,
                                  audio_inputs(self.with_mask))
        self.cache.prepare(((b, self.clip_samples),) * 2
                           for b in self.buckets)
        self.programs = {b: self.cache.program(*((b, self.clip_samples),) * 2)
                         for b in self.buckets}

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def plan(self, n: int) -> List[Tuple[int, int]]:
        """``(rows, bucket)`` for each forward that a request of ``n`` rows
        takes."""
        out, start = [], 0
        while start < n:
            chunk = min(n - start, self.buckets[-1])
            out.append((chunk, self._bucket_for(chunk)))
            start += chunk
        return out

    def forward(self, audio: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        """One bucket's forward on the device, eagerly (what each bucket's
        graph captures, and the yardstick its replays are held to): the
        embedder's ``(sequence, pooled)`` or the outputs the classifier's
        task names."""
        with torch.inference_mode():
            if self.kind == "embed":
                return self.model(audio, mask)
            logits, dims = self.model(audio, mask, self.task)
            return tuple(o for o in (logits, dims) if o is not None)

    def __call__(self, audio: np.ndarray, mask: Optional[np.ndarray] = None):
        """``audio [N, T]`` (T ≤ the exported clip length; shorter audio
        is zero-padded and masked) → float32 numpy arrays, N rows each:
        the embedder's ``(sequence [N, T', C], pooled [N, C])``; the
        classifier's logits ``[N, num_emotions]``, A/V/D ``[N, 3]``, or
        both as a tuple.  N larger than the biggest bucket is chunked;
        each chunk is written whole into its bucket's static inputs and
        its rows copied out before the next replay."""
        audio = np.asarray(audio, np.float32)
        n, t = audio.shape
        if t > self.clip_samples:
            raise ValueError(f"audio length {t} exceeds the exported clip "
                             f"length {self.clip_samples}")
        if mask is None:
            mask = np.zeros((n, self.clip_samples), np.int32)
            mask[:, :t] = 1
        elif mask.shape[1] != self.clip_samples:
            mask = np.pad(np.asarray(mask, np.int32),
                          ((0, 0), (0, self.clip_samples - mask.shape[1])))
        if t < self.clip_samples:
            audio = np.pad(audio, ((0, 0), (0, self.clip_samples - t)))

        outs: List[Tuple[np.ndarray, ...]] = []
        start = 0
        for chunk, b in self.plan(n):
            a = np.zeros((b, self.clip_samples), np.float32)
            m = np.zeros((b, self.clip_samples), np.int32)
            a[:chunk] = audio[start:start + chunk]
            m[:chunk] = mask[start:start + chunk]
            # padding rows keep an all-zero mask; the model's masked
            # pooling/attention ignores them and the rows are sliced off
            m[chunk:, 0] = 1  # avoid fully-empty frame counts downstream
            program = self.programs[b]
            program.load(a, m)
            res = program.run()
            outs.append(tuple(r[:chunk].float().cpu().numpy() for r in res))
            start += chunk
        joined = tuple(np.concatenate(parts) for parts in zip(*outs))
        return joined if len(joined) > 1 else joined[0]


def load_serving_model(artifact_dir: str, device="cuda") -> ServingModel:
    return ServingModel(artifact_dir, device)


def main(argv=None) -> str:
    """Export a BYOL checkpoint's online encoder as an embedder artifact
    and answer one request from it on the device; returns the artifact
    directory."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True,
                    help="YAML config file, or a preset name of "
                         "nrse_tpu_torch/config/presets")
    ap.add_argument("--checkpoint", required=True,
                    help="a checkpoint directory of train_byol "
                         "(<checkpoint_dir>/<name>)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch-sizes", default="1,8")
    ap.add_argument("--device", default=None, help="cuda or cpu")
    args = ap.parse_args(argv)

    from nrse_tpu_torch.config.config_utils import get_config
    from nrse_tpu_torch.train.categorical_emotions import encoder_config_from
    from nrse_tpu_torch.train.checkpoint import load_byol_encoder

    cfg_args = ["--config", args.config]
    if args.device:
        cfg_args += ["--device", args.device]
    config = get_config(cfg_args)
    device = resolve_device(config["device"])
    enc_cfg = encoder_config_from(config)
    out = export_embedder(
        load_byol_encoder(args.checkpoint, enc_cfg), enc_cfg, args.out,
        batch_sizes=[int(b) for b in args.batch_sizes.split(",")],
        clip_seconds=float(config["data"]["max_audio_length"]),
        sample_rate=int(config["data"]["sample_rate"]))
    server = ServingModel(out, device)
    _, pooled = server(np.zeros((1, server.clip_samples), np.float32))
    print(f"serving artifact written to {out}; one request on "
          f"{device.type}: pooled {pooled.shape}", flush=True)
    return out


if __name__ == "__main__":
    main()
