"""Export and serve the WavLM embedder.

Port of ``nrse_tpu/serve/export.py`` (``export_embedder`` :113-180,
``ServingModel`` :230-318) for the embedder.  Artifact layout, one
directory:

    manifest.json   — kind, buckets, with_mask, clip_seconds, sample_rate,
                      outputs, encoder_config, weights (the keys of the JAX
                      package's unbaked layout; there is no per-bucket
                      program file, since PyTorch runs the module eagerly)
    params.pt       — the state dict (HF ``WavLMModel`` layout), loaded once
                      when the server starts

Serving traffic is ragged: :class:`ServingModel` pads each request to the
clip length with a mask, routes it to the smallest batch bucket that fits,
chunks requests larger than the biggest bucket, and slices the padding
rows off the results.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from nrse_tpu_torch.models.wavlm import WavLMConfig, WavLMModel

_MANIFEST = "manifest.json"
_WEIGHTS = "params.pt"


def export_embedder(state_dict: Mapping[str, object], config: WavLMConfig,
                    out_dir: str, batch_sizes: Sequence[int] = (1, 8),
                    clip_seconds: float = 5.0,
                    sample_rate: int = 16000) -> str:
    """Write the deterministic embedder's serving artifact to ``out_dir``.

    ``state_dict``: the port's WavLM state dict (torch tensors or numpy
    arrays, e.g. from ``models.convert``).  It is checked by a strict load
    before anything is written."""
    sd = {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v)
          else v.detach().cpu() for k, v in state_dict.items()}
    WavLMModel(config, device="meta").load_state_dict(sd, strict=True,
                                                      assign=True)
    os.makedirs(out_dir, exist_ok=True)
    torch.save(sd, os.path.join(out_dir, _WEIGHTS))
    manifest = {
        "kind": "embed",
        "buckets": sorted(int(b) for b in batch_sizes),
        "with_mask": True,
        "clip_seconds": clip_seconds,
        "sample_rate": sample_rate,
        "outputs": ["sequence", "pooled"],
        "encoder_config": dataclasses.asdict(config),
        "weights": _WEIGHTS,
    }
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return out_dir


class ServingModel:
    """Loads an artifact directory once and serves ragged batches on
    ``device``: in bf16 on a CUDA device (the kernels' type), in float32
    on the CPU (the plain paths, the reference).
    """

    def __init__(self, artifact_dir: str, device="cuda"):
        with open(os.path.join(artifact_dir, _MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest.get("kind") != "embed":
            raise ValueError(f"not an embedder artifact: "
                             f"{self.manifest.get('kind')!r}")
        self.device = torch.device(device)
        dtype = (torch.bfloat16 if self.device.type == "cuda"
                 else torch.float32)
        self.config = WavLMConfig(**self.manifest["encoder_config"])
        self.buckets = sorted(int(b) for b in self.manifest["buckets"])
        self.with_mask = self.manifest.get("with_mask", True)
        self.clip_samples = int(self.manifest["clip_seconds"]
                                * self.manifest["sample_rate"])
        sd = torch.load(os.path.join(artifact_dir, self.manifest["weights"]),
                        map_location="cpu", weights_only=True)
        model = WavLMModel(self.config, device="meta")
        model.load_state_dict(sd, strict=True, assign=True)
        # weights move to the device and the working dtype once, here
        self.model = model.to(device=self.device, dtype=dtype).eval()

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

    def _forward(self, audio: np.ndarray, mask: np.ndarray):
        a = torch.from_numpy(audio).to(self.device)
        m = torch.from_numpy(mask).to(self.device) if self.with_mask else None
        with torch.inference_mode():
            return self.model(a, m)

    def __call__(self, audio: np.ndarray, mask: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """``audio [N, T]`` (T ≤ the exported clip length; shorter audio
        is zero-padded and masked) → ``(sequence [N, T', C], pooled
        [N, C])`` as float32 numpy arrays.  N larger than the biggest
        bucket is chunked."""
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
            res = self._forward(a, m)
            outs.append(tuple(r[:chunk].float().cpu().numpy() for r in res))
            start += chunk
        seq, pooled = (np.concatenate(parts) for parts in zip(*outs))
        return seq, pooled


def load_serving_model(artifact_dir: str, device="cuda") -> ServingModel:
    return ServingModel(artifact_dir, device)

