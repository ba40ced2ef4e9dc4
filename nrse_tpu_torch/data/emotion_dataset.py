"""MSP-Podcast emotion dataset and its loaders.

Port of ``nrse_tpu/data/emotion_dataset.py:32-209`` (capability parity
with the reference's ``src/data/emotion_dataset.py:12-313``): parse
``labels_consensus.csv`` (``FileName, EmoClass, EmoAct, EmoVal, EmoDom,
Split_Set, SpkrID, Gender``) with the ``csv`` module, keep the rows of one
split whose class is in the map (A/H/S/F/U/D/C/N → 0–7, and X → 8, O → 9
unless ``categorical_only``) and whose file exists; per item, decode →
mono → resample → random crop or zero-pad to ``max_audio_length``, a mask
of the true length, optional noise at a random SNR from ``snr_range``
(the mask unchanged), a ``1e-6`` waveform for a file that does not
decode.  Given the same ``np.random.Generator`` an item equals the JAX
package's bit for bit: the crop, the noise file, its crop, the SNR.

Items are fixed-shape numpy arrays (``input_values``, ``attention_mask``
``[max_samples]`` float32, ``C`` int32, ``A``/``V``/``D`` float32); the
z-normalisation runs on the device inside the task step.
"""

from __future__ import annotations

import csv
import os
from collections import Counter
from typing import Dict, List, Optional

import numpy as np

from nrse_tpu_torch.audio.io import get_audio_files, load_audio
from nrse_tpu_torch.audio.resample import resample
from nrse_tpu_torch.data.loader import HostDataLoader
from nrse_tpu_torch.data.noisy_speech_dataset import add_noise_to_speech
from nrse_tpu_torch.labels.parsing import EMOTIONS_MAP, VALID_EMOTIONS_MAP
from nrse_tpu_torch.utils.logging_utils import logger


class EmotionDataset:
    VALID_EMOTIONS_MAP = VALID_EMOTIONS_MAP
    EMOTIONS_MAP = EMOTIONS_MAP

    def __init__(self,
                 labels_file: str,
                 audio_dir: Optional[str] = None,
                 noise_dir: Optional[str] = None,
                 split: Optional[str] = None,
                 sample_rate: int = 16000,
                 max_audio_length: float = 5.0,
                 add_noise: bool = False,
                 snr_range: Optional[List[float]] = None,
                 categorical_only: bool = True):
        self.audio_dir = audio_dir
        self.sample_rate = sample_rate
        self.max_samples = int(max_audio_length * sample_rate)
        self.add_noise = add_noise
        self.categorical_only = categorical_only
        self.emotion_mapping = (
            VALID_EMOTIONS_MAP if categorical_only else EMOTIONS_MAP
        )
        self.idx_to_emotion = {v: k for k, v in self.emotion_mapping.items()}

        with open(labels_file, newline="") as f:
            rows = list(csv.DictReader(f))
        if split:
            rows = [r for r in rows if r["Split_Set"] == split]
        rows = [r for r in rows if r["EmoClass"] in self.emotion_mapping]

        self.samples = []
        skipped = 0
        for row in rows:
            file_name = row["FileName"]
            path = os.path.join(audio_dir, file_name) if audio_dir \
                else file_name
            if not os.path.exists(path):
                logger.warning(f"Audio file not found: {path}")
                skipped += 1
                continue
            self.samples.append({
                "file_path": path,
                "category": row["EmoClass"],
                "category_idx": self.emotion_mapping[row["EmoClass"]],
                "arousal": float(row["EmoAct"]),
                "valence": float(row["EmoVal"]),
                "dominance": float(row["EmoDom"]),
                "speaker_id": row.get("SpkrID"),
                "gender": row.get("Gender"),
            })

        logger.info(f"Loaded {len(self.samples)} valid samples from "
                    f"{labels_file}")
        if split:
            logger.info(f"Using split: {split}")
        if skipped:
            logger.info(f"Skipped {skipped} invalid samples")

        self.noise_files: List[str] = []
        if add_noise and noise_dir:
            self.noise_files = get_audio_files(noise_dir)
            self.snr_range = snr_range or [0, 5, 10, 15, 20]
            logger.info(
                f"Found {len(self.noise_files)} noise files for augmentation"
            )
        self._log_category_distribution()

    def _log_category_distribution(self):
        counts = Counter(s["category"] for s in self.samples)
        total = max(1, len(self.samples))
        logger.info("Category distribution:")
        for category, count in sorted(counts.items()):
            logger.info(
                f"  {category}: {count} samples ({count / total * 100:.2f}%)"
            )

    def class_counts(self) -> Dict[int, int]:
        """``{class index: count}`` over this split (for class weights)."""
        return Counter(s["category_idx"] for s in self.samples)

    def __len__(self) -> int:
        return len(self.samples)

    def _load_with_length(self, path: str, rng) -> Optional[tuple]:
        """Decode → mono → resample → crop or pad: ``(wav [1, max_samples]
        float32, true length)``, or None for a file that does not decode,
        holds NaN or is silent."""
        try:
            wav, sr = load_audio(path)
            if wav.shape[0] > 1:
                wav = wav.mean(axis=0, keepdims=True)
            if sr != self.sample_rate:
                wav = resample(wav, sr, self.sample_rate)
            n = wav.shape[1]
            if n > self.max_samples:
                start = int(rng.integers(0, n - self.max_samples + 1))
                wav = wav[:, start:start + self.max_samples]
                n = self.max_samples
            elif n < self.max_samples:
                wav = np.pad(wav, ((0, 0), (0, self.max_samples - n)))
            if np.isnan(wav).any() or np.abs(wav).max() < 1e-8:
                return None
            return wav.astype(np.float32), n
        except Exception as e:  # the item falls back, the epoch goes on
            logger.error(f"Error loading audio {path}: {e}")
            return None

    def sample(self, idx: int, rng: np.random.Generator
               ) -> Dict[str, np.ndarray]:
        s = self.samples[idx]
        loaded = self._load_with_length(s["file_path"], rng)
        if loaded is None:
            logger.warning(f"Creating fallback tensor for {s['file_path']}")
            wav = np.full((1, self.max_samples), 1e-6, np.float32)
            length = self.max_samples
        else:
            wav, length = loaded

        mask = np.zeros((self.max_samples,), np.float32)
        mask[:length] = 1.0

        if self.add_noise and self.noise_files:
            noise_path = self.noise_files[
                int(rng.integers(0, len(self.noise_files)))]
            noise = self._load_with_length(noise_path, rng)
            if noise is not None:
                snr = self.snr_range[int(rng.integers(0,
                                                      len(self.snr_range)))]
                noisy = add_noise_to_speech(wav, noise[0], snr)
                if noisy is not None:
                    wav = noisy  # mask unchanged (length identical)

        return {
            "input_values": wav[0],
            "attention_mask": mask,
            "C": np.int32(s["category_idx"]),
            "A": np.float32(s["arousal"]),
            "V": np.float32(s["valence"]),
            "D": np.float32(s["dominance"]),
        }


def create_emotion_dataloaders(config):
    """``(train, validation)`` loaders from the ``emotion`` config block
    (reference ``create_emotion_dataloaders``, ``emotion_dataset.py:
    268-313``, the misspelled ``validataion_dataset_split`` key included):
    the train loader shuffles and drops its last ragged batch, the
    validation loader pads it and reports ``__count__``."""
    em = config["emotion"]
    data = config["data"]
    logger.info("Creating datasets")
    common = dict(
        labels_file=em["labels_file"],
        audio_dir=em.get("audio_dir"),
        noise_dir=data.get("noise_data_path"),
        sample_rate=data["sample_rate"],
        max_audio_length=data["max_audio_length"],
        add_noise=em.get("add_noise_during_training", False),
        snr_range=data.get("snr_range"),
        categorical_only=em.get("categorical_only", True),
    )
    train_dataset = EmotionDataset(split=em["train_dataset_split"], **common)
    val_dataset = EmotionDataset(split=em["validataion_dataset_split"],
                                 **common)

    logger.info("Creating dataloaders")
    num_workers = config["training"].get("num_workers", 8)
    bs = em["batch_size"]
    seed = config["training"].get("seed", 42)
    train_loader = HostDataLoader(
        train_dataset, np.arange(len(train_dataset)), bs, shuffle=True,
        seed=seed, num_workers=num_workers, drop_last=True,
    )
    val_loader = HostDataLoader(
        val_dataset, np.arange(len(val_dataset)), bs, shuffle=False,
        seed=seed, num_workers=num_workers, drop_last=False,
    )
    return train_loader, val_loader
