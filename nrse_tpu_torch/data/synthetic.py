"""Synthetic speech-like corpus generation (on-disk WAVs).

The port's copy of ``nrse_tpu/data/synthetic.py:21-211``, on the port's
``audio/io.py``: for the same seed it writes the same WAV bytes and label
CSV.  There is no MSP-Podcast or AudioSet data at hand, so quality and
data-fed throughput runs train on a generated corpus.  Files are
*structured*, not white noise: harmonic voices with pitch contours,
formant envelopes and syllabic modulation for "speech", and a mix of
coloured/tonal/impulsive interference for "noise", in the spirit of the
reference's mock fixture (``test/create_mock_dataset.py:4-25``) scaled to
a corpus.
"""

from __future__ import annotations

import os
import time

import numpy as np


def synth_speech_like(rng: np.random.Generator, seconds: float,
                      sample_rate: int = 16000, *,
                      f0_range=(85.0, 255.0), am_range=(2.5, 5.0),
                      formant_scale: float = 1.0, roughness: float = 0.0,
                      pitch_rise: float = 0.0) -> np.ndarray:
    """One pseudo-utterance: harmonics of a wandering f0 shaped by a
    random 3-formant envelope, with syllabic amplitude modulation and an
    onset/offset ramp.  The keyword knobs define acoustic *regimes* —
    the emotion corpus maps classes onto distinct regions of this space
    (prosody/voice-quality correlates: pitch level/slope, speaking rate,
    formant shift, roughness)."""
    n = int(seconds * sample_rate)
    t = np.arange(n) / sample_rate
    f0 = float(rng.uniform(*f0_range))
    vibrato = 1.0 + 0.08 * np.sin(
        2 * np.pi * rng.uniform(2.0, 6.0) * t + rng.uniform(0, 2 * np.pi)
    )
    contour = vibrato * (1.0 + pitch_rise * t / max(seconds, 1e-6))
    phase = 2 * np.pi * np.cumsum(f0 * contour) / sample_rate

    formants = rng.uniform((300.0, 900.0, 1900.0),
                           (800.0, 1800.0, 2800.0)) * formant_scale
    bw = np.array([90.0, 140.0, 200.0])
    x = np.zeros(n)
    max_h = max(2, min(int(4000.0 / f0), 40))
    for h in range(1, max_h + 1):
        fh = h * f0
        amp = float(np.sum(np.exp(-((fh - formants) ** 2) / (2 * bw**2))))
        amp += 0.05 / h  # spectral tilt floor
        if roughness:
            amp *= 1.0 + roughness * rng.standard_normal()
        x += amp * np.sin(h * phase)

    syll = np.sin(2 * np.pi * rng.uniform(*am_range) * t
                  + rng.uniform(0, 2 * np.pi))
    env = 0.15 + 0.85 * np.clip(syll, 0.0, None) ** rng.uniform(0.5, 2.0)
    ramp = np.minimum(1.0, np.minimum(t, seconds - t) / 0.05)
    x *= env * ramp
    x += (0.003 + 0.02 * roughness) * rng.standard_normal(n)  # breath/rasp
    x /= np.abs(x).max() + 1e-8
    return (0.3 * x).astype(np.float32)


def synth_noise(rng: np.random.Generator, seconds: float,
                sample_rate: int = 16000) -> np.ndarray:
    """One interference clip: white / pink / tonal-hum / impulsive, chosen
    at random (AudioSet-ish variety on a budget)."""
    n = int(seconds * sample_rate)
    kind = rng.integers(0, 4)
    if kind == 0:  # white
        x = rng.standard_normal(n)
    elif kind == 1:  # pink-ish via FFT 1/f shaping
        spec = np.fft.rfft(rng.standard_normal(n))
        f = np.maximum(np.fft.rfftfreq(n, 1.0 / sample_rate), 1.0)
        x = np.fft.irfft(spec / np.sqrt(f), n)
    elif kind == 2:  # tonal hum + harmonics
        t = np.arange(n) / sample_rate
        base = rng.uniform(50.0, 400.0)
        x = sum(
            rng.uniform(0.2, 1.0) * np.sin(2 * np.pi * base * h * t
                                           + rng.uniform(0, 2 * np.pi))
            for h in (1, 2, 3)
        )
        x += 0.1 * rng.standard_normal(n)
    else:  # impulsive clatter over a noise bed
        x = 0.1 * rng.standard_normal(n)
        for _ in range(int(rng.integers(3, 12))):
            pos = int(rng.integers(0, max(1, n - 800)))
            length = int(rng.integers(100, 800))
            x[pos:pos + length] += rng.uniform(0.5, 2.0) * np.exp(
                -np.arange(length) / rng.uniform(20.0, 200.0)
            ) * rng.standard_normal(length)
    x /= np.abs(x).max() + 1e-8
    return (0.25 * x).astype(np.float32)


def generate_corpus(root: str, n_clean: int, n_noise: int,
                    seconds: float = 5.0, sample_rate: int = 16000,
                    duration_jitter: float = 0.2, seed: int = 0,
                    verbose: bool = True):
    """Write ``clean/`` and ``noise/`` WAV trees under ``root`` (idempotent:
    a ``.complete`` marker skips regeneration).  Returns (clean_dir,
    noise_dir)."""
    from nrse_tpu_torch.audio.io import save_wav

    clean_dir = os.path.join(root, "clean")
    noise_dir = os.path.join(root, "noise")
    marker = os.path.join(root, ".complete")
    if os.path.exists(marker):
        return clean_dir, noise_dir
    os.makedirs(clean_dir, exist_ok=True)
    os.makedirs(noise_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    # Resume support for large (100k+ file) corpora: an interrupted run
    # leaves files behind; regenerate only the missing ones.  Skipped files
    # do not consume RNG draws, so a resumed run's remaining files differ
    # from a from-scratch run — fine for a throughput corpus, documented
    # here so nobody expects bitwise-identical trees.
    for i in range(n_clean):
        path = os.path.join(clean_dir, f"speech_{i:06d}.wav")
        if not (os.path.exists(path) and os.path.getsize(path) > 1024):
            dur = seconds * float(
                rng.uniform(1.0 - duration_jitter, 1.0 + duration_jitter)
            )
            save_wav(path, synth_speech_like(rng, dur, sample_rate),
                     sample_rate)
        if verbose and (i + 1) % 1000 == 0:
            print(f"# corpus: {i + 1}/{n_clean} clean "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    for i in range(n_noise):
        path = os.path.join(noise_dir, f"noise_{i:06d}.wav")
        if not (os.path.exists(path) and os.path.getsize(path) > 1024):
            save_wav(path, synth_noise(rng, seconds, sample_rate),
                     sample_rate)
    with open(marker, "w") as f:
        f.write(f"{n_clean} {n_noise} {seconds}\n")
    if verbose:
        print(f"# corpus: {n_clean}+{n_noise} files in "
              f"{time.perf_counter() - t0:.0f}s at {root}", flush=True)
    return clean_dir, noise_dir


# --- emotion-labelled corpus -------------------------------------------------

# Acoustic regime per MSP-Podcast emotion code (labels/parsing.py maps
# A/H/S/F/U/D/C/N → 0..7).  Regimes follow the standard prosody/voice-quality
# correlates (arousal ↔ f0 level + rate + roughness, valence ↔ formant
# tuning): the classes are genuinely separable from the waveform, so a
# classifier trained on this corpus measures real learning, not noise.
EMOTION_REGIMES = {
    # code: (f0_range, am_range, formant_scale, roughness, rise, (A, V, D))
    "A": ((200, 265), (6.0, 8.0), 1.15, 0.15, 0.00, (6.2, 2.0, 6.0)),
    "H": ((180, 240), (4.0, 6.0), 1.10, 0.03, 0.05, (5.5, 6.3, 5.0)),
    "S": ((90, 130), (1.5, 2.5), 0.90, 0.02, -0.08, (2.2, 2.4, 2.5)),
    "F": ((225, 285), (7.0, 9.0), 1.05, 0.08, 0.10, (6.0, 2.3, 2.0)),
    "U": ((150, 230), (3.0, 5.0), 1.00, 0.03, 0.30, (5.0, 4.5, 3.5)),
    "D": ((100, 150), (2.0, 3.5), 0.85, 0.12, -0.05, (3.5, 1.8, 4.5)),
    "C": ((120, 170), (2.0, 4.0), 0.95, 0.06, -0.03, (3.0, 2.2, 5.5)),
    "N": ((125, 185), (3.0, 4.5), 1.00, 0.02, 0.00, (3.3, 4.0, 4.0)),
}


def generate_emotion_corpus(root: str, n_train: int, n_dev: int,
                            seconds: float = 5.0, sample_rate: int = 16000,
                            seed: int = 0, verbose: bool = True):
    """Write ``Audios/*.wav`` + ``labels_consensus.csv`` under ``root`` in
    the MSP-Podcast v1.11 schema the emotion pipeline consumes
    (``data/emotion_dataset.py``: FileName, EmoClass, EmoAct, EmoVal,
    EmoDom, Split_Set, SpkrID, Gender).  Idempotent via a ``.complete``
    marker.  Returns (audio_dir, labels_csv)."""
    from nrse_tpu_torch.audio.io import save_wav

    audio_dir = os.path.join(root, "Audios")
    csv_path = os.path.join(root, "labels_consensus.csv")
    marker = os.path.join(root, ".complete")
    if os.path.exists(marker):
        return audio_dir, csv_path
    os.makedirs(audio_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    codes = list(EMOTION_REGIMES)
    rows = ["FileName,EmoClass,EmoAct,EmoVal,EmoDom,Split_Set,SpkrID,Gender"]
    t0 = time.perf_counter()
    for split, count in (("Train", n_train), ("Development", n_dev)):
        for i in range(count):
            code = codes[int(rng.integers(len(codes)))]
            f0r, amr, fsc, rough, rise, (a, v, d) = EMOTION_REGIMES[code]
            dur = seconds * float(rng.uniform(0.85, 1.15))
            x = synth_speech_like(
                rng, dur, sample_rate, f0_range=f0r, am_range=amr,
                formant_scale=fsc, roughness=rough, pitch_rise=rise,
            )
            name = f"MSP-SYN_{split[:2]}_{i:05d}.wav"
            save_wav(os.path.join(audio_dir, name), x, sample_rate)
            jitter = rng.normal(0.0, 0.25, 3)
            rows.append(
                f"{name},{code},{a + jitter[0]:.2f},{v + jitter[1]:.2f},"
                f"{d + jitter[2]:.2f},{split},S{int(rng.integers(40)):03d},"
                f"{'Male' if rng.integers(2) else 'Female'}"
            )
            if verbose and (i + 1) % 1000 == 0:
                print(f"# emotion corpus: {split} {i + 1}/{count} "
                      f"({time.perf_counter() - t0:.0f}s)", flush=True)
    with open(csv_path, "w") as f:
        f.write("\n".join(rows) + "\n")
    with open(marker, "w") as f:
        f.write(f"{n_train} {n_dev} {seconds}\n")
    if verbose:
        print(f"# emotion corpus: {n_train}+{n_dev} files in "
              f"{time.perf_counter() - t0:.0f}s at {root}", flush=True)
    return audio_dir, csv_path
