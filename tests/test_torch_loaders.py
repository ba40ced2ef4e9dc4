"""The port's data loaders against JAX's, batch for batch over two epochs.

Each side's loaders are built the way its entry point builds them, from
one config, corpus and seed, and read for two epochs: the train loader
(shuffled anew each epoch, the ragged last batch dropped) and the
validation loader (in order, the last batch padded, ``__count__`` its
real rows).  Every array of every batch must be equal bit for bit: the
clean crops, the noise (the file chosen and its offset), the SNRs, the
masks and labels, ``__count__`` and the padding.  JAX's datasets are
given the port's sorted listing (``torch_entry.sorted_listing``): JAX's
own is the filesystem's order.

  * BYOL: ``data.loader.create_dataloaders`` against
    ``nrse_tpu.data.noisy_speech_dataset.create_dataloaders`` on a
    synthetic corpus of clips longer and shorter than the crop;
  * the SER trainers: ``data.emotion_dataset.create_emotion_dataloaders``
    on ``conftest.py``'s mock MSP-Podcast corpus, noise on;
  * the fine-tune: the corpus statistics, then ``BaselineWavDataset`` in
    ``HostDataLoader`` as both ``train_ft_cat_ser.train`` build them, on
    the tiny corpus of ``tests/test_baseline_e2e.py`` (1 s crops of
    0.5-1.5 s clips).
"""

import json

import numpy as np
import pandas as pd
import pytest
import torch

from nrse_tpu.audio.io import save_wav
from nrse_tpu.baseline import train_ft_cat_ser as jax_ft
from nrse_tpu.baseline.wavset import WavNormStats as JaxWavNormStats
from nrse_tpu.data import loader as jax_loader
from nrse_tpu.data.emotion_dataset import (
    create_emotion_dataloaders as jax_emotion_loaders,
)
from nrse_tpu.data.noisy_speech_dataset import (
    create_dataloaders as jax_byol_loaders,
)
from nrse_tpu.labels.parsing import BASELINE_EMOTIONS_MAP
from nrse_tpu_torch.baseline import train_ft_cat_ser as port_ft
from nrse_tpu_torch.data import loader as port_loader
from nrse_tpu_torch.data.emotion_dataset import (
    create_emotion_dataloaders as port_emotion_loaders,
)
from nrse_tpu_torch.data.loader import create_dataloaders as port_byol_loaders
from nrse_tpu_torch.data.synthetic import generate_corpus
from torch_entry import sorted_listing

torch.set_num_threads(1)

EPOCHS = 2
SR = 16000


@pytest.fixture(autouse=True)
def jax_lists_sorted(monkeypatch):
    """JAX's datasets list their audio sorted, as the port's do
    (``torch_entry.sorted_listing``)."""
    sorted_listing(monkeypatch)


def _epochs(loaders):
    """Two epochs of each loader: ``[[batch, ...] per epoch] per loader``
    (the train loader reshuffles on each pass)."""
    return [[list(loader) for _ in range(EPOCHS)] for loader in loaders]


def _same(jax_side, port_side):
    """Every batch of every epoch of every loader equal bit for bit;
    returns the number of batches."""
    n = 0
    for j_loader, p_loader in zip(jax_side, port_side):
        assert len(j_loader) == len(p_loader) == EPOCHS
        for j_epoch, p_epoch in zip(j_loader, p_loader):
            assert len(j_epoch) == len(p_epoch) > 0
            for j, p in zip(j_epoch, p_epoch):
                assert set(j) == set(p)
                for key in j:
                    a, b = np.asarray(j[key]), np.asarray(p[key])
                    assert a.dtype == b.dtype and a.shape == b.shape, key
                    assert np.array_equal(a, b), key
                n += 1
    return n


def test_byol_loaders_give_jax_batches(tmp_path):
    clean, noise = generate_corpus(str(tmp_path), 13, 3, seconds=0.5,
                                   duration_jitter=0.3, seed=4,
                                   verbose=False)
    config = {"training": {"batch_size": 4, "num_workers": 2, "seed": 11},
              "data": {"clean_data_path": clean, "noise_data_path": noise,
                       "sample_rate": SR, "max_audio_length": 0.3,
                       "snr_range": [0, 5, 10, 20],
                       "validation_ratio": 0.25}}
    jax_side = _epochs(jax_byol_loaders(config))
    port_side = _epochs(port_byol_loaders(config))
    assert _same(jax_side, port_side) == 2 * (2 + 1)
    train, val = port_side
    assert train[0][0]["clean"].shape == (4, int(0.3 * SR))
    assert val[0][-1]["__count__"] == 3  # 3 held out, the last row padding
    # the train loader reshuffles: another order in the second epoch
    assert not np.array_equal(train[0][0]["clean"], train[1][0]["clean"])
    assert set(np.concatenate([b["snr"] for b in train[0]])) <= {
        0.0, 5.0, 10.0, 20.0}


def test_emotion_loaders_give_jax_batches(mock_msp_dir, tmp_path):
    config = {"training": {"num_workers": 2, "seed": 42},
              "data": {"noise_data_path": str(mock_msp_dir / "noise"),
                       "sample_rate": SR, "max_audio_length": 0.48,
                       "snr_range": [5, 10]},
              "emotion": {
                  "labels_file": str(mock_msp_dir / "labels_consensus.csv"),
                  "audio_dir": str(mock_msp_dir / "Audios"),
                  "train_dataset_split": "Development",
                  "validataion_dataset_split": "Test1",
                  "batch_size": 4, "add_noise_during_training": True,
                  "categorical_only": True}}
    jax_side = _epochs(jax_emotion_loaders(config))
    port_side = _epochs(port_emotion_loaders(config))
    assert _same(jax_side, port_side) == 2 * (1 + 2)
    assert port_side[1][0][-1]["__count__"] == 1  # 5 held out, batch 4


@pytest.fixture(scope="module")
def ft_corpus(tmp_path_factory):
    """``tests/test_baseline_e2e.py``'s corpus: 16 clips of 0.5-1.5 s,
    ten ``Train`` and six ``Development``, a one-hot label CSV."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("ft_loaders")
    wav_dir = root / "Audios"
    wav_dir.mkdir()
    rows = []
    for i, c in enumerate(["A", "S", "H", "N"] * 4):
        name = f"MSP-PODCAST_{3000 + i}_{i:04d}.wav"
        t = np.arange(int(SR * rng.uniform(0.5, 1.5))) / SR
        x = 0.4 * np.sin(2 * np.pi * rng.uniform(90, 350) * t)
        x += 0.05 * rng.standard_normal(t.shape)
        save_wav(str(wav_dir / name), x.astype(np.float32), SR)
        one_hot = {k: 0.0 for k in BASELINE_EMOTIONS_MAP}
        one_hot[c] = 1.0
        rows.append({"FileName": name, **one_hot,
                     "Split_Set": "Train" if i < 10 else "Development"})
    pd.DataFrame(rows).to_csv(root / "labels_onehot.csv", index=False)
    (root / "config.json").write_text(json.dumps({
        "wav_dir": str(wav_dir),
        "label_path": str(root / "labels_onehot.csv")}))
    return root


def _ft_loaders(ft, loader_mod, stats, wav_dir, labels, seed, batch):
    """The train and dev loaders as ``train_ft_cat_ser.train`` builds them
    (``nrse_tpu/baseline/train_ft_cat_ser.py:172-181``)."""
    out = []
    for split, shuffle in (("Train", True), ("Development", False)):
        files, onehot = ft.load_onehot_labels(labels, split)
        ds = ft.BaselineWavDataset(wav_dir, files, onehot, stats, 1.0)
        out.append(loader_mod.HostDataLoader(
            ds, np.arange(len(ds)), batch, shuffle=shuffle, seed=seed,
            num_workers=2, drop_last=shuffle))
    return out


def test_fine_tune_loaders_give_jax_batches(ft_corpus):
    seed, wav_dir = 7, str(ft_corpus / "Audios")
    labels = str(ft_corpus / "labels_onehot.csv")
    files, _ = jax_ft.load_onehot_labels(labels, "Train")
    rng = np.random.default_rng(seed)  # train_ft_cat_ser.py:143-150
    jax_stats = JaxWavNormStats.from_waveforms(
        w[0] for w in (jax_ft._load_wav(f"{wav_dir}/{f}", 10**9, rng)
                       for f in files) if w is not None)
    port_stats = port_ft.corpus_norm_stats(wav_dir, files, seed)
    assert (port_stats.mean, port_stats.std) == (jax_stats.mean,
                                                 jax_stats.std)
    jax_side = _epochs(_ft_loaders(jax_ft, jax_loader, jax_stats, wav_dir,
                                   labels, seed, 4))
    port_side = _epochs(_ft_loaders(port_ft, port_loader, port_stats,
                                    wav_dir, labels, seed, 4))
    assert _same(jax_side, port_side) == 2 * (2 + 2)
    train, dev = port_side
    assert dev[0][-1]["__count__"] == 2  # 6 dev clips, batch 4
    # clips longer than 1 s are cropped at a drawn offset: another crop in
    # the second epoch
    assert not all(np.array_equal(a["input_values"], b["input_values"])
                   for a, b in zip(train[0], train[1]))
