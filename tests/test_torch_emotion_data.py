"""The port's emotion data path and offline scorer against the JAX
package's, bit for bit, on ``conftest.py``'s mock MSP-Podcast corpus.

  1. ``EmotionDataset`` (``nrse_tpu_torch/data/emotion_dataset.py``, the
     CSV through the ``csv`` module) against JAX's (pandas): the rows kept
     per split and their fields (the speaker id as the CSV's text, the
     ratings within a float64 ulp: pandas' parser is not correctly
     rounded), with
     ``categorical_only`` true and false, the class counts,
     and every item drawn with the same ``np.random.Generator`` — the crop,
     the noise file, its crop, the SNR, the mask — equal, with and without
     noise, at 1 s (the mock clips of 0.4–1.4 s padded or cropped, the
     noise whole) and 0.5 s (the noise cropped too).
  2. ``create_emotion_dataloaders``: both loaders' batches over two epochs
     equal JAX's, ``__count__`` and the validation loader's padding
     included.
  3. ``metrics.categorical_metrics.score_predictions`` (``csv`` and numpy)
     against JAX's (pandas and scikit-learn) on the same CSVs: the metrics
     within 1e-12, ``class_report.csv`` and ``class_distribution.csv``
     with the same rows and numbers, ``metrics.txt``.
"""

import copy
import csv

import numpy as np
import pytest

from nrse_tpu.data import emotion_dataset as jax_data
from nrse_tpu.metrics import categorical_metrics as jax_metrics
from nrse_tpu_torch.data import emotion_dataset as data
from nrse_tpu_torch.labels.parsing import (
    EMOTIONS_MAP,
    VALID_EMOTIONS_MAP,
    clean_filename,
)
from nrse_tpu_torch.metrics import categorical_metrics as metrics


def _config(mock_msp_dir, clip_s, add_noise, categorical_only):
    return {
        "training": {"batch_size": 4, "num_workers": 2, "seed": 11},
        "data": {"noise_data_path": str(mock_msp_dir / "noise"),
                 "sample_rate": 16000, "max_audio_length": clip_s,
                 "snr_range": [0, 5, 10]},
        "emotion": {"labels_file": str(mock_msp_dir / "labels_consensus.csv"),
                    "audio_dir": str(mock_msp_dir / "Audios"),
                    "train_dataset_split": "Development",
                    "validataion_dataset_split": "Test1", "batch_size": 4,
                    "add_noise_during_training": add_noise,
                    "categorical_only": categorical_only},
    }


def test_emotion_maps_match_jax():
    from nrse_tpu.labels import parsing as jax_parsing

    assert VALID_EMOTIONS_MAP == jax_parsing.VALID_EMOTIONS_MAP
    assert EMOTIONS_MAP == jax_parsing.EMOTIONS_MAP
    for name in ("MSP-PODCAST_0133_0459_snr2_IPb6u22cLIo.wav",
                 "a/b/MSP-PODCAST_0001_0002.wav", "x_snr10.wav"):
        assert clean_filename(name) == jax_parsing.clean_filename(name)


@pytest.mark.parametrize("clip_s", [1.0, 0.5])
@pytest.mark.parametrize("add_noise", [False, True])
@pytest.mark.parametrize("categorical_only", [True, False])
def test_dataset_items_match_jax(mock_msp_dir, clip_s, add_noise,
                                 categorical_only):
    for split in ("Development", "Test1"):
        kw = dict(labels_file=str(mock_msp_dir / "labels_consensus.csv"),
                  audio_dir=str(mock_msp_dir / "Audios"),
                  noise_dir=str(mock_msp_dir / "noise"), split=split,
                  max_audio_length=clip_s, add_noise=add_noise,
                  snr_range=[0, 5, 10], categorical_only=categorical_only)
        ours, theirs = data.EmotionDataset(**kw), jax_data.EmotionDataset(**kw)
        assert len(ours) == len(theirs) > 0
        # the speaker id stays the CSV's text (pandas reads a number); the
        # ratings are float() of the text, correctly rounded, where pandas'
        # parser may be one float64 ulp off
        ratings = ("arousal", "valence", "dominance")
        for r, q in zip(ours.samples, theirs.samples):
            assert r.keys() == q.keys()
            assert r["speaker_id"] == str(q["speaker_id"])
            for key in r.keys() - {"speaker_id", *ratings}:
                assert r[key] == q[key], key
            np.testing.assert_allclose([r[k] for k in ratings],
                                       [q[k] for k in ratings], rtol=4e-16)
        assert dict(ours.class_counts()) == dict(theirs.class_counts())
        for i in range(len(ours)):
            a = ours.sample(i, np.random.default_rng((3, i)))
            b = theirs.sample(i, np.random.default_rng((3, i)))
            assert a.keys() == b.keys()
            for key in a:
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key], key)
    if not categorical_only:  # the X row of the Development split kept
        dev = data.EmotionDataset(**{**kw, "split": "Development"})
        assert 8 in dev.class_counts()


@pytest.mark.parametrize("add_noise", [False, True])
def test_loaders_match_jax(mock_msp_dir, add_noise):
    config = _config(mock_msp_dir, 1.0, add_noise, True)
    ours = data.create_emotion_dataloaders(copy.deepcopy(config))
    theirs = jax_data.create_emotion_dataloaders(copy.deepcopy(config))
    for lo, lt in zip(ours, theirs):
        assert len(lo) == len(lt) > 0
        for _ in range(2):  # two epochs: the shuffle moves on
            bo, bt = list(lo), list(lt)
            assert len(bo) == len(bt)
            for x, y in zip(bo, bt):
                assert x.keys() == y.keys()
                assert "__count__" in x
                for key in x:
                    np.testing.assert_array_equal(x[key], y[key], key)
    # the validation split (5 rows) pads its last batch of 4
    counts = [int(b["__count__"]) for b in ours[1]]
    assert counts == [4, 1]


@pytest.fixture()
def predictions(mock_msp_dir, tmp_path):
    """A predictions CSV over the mock corpus: augmented names, letter
    codes, class names and indices, an unknown file and an invalid
    prediction."""
    with open(mock_msp_dir / "labels_consensus.csv", newline="") as f:
        names = [r["FileName"] for r in csv.DictReader(f)]
    values = ["A", "happiness", "2", "N", "7.0", "Sadness", "H", "x",
              "A", "N", "3", "neutral"]
    rows = []
    for i, (name, v) in enumerate(zip(names, values)):
        if i % 3 == 0:
            name = name.replace(".wav", f"_snr{i}_noiseclip.wav")
        rows.append([name, v])
    rows.append(["MSP-PODCAST_9999_0000.wav", "A"])
    path = tmp_path / "preds.csv"
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["FileName", "prediction"])
        writer.writerows(rows)
    return path


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("split", [None, "Test1"])
def test_score_predictions_matches_jax(mock_msp_dir, predictions, tmp_path,
                                       split):
    gt = str(mock_msp_dir / "labels_consensus.csv")
    ours = metrics.score_predictions(str(predictions), gt,
                                     str(tmp_path / "ours"), split)
    theirs = jax_metrics.score_predictions(str(predictions), gt,
                                           str(tmp_path / "theirs"), split)
    assert ours.keys() == theirs.keys()
    assert ours["n_scored"] == theirs["n_scored"] > 0
    for key in ("accuracy", "macro_f1", "weighted_f1"):
        assert abs(ours[key] - theirs[key]) <= 1e-12, key
    for name in ("class_report.csv", "class_distribution.csv"):
        a = _csv_rows(tmp_path / "ours" / name)
        b = _csv_rows(tmp_path / "theirs" / name)
        assert len(a) == len(b) and a[0] == b[0], name
        for ra, rb in zip(a[1:], b[1:]):
            assert ra[0] == rb[0]
            np.testing.assert_allclose([float(v) for v in ra[1:]],
                                       [float(v) for v in rb[1:]],
                                       rtol=1e-12, err_msg=name)
    assert (tmp_path / "ours" / "metrics.txt").read_text() == \
        (tmp_path / "theirs" / "metrics.txt").read_text()
    assert (tmp_path / "ours" / "confusion_matrix.png").exists()


def test_score_predictions_needs_columns_and_overlap(mock_msp_dir, tmp_path):
    gt = str(mock_msp_dir / "labels_consensus.csv")
    bad = tmp_path / "bad.csv"
    bad.write_text("name,label\nx.wav,A\n")
    with pytest.raises(ValueError, match="filename column"):
        metrics.score_predictions(str(bad), gt, str(tmp_path / "o"))
    none = tmp_path / "none.csv"
    none.write_text("FileName,prediction\nnope.wav,A\n")
    with pytest.raises(ValueError, match="no overlapping"):
        metrics.score_predictions(str(none), gt, str(tmp_path / "o"))
