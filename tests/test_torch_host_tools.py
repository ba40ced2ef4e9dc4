"""The port's host-side data, label and profiling tools against the JAX
package's, on the CPU.

  * ``data/synthetic.py`` and ``data/mock.py`` write the same WAV bytes
    and label CSV as JAX's for the same seed;
  * ``labels/tools.py``'s four sub-commands write the same files as
    JAX's (the filtered consensus CSV holds the same table: pandas writes
    its numbers back in its own format, the port keeps the row's text);
  * ``preprocess_audio_files`` and ``check_abnormal_values`` give the same
    verdicts; ``check_audio_tensor`` the same on tensors and arrays;
  * the demucs module's gating path (``separate=False``) writes JAX's
    bytes, and ``separate=True`` without demucs raises naming it;
  * ``ThroughputMeter`` and ``StepTimer`` read the same on one clock;
    ``profile_trace`` writes a Chrome trace, and nothing for a falsy dir;
  * ``visualize_embeddings`` writes a PNG; ``train_byol.main`` says once
    that the plot is skipped where matplotlib cannot be imported.
"""

import csv
import json
import os
import struct

import numpy as np
import pytest
import torch

from nrse_tpu.data import mock as jax_mock
from nrse_tpu.data import synthetic as jax_synthetic
from nrse_tpu.data.preprocess import demucs_speech_separation as jax_demucs
from nrse_tpu.labels import tools as jax_tools
from nrse_tpu.utils import debugging_utils as jax_debug
from nrse_tpu.utils import preprocess_audio_files as jax_pre
from nrse_tpu.utils import profiling as jax_profiling
from nrse_tpu_torch import train_byol
from nrse_tpu_torch.audio.io import save_wav
from nrse_tpu_torch.data import mock, synthetic
from nrse_tpu_torch.data.loader import create_dataloaders
from nrse_tpu_torch.data.preprocess import demucs_speech_separation as demucs
from nrse_tpu_torch.eval.evaluate_byol import visualize_embeddings
from nrse_tpu_torch.labels import tools
from nrse_tpu_torch.utils import debugging_utils, profiling
from nrse_tpu_torch.utils import preprocess_audio_files as pre
from tests.test_torch_train_byol import _config, _corpus

torch.set_num_threads(1)
SR = 16000


def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_synthetic_corpora_equal_jax(tmp_path):
    for lib, side in ((jax_synthetic, "jax"), (synthetic, "port")):
        lib.generate_corpus(str(tmp_path / side / "byol"), 3, 2,
                            seconds=0.25, seed=5, verbose=False)
        lib.generate_emotion_corpus(str(tmp_path / side / "emo"), 4, 2,
                                    seconds=0.25, seed=6, verbose=False)
    want, got = _tree_bytes(tmp_path / "jax"), _tree_bytes(tmp_path / "port")
    assert len(want) == 3 + 2 + 1 + 4 + 2 + 2  # WAVs, CSV, 2 markers
    assert got == want


def test_mock_data_equal_jax(tmp_path):
    for a, b in zip(jax_mock.create_mock_dataset(20, seed=2),
                    mock.create_mock_dataset(20, seed=2)):
        assert np.array_equal(a, b)
    jax_mock.create_mock_corpus(str(tmp_path / "jax"), 3, 2, max_seconds=0.5,
                                seed=4)
    mock.create_mock_corpus(str(tmp_path / "port"), 3, 2, max_seconds=0.5,
                            seed=4)
    want = _tree_bytes(tmp_path / "jax")
    assert len(want) == 5 and _tree_bytes(tmp_path / "port") == want


@pytest.fixture()
def label_inputs(tmp_path):
    lst = tmp_path / "list.txt"
    lst.write_text(
        "MSP-PODCAST_0001_0001.wav; A; A:4.2; V:3.0; D:5.5;\n"
        "MSP-PODCAST_0001_0002_snr5_abc.wav; X; A:3.0; V:3.1; D:2.2;\n"
        "sub/MSP-PODCAST_0002_0003_0004_snr10_q.wav; H; A:5.0; V:6.0; D:4;\n"
        "MSP-PODCAST_0003_0005.wav; O; A:1; V:2; D:3;\n"
        "bad line without fields\n"
        "MSP-PODCAST_0004_0006.wav; N; A:4; V:4; D:4;\n")
    consensus = tmp_path / "labels_consensus.csv"
    consensus.write_text(
        "FileName,EmoClass,EmoAct,EmoVal,EmoDom,Split_Set,SpkrID,Gender\n"
        "MSP-PODCAST_0001_0001.wav,A,4.2,3.0,5.5,Train,12,Male\n"
        "MSP-PODCAST_0001_0002.wav,X,3.0,3.1,2.2,Train,12,Male\n"
        "MSP-PODCAST_0002_0003_0004.wav,H,5.0,6.0,4.0,Development,7,Female\n"
        "MSP-PODCAST_0003_0005.wav,O,1.0,2.0,3.0,Test1,3,Male\n")
    log = tmp_path / "train.log"
    log.write_text("ok\nError loading audio file /x/MSP-PODCAST_0004_0006.wav:"
                   " truncated\nError loading audio file /y/other.wav: x\n")
    return tmp_path, lst, consensus, log


def _run_tools(main, root, lst, consensus, log, side):
    out = root / side
    out.mkdir()
    main(["process_txt", "--input", str(lst), "--output",
          str(out / "txt.txt")])
    main(["process_csv", "--input", str(consensus), "--output",
          str(out / "csv.csv")])
    main(["reformat", "--inputs", str(lst), str(out / "txt.txt"),
          "--consensus", str(consensus), "--output", str(out / "onehot.csv")])
    main(["reformat", "--inputs", str(lst), "--output",
          str(out / "onehot_nosplit.csv"), "--preserve_path"])
    main(["prune", "--list", str(lst), "--output", str(out / "pruned.txt"),
          "--logs", str(log), str(root / "missing.log")])
    return out


def _table(path):
    def cell(v):
        try:
            return float(v)
        except ValueError:
            return v
    with open(path, newline="") as f:
        return [[cell(v) for v in row] for row in csv.reader(f)]


def test_label_tools_write_what_jax_writes(label_inputs, capsys):
    root, lst, consensus, log = label_inputs
    want = _run_tools(jax_tools.main, root, lst, consensus, log, "jax")
    jax_said = capsys.readouterr().out
    got = _run_tools(tools.main, root, lst, consensus, log, "port")
    assert capsys.readouterr().out.replace("/port/", "/jax/") == jax_said
    for name in ("txt.txt", "onehot.csv", "onehot_nosplit.csv",
                 "pruned.txt"):
        assert (got / name).read_bytes() == (want / name).read_bytes(), name
    assert _table(got / "csv.csv") == _table(want / "csv.csv")
    assert len(_table(got / "csv.csv")) == 3  # the header and A, H


def test_audio_scan_verdicts_equal_jax(tmp_path):
    d = tmp_path / "corpus"
    (d / "sub").mkdir(parents=True)
    rng = np.random.default_rng(0)
    save_wav(str(d / "good.wav"), 0.3 * rng.standard_normal(SR // 2), SR)
    save_wav(str(d / "sub" / "short.wav"), 0.3 * np.ones(SR // 20), SR)
    save_wav(str(d / "silent.wav"), np.zeros(SR // 2), SR)
    data = np.full(SR // 4, 0.25, np.float32)
    data[100] = np.nan
    fmt = struct.pack("<HHIIHH", 3, 1, SR, 4 * SR, 4, 32)  # IEEE float
    (d / "nan.wav").write_bytes(
        b"RIFF" + struct.pack("<I", 36 + data.nbytes) + b"WAVEfmt "
        + struct.pack("<I", 16) + fmt + b"data"
        + struct.pack("<I", data.nbytes) + data.tobytes())
    (d / "garbage.wav").write_bytes(b"RIFF1234notawave")
    want = jax_pre.preprocess_audio_files(str(d))
    got = pre.preprocess_audio_files(str(d))
    assert sorted(got[0]) == sorted(want[0]) == [str(d / "good.wav")]
    assert got[1].keys() == want[1].keys() and len(got[1]) == 4
    for path, reason in want[1].items():
        assert got[1][path].split(":")[0] == reason.split(":")[0], path
    for x in (np.array([0.1, np.nan]), np.array([np.inf, 0.2]),
              np.zeros(4), np.array([0.5, -0.2])):
        assert pre.check_abnormal_values(x) == \
            jax_pre.check_abnormal_values(x)
        for arg in (x, torch.from_numpy(x)):
            assert debugging_utils.check_audio_tensor(arg) == \
                jax_debug.check_audio_tensor(x)
    assert debugging_utils.check_audio_tensor(
        torch.zeros(3), config={"logging": {"level": "INFO"}})


def test_demucs_gating_path_equals_jax(tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.default_rng(1)
    save_wav(str(src / "a.wav"), 0.2 * rng.standard_normal(SR // 4), SR)
    save_wav(str(src / "b.wav"),
             np.stack([0.3 * rng.standard_normal(22050 // 4),
                       0.004 * np.ones(22050 // 4)]), 22050)
    want = jax_demucs.process_folder(str(src), str(tmp_path / "jax"),
                                     separate=False)
    got = demucs.process_folder(str(src), str(tmp_path / "port"),
                                separate=False)
    assert [os.path.basename(p) for p in sorted(got)] == \
        [os.path.basename(p) for p in sorted(want)] == ["a.wav", "b.wav"]
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "jax")
    assert demucs.demucs_available() == jax_demucs.demucs_available()
    if not demucs.demucs_available():
        with pytest.raises(ImportError, match="demucs"):
            demucs.process_folder(str(src), str(tmp_path / "x"),
                                  separate=True)
        with pytest.raises(ImportError, match="demucs"):
            demucs.process_file(str(src / "a.wav"), str(tmp_path / "y.wav"),
                                separate=True)


class _Clock:
    def __init__(self, ticks):
        self.ticks = list(ticks)

    def __call__(self):
        return self.ticks.pop(0)


def test_meters_read_as_jax(monkeypatch):
    reads = []
    for lib in (jax_profiling, profiling):
        monkeypatch.setattr(lib.time, "perf_counter",
                            _Clock([10.0, 11.0, 11.5, 12.0, 12.0]))
        meter = lib.ThroughputMeter(n_chips=2)
        meter.update(8, 5.0)
        meter.update(8, 5.0)
        timer = lib.StepTimer(alpha=0.5)
        ticks = [timer.tick(), timer.tick(), timer.tick()]
        reads.append((meter.steps, meter.audio_sec_per_sec_per_chip,
                      ticks, timer.smoothed))
        monkeypatch.undo()
    assert reads[0] == reads[1]
    # 80 audio-seconds over 2 s on 2 chips; ticks 0.5 s apart
    assert reads[1][1:] == (20.0, [None, 0.5, 0.5], 0.5)


def test_profile_trace_writes_a_trace(tmp_path):
    with profiling.profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    (path,) = (tmp_path / "trace").iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    with profiling.profile_trace(None) as prof:
        pass
    assert prof is None


@pytest.fixture(scope="module")
def byol_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("byol_plot")
    clean, noise = _corpus(root)
    return root, clean, noise


def test_visualize_embeddings_writes_a_png(byol_run):
    pytest.importorskip("sklearn")
    pytest.importorskip("matplotlib")
    root, clean, noise = byol_run
    result = train_byol.main(_config(root, clean, noise, 1))
    (epoch,) = result["epochs"]
    assert epoch["tsne"] == str(root / "logs" / "tsne_embeddings_epoch_1.png")
    assert os.path.getsize(epoch["tsne"]) > 0
    assert epoch["step_time_s"] > 0 and epoch["audio_sec_per_sec_per_chip"] > 0
    config = train_byol.with_defaults(_config(root, clean, noise, 1))
    path = visualize_embeddings(result["state"], create_dataloaders(config)[1],
                                str(root / "plots"), "again.png",
                                num_samples=4)
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_train_byol_skips_the_plot_without_matplotlib(byol_run, monkeypatch,
                                                      capsys, tmp_path):
    root, clean, noise = byol_run
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    config = _config(tmp_path, clean, noise, 2)
    result = train_byol.main(config)
    out = capsys.readouterr().out
    assert out.count("t-SNE plot of the embeddings skipped") == 1
    assert "matplotlib" in out
    assert [e["tsne"] for e in result["epochs"]] == [None, None]
    assert not list((tmp_path / "logs").glob("*.png"))
