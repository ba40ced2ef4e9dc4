"""The port's training entry points give the same bits whatever order the
filesystem lists the corpus in, and after an earlier stage in the same
process.

  * ``audio.io.get_audio_files`` returns its paths sorted, whatever order
    ``os.walk`` yields the files and directories in, and the same set of
    paths as JAX's ``get_audio_files`` (which keeps ``os.walk``'s order);
  * ``chip_smoke.py`` phase 23 at wavlm-tiny on the CPU (``smoke``),
    three processes spawned at once over one tiny synthetic corpus: (a)
    ``report_utils.run_byol`` (``train_byol.main``), then the random-init
    e2e leg (``report_utils.train_ser``, ``train_emotion.run``, both
    phases); (b) the leg alone, fresh (on the card over memory filled with
    0xFF; here the fill does not apply); (c) as (a) on copies of the clean
    and noise directories written in reverse order, ``os.walk`` yielding
    each directory's files reversed.  Each train step's loss, each stage's
    epoch records and its final state's checksum (every tensor a
    checkpoint holds, bit for bit) must be equal: the leg in (a), (b) and
    (c), BYOL in (a) and (c).
"""

import os
import random

import pytest
import torch

import chip_smoke
from nrse_tpu.audio import io as jax_io
from nrse_tpu_torch.audio import io

torch.set_num_threads(1)

FILES = ("b.wav", "a.WAV", "c.flac", "skip.txt", "sub/z.wav", "sub/y.mp3",
         "sub/deeper/x.wav", "a_dir/q.wav")


@pytest.fixture
def tree(tmp_path):
    for name in FILES:
        path = tmp_path / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(b"")
    return tmp_path


def _walk_in(order, monkeypatch):
    """``os.walk`` yielding each directory's subdirectories and files in
    ``order`` ("reversed" or "shuffled") of what the filesystem gives."""
    walk = os.walk
    rng = random.Random(3)

    def arrange(names):
        names = list(names)
        if order == "reversed":
            return names[::-1]
        rng.shuffle(names)
        return names

    def walked(top, *args, **kwargs):
        for root, dirs, files in walk(top, *args, **kwargs):
            dirs[:] = arrange(dirs)
            yield root, dirs, arrange(files)
    monkeypatch.setattr(os, "walk", walked)


@pytest.mark.parametrize("order", ["reversed", "shuffled"])
def test_get_audio_files_is_sorted_whatever_walk_yields(tree, order,
                                                         monkeypatch):
    want = sorted(str(tree / name) for name in FILES
                  if not name.endswith(".txt"))
    assert io.get_audio_files(str(tree)) == want
    _walk_in(order, monkeypatch)
    assert io.get_audio_files(str(tree)) == want


def test_get_audio_files_lists_what_jax_lists(tree):
    got = io.get_audio_files(str(tree))
    assert sorted(jax_io.get_audio_files(str(tree))) == got
    assert len(got) == 7


@pytest.fixture(scope="module")
def repeat_runs():
    """Phase 23's three runs at wavlm-tiny on the CPU, one torch thread
    each: ``{name: run}``."""
    got = chip_smoke.phase_entry_repeat(torch.device("cpu"), smoke=True,
                                        clips=(16, 4), noise=2)
    return {g["name"]: g for g in got}


def _losses(run, stage):
    return [s["loss"] for s in run["steps"] if s["stage"] == stage]


def test_leg_after_byol_is_the_fresh_leg(repeat_runs):
    a, b = repeat_runs["a"], repeat_runs["b"]
    assert "byol" in a["stages"] and "byol" not in b["stages"]
    assert len(_losses(a, "leg")) >= 4
    assert _losses(a, "leg") == _losses(b, "leg")
    assert a["stages"]["leg"] == b["stages"]["leg"]


def test_leg_and_byol_repeat_under_a_reversed_listing(repeat_runs):
    a, c = repeat_runs["a"], repeat_runs["c"]
    for stage in ("byol", "leg"):
        assert _losses(a, stage) and _losses(a, stage) == _losses(c, stage)
        assert a["stages"][stage] == c["stages"][stage], stage


def test_each_run_read_one_sorted_listing(repeat_runs):
    for d in ("clean", "noise"):
        c = repeat_runs["c"]["listing"][d]
        assert len(c["fs"]) >= 2
        assert c["walked"] == c["fs"][::-1]  # the reversed walk took effect
        for run in repeat_runs.values():
            listed = run["listing"][d]["listed"]
            assert listed == sorted(run["listing"][d]["fs"]) == sorted(
                c["fs"])


def test_checkpoint_digest_reads_the_state_not_the_file(tmp_path):
    """``report_utils.checkpoint_digest``: two saves of one state read
    alike; one bit, the step or the seed changed reads otherwise."""
    from nrse_tpu_torch.train import checkpoint
    from nrse_tpu_torch.utils.report_utils import checkpoint_digest

    tensors = {"params": torch.arange(6, dtype=torch.float32),
               "mu": torch.zeros(3, dtype=torch.bfloat16)}

    def digest(name, step=1, seed=2, **change):
        path = checkpoint._write(str(tmp_path), name, {
            "tensors": dict(tensors, **change), "step": step, "seed": seed},
            {"epoch": len(name)})
        return checkpoint_digest(path)

    first = digest("a")
    assert digest("b") == first
    bumped = tensors["params"].clone()
    bumped.view(torch.int32)[5] += 1
    assert len({first, digest("c", params=bumped), digest("d", step=3),
                digest("e", seed=4)}) == 4


def test_records_keep_what_a_rerun_must_repeat():
    from nrse_tpu_torch.utils.report_utils import records

    record = {"phase": "fine_tune", "epoch": 0, "train_loss": 1.5,
              "val_loss": 1.25, "f1": 0.5, "lr": 2e-5, "steps": 6,
              "layers": [0, 1], "s_per_step": 0.12,
              "audio_sec_per_sec": 400.0,
              "audio_sec_per_sec_per_chip": 400.0}
    assert records([record]) == [{k: record[k] for k in (
        "phase", "epoch", "train_loss", "val_loss", "f1", "lr",
        "steps")}]


def test_repeat_tool_compares_every_figure():
    """``tools/port_transfer_repeat.py``'s verdict: equal only where the
    readout, best, epoch records and checkpoint digest all are."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "port_transfer_repeat", os.path.join(
            os.path.dirname(chip_smoke.__file__), "tools",
            "port_transfer_repeat.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    run = {"readout": {"clean": {"macro_f1": 0.5}},
           "checks": {"best": 0.5, "epochs": [{"val_loss": 1.0}],
                      "digest": "ab", "steps": 6}}
    assert tool.same({"a": run, "b": run})
    for path, value in ((("readout", "clean"), {"macro_f1": 0.25}),
                        (("checks", "best"), 0.25),
                        (("checks", "epochs"), [{"val_loss": 2.0}]),
                        (("checks", "digest"), "cd")):
        other = {k: dict(v) for k, v in run.items()}
        other[path[0]][path[1]] = value
        assert not tool.same({"a": run, "b": other}), path
