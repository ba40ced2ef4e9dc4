"""The train steps' captured parts under a mesh, on the CPU.

A train step on a card runs from per-part CUDA graphs
(``train.step_graphs.StepGraphs``) alone and, since the mesh's
collectives sit inside its parts, under an NCCL mesh too; a gloo mesh and
the CPU run the eager step.  Nothing is captured on the CPU, so these
tests run the parts eagerly in the order a replay runs them, over 2 gloo
ranks (``parallel.launch.run_ranks``), against the eager mesh step of a
twin state, which ``test_torch_dp_byol.py``, ``test_torch_tp_byol.py``
and ``test_torch_dp_emotion.py`` hold to the JAX package's step:

  1. BYOL (``byol_trainer.byol_step_graphs``: the heads' global BatchNorm
     statistics and ``byol_loss``'s global weight sum in ``head``, the
     tensor-parallel layers' collectives in their forwards and backwards,
     the target tower's included, the ``reduce`` part's gradient, loss
     and ``valid_fraction`` sums, the model group's norm in
     ``optimizer``) at ``{data: 2}`` and ``{data: 1, model: 2}``: three
     steps with dropout, LayerDrop (0.3, a layer dropped) and SpecAugment
     on; the warm-up puts the BatchNorm statistics back, then every part
     with the optimizer's, the layers the step's keep lists keep, gives
     the eager step's loss, grad_norm, valid_fraction, finite, gradients,
     params, mu, nu, target and statistics bit for bit on every rank, and
     the replicas agree.
  2. The SER step (``emotion_trainer.ser_step_graphs``: ``emotion_loss``
     over the mesh in ``head``, the per-segment and loss sums in
     ``reduce``) at both meshes, frozen and whole encoder, likewise; at
     ``{data: 1, model: 2}`` the data axis is one rank and there is no
     ``reduce`` part, and the replicas are checked after every step.
  3. ``parallel.mesh.capturable``: captured on a card alone or under an
     NCCL mesh, eager under a gloo mesh and on the CPU.
  4. ``step_graphs.check_keep_lists`` passes where every rank holds the
     same keep lists and raises, on every rank, where one differs.
  5. The SER step's graphs free with their state, without the cycle
     collector (the end of an NCCL group waits for every graph holding
     its collectives), and ``release`` frees them from a state kept, the
     step's key going with them.
  6. The entry points that join a group (``train_byol.main``,
     ``train_emotion.run``, ``train_emotion_task``) leave it on a raised
     path too, every holder of captured graphs released first while the
     group still stands, one that only the traceback keeps included
     (``parallel.distributed.leave``); a ``ProgramCache`` released
     captures its shapes anew.
"""

import gc
import weakref

import numpy as np
import pytest
import torch
import torch.distributed as dist

from nrse_tpu_torch import train_byol, train_emotion
from nrse_tpu_torch.models.convert import init_emotion_state_dict
from nrse_tpu_torch.models.emotion import EmotionClassifier
from nrse_tpu_torch.parallel.launch import free_port, run_ranks
from nrse_tpu_torch.parallel.mesh import DataMesh, capturable
from nrse_tpu_torch.runtime.graphs import ProgramCache, hold
from nrse_tpu_torch.train import categorical_emotions
from nrse_tpu_torch.train import emotion_trainer as et

import torch_mesh_graph_workers as workers
from torch_init import with_random_biases

torch.set_num_threads(1)

MESHES = [pytest.param(1, id="data2"), pytest.param(2, id="data1_model2")]


def _byol_batch(n=4, t=3200, seed=3):
    rng = np.random.default_rng(seed)
    ax = np.arange(t) / 16000.0
    clean = np.stack([np.sin(2 * np.pi * f * ax)
                      for f in (150, 400, 900, 1300)[:n]])
    clean = clean + 0.05 * rng.standard_normal((n, t))
    return {"clean": clean.astype(np.float32),
            "noise": (0.2 * rng.standard_normal((n, t))).astype(np.float32),
            "snr": np.asarray([2.0, 10.0, 20.0, 5.0][:n], np.float32)}


def _ser_batch(n=4, samples=3200, seed=1):
    rng = np.random.default_rng(seed)
    x = (0.3 * rng.standard_normal((n, samples))).astype(np.float32)
    mask = np.ones((n, samples), np.float32)
    x[0, samples // 2:], mask[0, samples // 2:] = 0.0, 0.0
    out = {"input_values": x, "attention_mask": mask,
           "C": rng.integers(0, 8, n).astype(np.int32)}
    for k in ("A", "V", "D"):
        out[k] = rng.uniform(1, 7, n).astype(np.float32)
    return out


@pytest.mark.parametrize("model", MESHES)
def test_byol_parts_give_the_eager_mesh_step(model):
    ranks = run_ranks(workers.byol_parts, 2, (model, _byol_batch()))
    for r in ranks:
        assert r["differ"] == [[]] * workers.STEPS, r["differ"]
        assert r["restored"] and r["agree"] and np.isfinite(r["loss"])
        assert all(r["dropped"]), r["dropped"]
    assert ranks[0]["loss"] == ranks[1]["loss"]


@pytest.mark.parametrize("model", MESHES)
def test_ser_parts_give_the_eager_mesh_step(model):
    ranks = run_ranks(workers.ser_parts, 2, (model, _ser_batch()))
    for r in ranks:
        for name, got in r.items():
            assert got["differ"] == [[]] * workers.STEPS, (name, got)
            assert got["dropped"] > 0, name
            assert got["reduced"] == [model == 1] * workers.STEPS, name


class _Mesh(DataMesh):
    """A mesh of two ranks that names its backend, without a group."""

    def __init__(self, backend, device):
        super().__init__(world=2, rank=0, device=torch.device(device),
                         distributed=True, backend=backend)


@pytest.mark.parametrize("mesh,device,want", [
    (None, "cuda", True),
    (_Mesh("nccl", "cuda:0"), "cuda:0", True),
    (_Mesh("gloo", "cuda:0"), "cuda:0", False),
    (_Mesh("gloo", "cpu"), "cpu", False),
    (None, "cpu", False),
    (DataMesh(world=1, rank=0, device=torch.device("cuda")), "cuda", True),
], ids=["alone_on_a_card", "nccl_mesh", "gloo_mesh_on_a_card", "gloo_cpu",
        "alone_on_the_cpu", "mesh_without_a_group"])
def test_form_predicate(mesh, device, want):
    assert capturable(mesh, device) is want


def test_keep_list_check_raises_where_ranks_differ():
    assert run_ranks(workers.keep_lists, 2, (False,)) == ["agree"] * 2
    said = run_ranks(workers.keep_lists, 2, (True,))
    assert all("keep lists differ" in s for s in said), said


def _ser_graphs():
    cfg = workers.config()
    model = EmotionClassifier(cfg, workers.HIDDEN, dropout=0.3)
    model.load_state_dict(with_random_biases(init_emotion_state_dict(
        cfg, torch.Generator().manual_seed(3), workers.HIDDEN), 3),
        strict=True)
    state = et.create_emotion_state(model, seed=11)
    batch = {k: torch.from_numpy(v) for k, v in _ser_batch().items()}
    segments = et.trainable_segments(state, [2, 3], 0.0)
    spec = et.adamw_spec(1e-4)
    inputs = et.step_inputs(state, batch)
    state.graphs = et.ser_step_graphs(
        state, "both", spec, segments, batch, None,
        inputs.stage(state, "both", spec), inputs, key=None)
    return state


def test_ser_step_graphs_free_with_their_state():
    state = _ser_graphs()
    refs = [weakref.ref(x) for x in (state, state.graphs)]
    gc.disable()  # freed by their counts alone: no cycle holds them
    try:
        del state
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()
    state = _ser_graphs()
    graphs, key = state.graphs, state.graphs.key
    assert graphs.release() == 0  # nothing is captured on the CPU
    assert not graphs.graphs and graphs.key != key  # the trainer recaptures


class _Holder:
    """A holder of captured graphs that notes in ``log`` whether the group
    stood when it was released."""

    def __init__(self, log: list):
        self.log = log

    def release(self) -> int:
        self.log.append(dist.is_initialized())
        return 0


ENTRIES = [
    pytest.param(train_byol, "_main", lambda c: train_byol.main(c),
                 id="train_byol_main"),
    pytest.param(train_emotion, "_run", lambda c: train_emotion.run(c),
                 id="train_emotion_run"),
    pytest.param(categorical_emotions, "_train_emotion_task",
                 lambda c: categorical_emotions.train_categorical_emotions(c),
                 id="train_categorical_emotions"),
]


@pytest.mark.parametrize("module,inner,entry", ENTRIES)
def test_entry_points_leave_their_group_on_a_raise(monkeypatch, module,
                                                   inner, entry):
    released = []

    def fails(*args):  # a capture failed mid-run: its frame holds graphs
        holder = _Holder(released)
        hold(holder)
        raise RuntimeError("capturing a step failed in part 'head'")

    monkeypatch.setattr(module, inner, fails)
    monkeypatch.setattr(train_byol, "with_defaults", lambda c: c)
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    assert not dist.is_initialized()
    try:
        with pytest.raises(RuntimeError, match="part 'head'"):
            entry({"device": "cpu"})
        assert not dist.is_initialized()
        assert released == [True]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_program_cache_released_captures_anew():
    cache = ProgramCache(lambda x: x * 2, "cpu",
                         inputs=((torch.float32, 0.0),))
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert torch.equal(cache(x), 2 * x)
    assert len(cache.programs) == 1
    assert cache.release() == 0 and not cache.programs
    assert torch.equal(cache(x + 1), 2 * (x + 1))
    assert len(cache.programs) == 1
