"""The port's data-parallel building blocks (``nrse_tpu_torch.parallel``)
against the JAX package's ``nrse_tpu/parallel`` and against one process.

  1. ``process_local_indices`` (the port's copy) equals JAX's for several
     corpus sizes, process counts and batches.
  2. Without a group the helpers are identities, as JAX's are in one
     process (``tests/test_distributed.py::test_single_process_helpers_
     are_identity``), and ``make_mesh`` gives one rank.
  3. ``make_mesh`` refuses a ``data`` other than the world size (a subset
     of the processes), ``model > 1`` (naming ROADMAP.md's tensor-parallel
     item) and a batch that does not divide over the ranks; none falls
     back.  ``shard_batch`` gives rank r rows ``[r·b, (r+1)·b)`` and its
     share of a padded batch's count.
  4. The differentiable reduction: over 2 gloo ranks, each rank's part
     ``x_r·S`` of the global loss ``S·S`` gets the one-process gradient of
     the summed loss at its rows; the heads' BatchNorm over the global
     batch gives one process's output, input and weight gradients and
     running statistics; each to 1e-6 of its largest value (float32 sums
     of two parts against one sum); ``replicas_agree`` tells equal bits
     from a difference of 1e-6.
"""

import numpy as np
import pytest
import torch

from nrse_tpu.parallel import distributed as jax_distributed
from nrse_tpu_torch.models.heads import BatchNorm
from nrse_tpu_torch.parallel import distributed
from nrse_tpu_torch.parallel.launch import run_ranks
from nrse_tpu_torch.parallel.mesh import DataMesh, make_mesh, shard_batch

import torch_dp_workers as workers

torch.set_num_threads(1)


@pytest.mark.parametrize("n,nproc,batch", [(103, 4, 8), (103, 4, None),
                                           (10, 3, 2), (7, 2, None),
                                           (64, 8, 4), (5, 8, None)])
def test_process_local_indices_match_jax(n, nproc, batch):
    for pid in range(nproc):
        np.testing.assert_array_equal(
            distributed.process_local_indices(n, batch, pid, nproc),
            jax_distributed.process_local_indices(n, batch, pid, nproc))


def test_single_process_helpers_are_identity():
    assert distributed.process_count() == 1
    assert distributed.process_index() == 0
    assert distributed.is_primary()
    m = distributed.aggregate_metrics({"loss": np.float32(1.5)})
    assert m == {"loss": 1.5}
    assert distributed.aggregate_sums({"a": 2, "b": 0.5}) == \
        {"a": 2.0, "b": 0.5}
    assert distributed.broadcast_scalar(3.0) == 3.0
    assert distributed.maybe_initialize({"device": "cpu"}) is False
    distributed.barrier()
    mesh = make_mesh(device="cpu")
    assert mesh == DataMesh(world=1, rank=0, device=torch.device("cpu"))
    x = torch.randn(3, 4, requires_grad=True)
    assert distributed.all_reduce_sum(x, mesh) is x
    assert distributed.all_reduce_sum(x, None) is x
    batch = {"x": np.arange(6), "__count__": np.int32(5)}
    out = shard_batch(mesh, batch)
    np.testing.assert_array_equal(out["x"], batch["x"])
    assert int(out["__count__"]) == 5


def test_make_mesh_refuses_alone():
    with pytest.raises(ValueError, match="subset"):
        make_mesh(data=2, device="cpu")
    with pytest.raises(ValueError, match="ROADMAP.md"):
        make_mesh(model=2, device="cpu")
    assert make_mesh(data=1, device="cpu").world == 1


def test_maybe_initialize_refuses_a_block_without_address(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(RuntimeError, match="coordinator_address"):
        distributed.maybe_initialize(
            {"device": "cpu", "tpu": {"distributed": {"enabled": True}}})


@pytest.fixture(scope="module")
def mesh_checks():
    return run_ranks(workers.mesh_checks, 2, (3,))


def test_make_mesh_refuses_in_a_group(mesh_checks):
    for rank, out in enumerate(mesh_checks):
        assert "subset" in out["subset"]
        assert "ROADMAP.md" in out["model"]
        assert "must be divisible" in out["batch"]
        assert out["mesh"] == (2, rank, "cpu", True)


def test_shard_batch_rows_and_counts(mesh_checks):
    x = np.arange(8 * 3).reshape(8, 3)
    np.testing.assert_array_equal(
        np.concatenate([out["rows"] for out in mesh_checks]), x)
    for c in range(9):
        counts = [out["counts"][c] for out in mesh_checks]
        assert sum(counts) == c
        assert counts == [min(c, 4), max(c - 4, 0)]


@pytest.fixture(scope="module")
def reductions():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 5)).astype(np.float32) * 2 + 1
    bn = BatchNorm(5)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 2, 5)))
        bn.bias.copy_(torch.from_numpy(rng.standard_normal(5)))
    state = {k: v.numpy().copy() for k, v in bn.state_dict().items()}
    return x, state, run_ranks(workers.reduction_gradients, 2, (x, state))


def test_reduction_gradient_is_the_summed_loss_gradient(reductions):
    x, _, outs = reductions
    xt = torch.from_numpy(x).requires_grad_()
    s = xt.sum(0)
    (xt * s).sum().backward()  # Σ_r x_r·S = S·S
    got = np.concatenate([o["grad"] for o in outs])
    want = xt.grad.numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_batch_norm_takes_global_statistics(reductions):
    x, state, outs = reductions
    bn = BatchNorm(x.shape[1])
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    (y * workers.bn_loss_weights(x.shape)).pow(2).sum().backward()

    def close(got, want):
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()

    close(np.concatenate([o["bn_out"] for o in outs]), y.detach().numpy())
    close(np.concatenate([o["bn_grad"] for o in outs]), xt.grad.numpy())
    close(sum(o["bn_weight_grad"] for o in outs), bn.weight.grad.numpy())
    for o in outs:
        close(o["bn_running"][0], bn.running_mean.numpy())
        close(o["bn_running"][1], bn.running_var.numpy())
    # the ranks' running statistics are bit-identical
    for a, b in zip(outs[0]["bn_running"], outs[1]["bn_running"]):
        np.testing.assert_array_equal(a, b)


def test_replicas_agree_tells_bits_apart(reductions):
    for o in reductions[2]:
        assert o["agree_same"] is True
        assert o["agree_other"] is False
