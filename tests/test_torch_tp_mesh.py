"""The port's two-axis mesh (``nrse_tpu_torch.parallel.mesh``) against the
JAX package's ``nrse_tpu/parallel/mesh.py``.

  1. ``make_mesh`` at ``{data: 1, model: 2}`` (2 gloo ranks) and ``{data:
     2, model: 2}`` (4): each rank's coordinates are its device's place in
     JAX's mesh over as many devices (``np.asarray(devices).reshape(data,
     model)``), its data group holds the ranks of its model index and its
     model group the ranks of its data index (a sum of the ranks' indices
     over each).
  2. ``partition_rule`` against ``param_partition_spec`` for every
     parameter of the tiny BYOL state, online and target: each JAX leaf is
     tagged with its index along the axis the spec puts on ``model`` (and
     0 elsewhere), the tagged tree goes through the converter
     (``models.convert.byol_variables_to_state_dicts``: stacked ``[L, in,
     out]`` kernels become per-layer ``[out, in]`` weights), and the one
     dimension along which a port tensor varies must be the one
     ``partition_rule`` names (none for a replicated one).
  3. ``shard_state_dict`` then ``gather_state_dict`` on each rank gives
     the tiny BYOL state dict back bit for bit, and each shard has the
     shape the rule implies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrse_tpu.models.byol import BYOLSpeechModel
from nrse_tpu.models.wavlm import WavLMConfig as JaxConfig
from nrse_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nrse_tpu.parallel.mesh import param_partition_spec
from nrse_tpu_torch.models.convert import (
    byol_variables_to_state_dicts,
    init_byol_state_dict,
)
from nrse_tpu_torch.models.wavlm import WavLMConfig
from nrse_tpu_torch.parallel.launch import run_ranks
from nrse_tpu_torch.parallel.mesh import partition_rule

import torch_tp_workers as workers
from torch_init import with_random_biases

torch.set_num_threads(1)

MESHES = [(1, 2), (2, 2)]  # (data, model)


@pytest.fixture(scope="module", params=MESHES, ids=["1x2", "2x2"])
def layout(request):
    data, model = request.param
    return data, model, run_ranks(workers.mesh_layout, data * model, (model,))


def test_coordinates_follow_jax(layout):
    data, model, ranks = layout
    devices = jax.devices()[:data * model]
    jmesh = jax_make_mesh(data, model, devices)
    where = {d.id: tuple(int(i) for i in np.argwhere(jmesh.devices == d)[0])
             for d in devices}
    for r, out in enumerate(ranks):
        assert out["axes"] == (data, model)
        assert out["coords"] == where[devices[r].id]


def test_groups_hold_the_axes_ranks(layout):
    data, model, ranks = layout
    for r, out in enumerate(ranks):
        i, j = r // model, r % model
        same_model = sum(k * model + j for k in range(data))
        same_data = sum(i * model + k for k in range(model))
        assert out["sums"] == (same_model, same_data)


def test_shard_then_gather_is_bit_equal(layout):
    data, model, ranks = layout
    sd = with_random_biases(init_byol_state_dict(
        WavLMConfig.tiny(), workers.PROJ, workers.PRED,
        torch.Generator().manual_seed(0)), 0)
    for out in ranks:
        assert out["round_trip"]
        for k, v in sd.items():
            dim = partition_rule(k, v)
            want = list(v.shape)
            if dim is not None:
                want[dim] //= model
            assert out["shapes"][k] == tuple(want), k
    split = {k for k, v in sd.items() if partition_rule(k, v) is not None}
    layer = {k.split("layers.0.")[1] for k in split if "layers.0." in k}
    assert layer == {f"attention.{m}_proj.{p}" for m in "qkv"
                     for p in ("weight", "bias")} | {
        "attention.out_proj.weight",
        "feed_forward.intermediate_dense.weight",
        "feed_forward.intermediate_dense.bias",
        "feed_forward.output_dense.weight"}


def _tag(path, leaf):
    """``leaf`` replaced by 1 + its index along the axis the JAX spec
    shards over ``model`` (0 for a replicated leaf)."""
    out = np.zeros(np.shape(leaf), np.float32)
    for axis, name in enumerate(param_partition_spec(path, leaf)):
        if name == "model":
            shape = [1] * out.ndim
            shape[axis] = out.shape[axis]
            out = out + 1 + np.arange(out.shape[axis], dtype=np.float32) \
                .reshape(shape)
    return out


def _varying(x: np.ndarray):
    return [d for d in range(x.ndim)
            if x.shape[d] > 1 and np.any(np.diff(x, axis=d) != 0)]


def test_partition_rule_matches_jax():
    jcfg = JaxConfig.tiny()
    model = BYOLSpeechModel({"model": {"projection_dim": workers.PROJ,
                                       "prediction_dim": workers.PRED,
                                       "ema_decay": 0.997}},
                            encoder_config=jcfg)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((2, 3200)))
    tagged = jax.tree_util.tree_map_with_path(_tag, variables)
    online, target = byol_variables_to_state_dicts(tagged, WavLMConfig.tiny())
    port = init_byol_state_dict(WavLMConfig.tiny(), workers.PROJ,
                                workers.PRED, torch.Generator())
    assert set(online) == set(port)
    split = 0
    for sd in (online, target):
        for k, v in sd.items():
            dim = partition_rule(k, v)
            assert _varying(v) == ([] if dim is None else [dim]), k
            split += dim is not None
    # q, k, v (weight and bias), out_proj, the FFN's two weights and its
    # first bias, in each of the 2 layers of both towers
    assert split == 2 * 2 * 10


def _ser_batch(seed: int, b: int = 4) -> dict:
    rng = np.random.default_rng(seed)
    mask = np.ones((b, 3200), np.int32)
    mask[1, 2000:] = 0
    return {"input_values": (0.3 * rng.standard_normal((b, 3200))
                             ).astype(np.float32),
            "attention_mask": mask,
            "C": rng.integers(0, 8, b).astype(np.int64),
            **{k: rng.uniform(1, 7, b).astype(np.float32) for k in "AVD"}}


@pytest.mark.parametrize("layers", [[], [1]])
def test_ser_trainers_replicate_over_a_model_axis(layers):
    """The SER trainers run a model axis as JAX runs it, replicated
    (``nrse_tpu/train/emotion_trainer.py::make_batch_placer`` shards the
    batch over ``data`` and replicates the state): at ``{data: 1, model:
    2}`` each rank's two steps, with dropout, LayerDrop, SpecAugment and
    the trunks' dropout on, equal one process's on the same global batch
    bit for bit (the streams are the data coordinate's, the model index
    draws nothing of its own), and the step's replica check passes."""
    batches = [_ser_batch(40 + i) for i in range(2)]
    one = workers.ser_replicated_steps(0, 1, 1, batches, layers)
    outs = run_ranks(workers.ser_replicated_steps, 2, (2, batches, layers))
    for out in outs:
        assert out["layers_run"] == one["layers_run"]
        for k in ("params", "mu", "nu"):
            np.testing.assert_array_equal(out[k], one[k], k)
        for got, want in zip(out["losses"], one["losses"]):
            np.testing.assert_array_equal(got, want)
