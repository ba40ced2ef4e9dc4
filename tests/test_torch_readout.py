"""The BYOL validation readout: JAX's bf16 similarity against the mean.

JAX's eval step returns the per-sample clean↔noisy similarity in the
compute dtype (``BYOLSpeechModel.encode`` returns the pooled embedding
uncast), bf16 on the TPU, and ``validate_model`` takes numpy's mean of
that bf16 array (``nrse_tpu/eval/evaluate_byol.py:100``), whose
accumulator is bf16: past a few dozen rows each addition's rounding no
longer averages out.  The port casts to float32 and averages in float64.

  * JAX's ``validate_model`` at wavlm-tiny in bf16 on 190 validation clips
    of one SNR bin departs from the float64 mean of its own per-sample
    similarities by more than ``JAX_GAP_MIN``; and the port's emulation
    of that arithmetic (``utils.report_utils.bf16_numpy_mean``, the
    convergence report's ``_jax_bf16`` column) reads JAX's value bit for
    bit from the same per-sample values;
  * the port's ``validate_model`` on the same clips, from the same
    weights in float32, equals the float64 mean of its own per-sample
    similarities to 1e-9, and so does its loss.
"""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from nrse_tpu.data.noisy_speech_dataset import (
    create_dataloaders as jax_loaders,
)
from nrse_tpu.eval import evaluate_byol as jax_eval
from nrse_tpu.models.byol import BYOLSpeechModel
from nrse_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from nrse_tpu.train.byol_trainer import create_train_state as jax_state
from nrse_tpu.train.schedules import make_byol_optimizer
from nrse_tpu_torch.data.loader import create_dataloaders
from nrse_tpu_torch.data.synthetic import generate_corpus
from nrse_tpu_torch.eval import evaluate_byol
from nrse_tpu_torch.models.convert import byol_variables_to_state_dicts
from nrse_tpu_torch.models.wavlm import WavLMConfig
from nrse_tpu_torch.train.byol_trainer import create_train_state
from nrse_tpu_torch.utils.report_utils import bf16_numpy_mean

torch.set_num_threads(1)

SNR = 10
# JAX's bf16 reading against the float64 mean of its per-sample values:
# measured 0.0178 on this run (0.99609375 against 0.97833), the bound
# set from it
JAX_GAP_MIN = 0.01
PORT_TOL = 1e-9
PROJ, PRED = 16, 32


def readout_runs(root):
    """JAX's ``(per-sample similarities, SNRs, validate_model's metrics)``
    and the port's ``(its eval pass, loss, metrics)`` on one corpus."""
    clean, noise = generate_corpus(os.path.join(root, "corpus"), 200, 3,
                                   seconds=0.3, duration_jitter=0.0,
                                   seed=6, verbose=False)
    config = {"model": {"name": "wavlm-tiny", "projection_dim": PROJ,
                        "prediction_dim": PRED},
              "training": {"batch_size": 38, "num_workers": 2, "seed": 1},
              "data": {"clean_data_path": clean, "noise_data_path": noise,
                       "sample_rate": 16000, "max_audio_length": 0.3,
                       "snr_range": [SNR], "validation_ratio": 0.95}}
    model = BYOLSpeechModel(config,
                            encoder_config=JaxWavLMConfig.tiny(
                                dtype=jnp.bfloat16))
    state = jax_state(model, jax.random.PRNGKey(0), jnp.zeros((1, 4800)),
                      make_byol_optimizer(1e-4, total_steps=10))
    _, jax_val = jax_loaders(config)
    _, jsims, jsnrs, _ = jax_eval._run_eval_pass(model, state, jax_val)
    _, jmetrics = jax_eval.validate_model(model, state,
                                          jax_loaders(config)[1], config)

    online, _ = byol_variables_to_state_dicts(
        jax.tree.map(lambda x: np.asarray(x, np.float32), state.variables),
        WavLMConfig.tiny())
    pstate = create_train_state(
        WavLMConfig.tiny(), {k: torch.from_numpy(v) for k, v in
                             online.items()}, PROJ, PRED, "cpu")
    ploss, pmetrics = evaluate_byol.validate_model(
        pstate, create_dataloaders(config)[1], config)
    return (jsims, jsnrs, jmetrics), (ploss, pmetrics)


@pytest.fixture(scope="module")
def readouts(tmp_path_factory):
    return readout_runs(str(tmp_path_factory.mktemp("readout")))


def test_jax_bf16_readout_departs_from_the_mean(readouts):
    (sims, snrs, metrics), _ = readouts
    rows = sims[snrs == SNR]
    assert sims.dtype == ml_dtypes.bfloat16 and len(rows) >= 180
    reading = metrics["val_similarities"][SNR]
    mean = float(np.asarray(rows, np.float64).mean())
    assert abs(reading - mean) > JAX_GAP_MIN, (reading, mean)
    # the report column's emulation reads JAX's value from the same rows
    assert bf16_numpy_mean(np.asarray(rows, np.float32)) == reading


def test_port_readout_is_the_float64_mean(readouts):
    _, (loss, metrics) = readouts
    samples = metrics["val_samples"]
    losses, sims, snrs = (samples[k] for k in ("loss", "similarity", "snr"))
    assert sims.dtype == np.float32 and (snrs == SNR).sum() >= 180
    rows = np.asarray(sims[snrs == SNR], np.float64)
    assert abs(metrics["val_similarities"][SNR] - rows.sum() / len(rows)) \
        <= PORT_TOL
    want = np.asarray(losses, np.float64)
    assert abs(loss - want.sum() / len(want)) <= PORT_TOL
