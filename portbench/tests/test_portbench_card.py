"""One end-to-end run of a cell on a CUDA card, at its own size."""

import contextlib
import io
import json

import pytest
import torch

from portbench import run


@pytest.mark.card
def test_a_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", "byol-train-5s", "--seed", "12345",
                       "--seconds", "3", "--trace", "0"])
    assert rc == 0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
