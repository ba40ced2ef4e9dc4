"""The benchmark's own tests: CPU tests at tiny sizes, and one test marked
``card`` that runs a cell on a CUDA card and skips without one."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    import torch

    torch.set_num_threads(2)  # several workers share the machine
    config.addinivalue_line(
        "markers", "card: runs on a CUDA card; skips, with the reason, "
        "where there is none")
