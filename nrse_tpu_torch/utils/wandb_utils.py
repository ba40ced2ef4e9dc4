"""wandb-or-stub experiment logging.

The port's copy of ``nrse_tpu/utils/wandb_utils.py:18-87``.  The reference
logs scalars and images to wandb projects (``train_byol.py:131,173-185``;
modes online/offline/disabled from the config).  ``get_wandb`` returns the
real module where it imports and a mode asks for it, and otherwise a stub
with the same calls (``init/log/finish/Image``) that appends the logged
records to a JSONL file (nothing with mode ``disabled``), so the trainers
never branch.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class _StubImage:
    def __init__(self, path):
        self.path = str(path)


class _StubRun:
    def __init__(self, project, config, mode, log_dir):
        self.project = project
        self.config = config
        self.mode = mode
        self.dir = log_dir or "outputs"
        os.makedirs(self.dir, exist_ok=True)
        self._f = None
        if mode != "disabled":
            self._f = open(
                os.path.join(self.dir, f"wandb_stub_{int(time.time())}.jsonl"),
                "a",
            )

    def log(self, data: Dict[str, Any]):
        if self._f is None:
            return
        rec = {
            k: (v.path if isinstance(v, _StubImage) else v)
            for k, v in data.items()
        }
        rec["_t"] = time.time()
        self._f.write(json.dumps(rec, default=str) + "\n")
        self._f.flush()

    def finish(self):
        if self._f is not None:
            self._f.close()
            self._f = None


class _StubWandb:
    """Module-shaped stub: wandb.init/log/finish/Image/run."""

    Image = _StubImage

    def __init__(self):
        self.run = None

    def init(self, project: str = "nrse", config: Optional[Dict] = None,
             mode: str = "disabled", dir: Optional[str] = None, **kw):
        log_dir = dir or (config or {}).get("training", {}).get("log_dir")
        self.run = _StubRun(project, config, mode, log_dir)
        return self.run

    def log(self, data: Dict[str, Any]):
        if self.run is not None:
            self.run.log(data)

    def finish(self):
        if self.run is not None:
            self.run.finish()
            self.run = None


def get_wandb(mode: str = "disabled"):
    """Real wandb when importable and wanted; the JSONL stub otherwise."""
    if mode in ("online", "offline"):
        try:
            import wandb  # type: ignore

            return wandb
        except ImportError:
            pass
    return _StubWandb()
