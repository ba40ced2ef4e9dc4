"""Named logger with separate file/console levels.

The port's copy of ``nrse_tpu/utils/logging_utils.py`` (parity with the
reference's ``src/utils/logging_utils.py:5,7,18``): a module-global logger
named ``nrse`` with a timestamped file handler and a console handler, each
with an independently configurable level taken from the ``logging`` config
block.
"""

from __future__ import annotations

import logging
import os
from datetime import datetime
from typing import Any, Dict, Optional

logger = logging.getLogger("nrse")
logger.setLevel(logging.DEBUG)
if not logger.handlers:
    # Until setup_logger runs, keep a quiet console handler so library use
    # (tests, imports) doesn't spam stderr.
    _h = logging.StreamHandler()
    _h.setLevel(logging.ERROR)
    logger.addHandler(_h)


def get_log_level(level_name: str) -> int:
    """Map a level name from config to a logging level constant."""
    return getattr(logging, str(level_name).upper(), logging.INFO)


def setup_logger(config: Optional[Dict[str, Any]] = None) -> logging.Logger:
    """Configure the ``nrse`` logger from the ``logging`` config block.

    Adds a timestamped file handler under ``training.log_dir`` (created if
    missing) and a console handler; levels come from ``logging.level`` and
    ``logging.console_level`` respectively.
    """
    config = config or {}
    log_cfg = config.get("logging", {})
    file_level = get_log_level(log_cfg.get("level", "INFO"))
    console_level = get_log_level(log_cfg.get("console_level", "ERROR"))

    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()

    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
    )

    console = logging.StreamHandler()
    console.setLevel(console_level)
    console.setFormatter(fmt)
    logger.addHandler(console)

    log_dir = config.get("training", {}).get("log_dir")
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        fh = logging.FileHandler(os.path.join(log_dir, f"nrse_{stamp}.log"))
        fh.setLevel(file_level)
        fh.setFormatter(fmt)
        logger.addHandler(fh)

    logger.setLevel(min(file_level, console_level))
    return logger
