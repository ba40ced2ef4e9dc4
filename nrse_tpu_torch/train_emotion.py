"""Emotion training on one GPU or data-parallel over several: the
categorical and/or dimensional SER trainers per ``--task``.

    python -m nrse_tpu_torch.train_emotion --config <yaml or preset name> \
        --task categorical|dimensional|both [--device cuda|cpu]
    torchrun --nproc_per_node=N -m nrse_tpu_torch.train_emotion --config ...

Modelled on the root ``train_emotion.py:17-40``.  A preset name resolves
to the port's copies of the JAX presets (``nrse_tpu_torch/config/
presets/*emotion*.yaml``); the config goes through
``config.get_config`` (the same overrides: ``--batch_size``, ``--epochs``,
``--lr``).  Runs on the card unless ``--device cpu`` is given (float32 on
the plain paths).  With ``--task both`` each trainer writes its
checkpoints under its own subdirectory of ``emotion.checkpoint_dir``
(``categorical/``, ``dimensional/``): the JAX entry point gives both the
same directory, where the dimensional run's ``best_classifier_model``
and ``best_fine_tuned_model`` overwrite the categorical run's.  Under
torchrun (or with the ``tpu.distributed`` block) the ranks join one group
for both trainers (``train.categorical_emotions``: the ``tpu.mesh`` ``data
× model`` mesh, ``emotion.batch_size`` the global batch split over
``data``; ``model: 2`` or more replicates the classifier over each model
group's ranks, as the JAX trainers run it).  Over NCCL each rank's train
step runs from CUDA graphs as on one card, the mesh's sums inside them;
over gloo eagerly; ``emotion.cuda_graphs: false`` asks for the eager
step.
"""

from __future__ import annotations

import copy
import os
from typing import Dict

from nrse_tpu_torch.config.config_utils import get_config
from nrse_tpu_torch.parallel.distributed import (
    is_primary,
    leave,
    maybe_initialize,
)
from nrse_tpu_torch.train.categorical_emotions import (
    train_categorical_emotions,
)
from nrse_tpu_torch.train.dimentional_emotions import (
    train_dimensional_emotions,
)

TRAINERS = (("categorical", train_categorical_emotions),
            ("dimensional", train_dimensional_emotions))


def run(config: Dict) -> Dict:
    """Train what ``config["task"]`` (default ``both``) names; returns
    ``{task: the trainer's result}``.  Joins the group the config or
    torchrun's environment describes for both trainers, and leaves it at
    the end if it joined it here, on a raised path too
    (``parallel.distributed.leave``: every captured graph freed first)."""
    joined = maybe_initialize(config)
    try:
        return _run(config)
    finally:
        if joined:
            leave()


def _run(config: Dict) -> Dict:
    task = config.get("task", "both")
    primary = is_primary()
    results = {}
    for name, trainer in TRAINERS:
        if task not in (name, "both"):
            continue
        cfg = config
        if task == "both":
            cfg = copy.deepcopy(config)
            em = cfg["emotion"]
            em["checkpoint_dir"] = os.path.join(em["checkpoint_dir"], name)
        if primary:
            print(f"Training {name} emotion recognition model...",
                  flush=True)
        results[name] = trainer(cfg)
    if primary:
        print("Emotion training complete:",
              {k: {m: v for m, v in r.items() if m.startswith("best_")}
               for k, r in results.items()}, flush=True)
    return results


def main(argv=None) -> Dict:
    """The command line: :func:`config_utils.get_config`'s arguments."""
    return run(get_config(argv))


if __name__ == "__main__":
    main()
