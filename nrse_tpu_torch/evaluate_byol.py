"""The BYOL evaluation API at the package's top level, as the root
``evaluate_byol.py`` re-exports the JAX package's (the reference has
``evaluate_byol.py`` at its root); the implementation lives in
``nrse_tpu_torch/eval/evaluate_byol.py``."""

from nrse_tpu_torch.eval.evaluate_byol import (  # noqa: F401
    evaluate_embedding_similarity,
    validate_model,
    visualize_embeddings,
)
