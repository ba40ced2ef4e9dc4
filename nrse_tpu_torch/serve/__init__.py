"""Serving: the embedder's and the SER classifier's artifacts, and the
bucketed server."""

from nrse_tpu_torch.serve.export import (  # noqa: F401
    ServingModel,
    export_classifier,
    export_embedder,
    load_serving_model,
)
