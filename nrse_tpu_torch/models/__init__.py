"""The WavLM encoder, the reference's ``WavLMEncoder`` API over it, and
the weight bridges."""

__all__ = ["WavLMEncoder"]


def __getattr__(name):
    # imported on first use: models.encoder reaches models.convert, which
    # imports modules that import models.wavlm, hence this package
    if name == "WavLMEncoder":
        from nrse_tpu_torch.models.encoder import WavLMEncoder
        return WavLMEncoder
    raise AttributeError(name)
