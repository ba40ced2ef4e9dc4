"""Share of the samples the evaluator's traced forwards were given that
their masks mark as padding, in %."""


def read(obs):
    if not obs.get("computed_samples") or obs.get("mask_samples") is None:
        return None
    return 100.0 * (1.0 - obs["mask_samples"] / obs["computed_samples"])
