"""Milliseconds in which a kernel ran on the card, a traced pass of the
evaluator (the union of the kernels' intervals over the traced window,
over its passes): the device's share of a pass, without the host's."""


def read(obs):
    if not obs.get("busy_s") or not obs.get("passes"):
        return None
    return obs["busy_s"] / obs["passes"] * 1e3
