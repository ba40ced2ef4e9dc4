"""Share of the traced window in which no kernel ran on the card (one
minus the union of the kernels' intervals over the window), in %."""


def read(obs):
    if not obs.get("window_s"):
        return None
    return 100.0 * (1.0 - obs["busy_s"] / obs["window_s"])
