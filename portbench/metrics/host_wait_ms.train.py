"""Mean host milliseconds a traced step waited in the loop's ``next()`` on
the prefetcher (the ``loader_wait`` span)."""


def read(obs):
    if obs.get("host_wait_s") is None or not obs.get("steps"):
        return None
    return obs["host_wait_s"] / obs["steps"] * 1e3
