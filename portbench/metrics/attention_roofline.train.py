"""The least time of the attention work the traced window ran (``yardstick.
attention_least`` at the step's frame count: kernel A and K3 up to 384
frames, K5 and its backward above, times the layers run) over the device
time of the attention kernels' groups, in %."""

from portbench import yardstick


def read(obs):
    spent = sum(obs.get("groups", {}).get(g, 0.0)
                for g in yardstick.ATTENTION)
    if not spent or not obs.get("attention_least_s"):
        return None
    return 100.0 * obs["attention_least_s"] / spent
