"""The least time of the FFN work the traced window ran (``yardstick.
ffn_least`` at the shapes kernel B and K2 were handed, times the layers
run) over the device time of the FFN kernels' group, in %."""

from portbench import yardstick


def read(obs):
    spent = obs.get("groups", {}).get(yardstick.FFN, 0.0)
    if not spent or not obs.get("ffn_least_s"):
        return None
    return 100.0 * obs["ffn_least_s"] / spent
