"""The traced steps' model FLOPs (``yardstick``: the configuration's
widths on real audio, layers as LayerDrop ran them) over the traced
window at the card's bf16 peak, in %."""

from portbench import yardstick


def read(obs):
    if not obs.get("model_flop"):
        return None
    return 100.0 * obs["model_flop"] / (obs["window_s"]
                                        * yardstick.PEAK_BF16_FLOPS)
