"""Random biases on the port's seeded weights, for the tests.

The port's ``models.convert.init_*state_dict`` draw every bias zero, as
JAX's initialisers do.  A check that holds a bias path (a Dense bias, a
conv bias, a kernel's bias operand) to a reference needs signal on it, so
the tests put normal(0, 0.02) biases on the seeded weights with
:func:`with_random_biases`.  ``chip_smoke.py`` keeps its own copy.
"""

from typing import Dict

import torch

BIAS_STD = 0.02


def with_random_biases(sd: Dict[str, torch.Tensor],
                       seed: int) -> Dict[str, torch.Tensor]:
    """A copy of ``sd`` whose biases (every key ending in ``bias``: Dense,
    conv and norm biases, the pooling's ``sap_linear_bias``) are drawn
    normal(0, 0.02), in the dict's order, from a generator seeded with
    ``seed``; the other entries are ``sd``'s own."""
    generator = torch.Generator().manual_seed(seed)
    out = dict(sd)
    for name, t in sd.items():
        if name.endswith("bias"):
            out[name] = BIAS_STD * torch.randn(
                tuple(t.shape), generator=generator).to(t.dtype)
    return out

