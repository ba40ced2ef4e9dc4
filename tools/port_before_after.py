"""The "before" half of a before/after comparison of the port on one card.

Runs ``chip_smoke.py``'s phases 9 (BYOL step), 11 (SER evaluator, with
its device profile) and 13 (fine-tune micro-step, with its profile) on the
package of an earlier commit whose conv frontend has neither K6 nor K7, so
their launch counts are expected to be 0 there.  Put both halves in one
call to the card, from the root of a checkout of the newer commit:

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    cp chip_smoke.py tools/port_before_after.py build/parent/
    cp nrse_tpu_torch/ops/fused_frontend.py \\
        nrse_tpu_torch/ops/pallas_norm.py build/parent/nrse_tpu_torch/ops/
    (cd build/parent && python3 port_before_after.py) && python3 chip_smoke.py

(the two ops modules are copied because ``chip_smoke.py`` imports them; the
earlier package never calls them).
"""

import sys

import chip_smoke


def no_frontend_kernels(cfg, forwards: int, backwards: int) -> dict:
    return {k: 0 for k in chip_smoke._frontend_counts()}


def main() -> int:
    chip_smoke.frontend_want = no_frontend_kernels
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    chip_smoke.phase_training()
    chip_smoke.phase_ser()
    chip_smoke.phase_ft_step()
    return 0


if __name__ == "__main__":
    sys.exit(main())
