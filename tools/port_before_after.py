"""The "before" half of a before/after comparison of the port on one card.

Runs ``chip_smoke.py``'s phases 3 (kernel A), 3b (K3), 4 (kernel B), 5
(serving), 6 (K1), 7 (kernel B's training forward and K2), 9 (BYOL step),
11 (SER evaluator, with its device profile) and 13 (fine-tune micro-step,
with its profile) on the package of an earlier commit.  The kernels named
in ``WGMMA_KERNELS`` are new since that commit, so the checks that their
SASS holds HGMMA, and the listings of their registers, are skipped there;
the other kernels' registers are listed on both, and phase 7 prints a
digest of kernel B's and K2 dx's outputs on seeded inputs, equal on both
when their bits are.
Put both halves in one call to the card, from the root of a checkout of
the newer commit:

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    cp chip_smoke.py tools/port_before_after.py build/parent/
    (cd build/parent && python3 port_before_after.py) && python3 chip_smoke.py

(``chip_smoke.py`` is copied because the newer one holds both halves to
the same checks and timings; the earlier package provides every module it
imports).  On the newer tree itself, ``python3 -c "import sys;
sys.path.insert(0, 'tools'); import port_before_after;
sys.exit(port_before_after.main())"`` runs the same phases, for a parent,
tree, tree, parent comparison in one call.  Phase names on the command
line (``python3 port_before_after.py k2``, or ``main(["k2"])``) run only
those, after the device and build phases.
"""

import sys

import chip_smoke

# the kernels this tree adds, which the earlier commit does not have: their
# HGMMA checks and register listings are skipped there (the earlier
# commit's K3 and K2 dW ran on mma.sync)
WGMMA_KERNELS = ("bwd_dq_wgmma", "bwd_dkdv_wgmma", "dout_prep", "EpiDw")


def skipped(*args, **kwargs) -> list:
    chip_smoke.log("[before] skipped on the earlier commit: a kernel it "
                   "does not have")
    return []


# the phases run, in order, unless the command line names some of them
PHASES = ("kernel_a", "k3", "kernel_b", "serving", "k1", "k2", "training",
          "ser", "ft_step")


def main(names=()) -> int:
    check_hgmma = chip_smoke.check_hgmma
    resources = chip_smoke.kernel_resources

    def earlier_hgmma(pattern="gemm_tn_kernel", tag="K2"):
        if pattern in WGMMA_KERNELS:
            return skipped()
        return check_hgmma(pattern, tag)

    def earlier_resources(patterns=("k6_", "ln_row_", "ln_fold"), tag="8d"):
        if any(p in WGMMA_KERNELS for p in patterns):
            return skipped()
        return resources(patterns, tag)

    chip_smoke.check_hgmma = earlier_hgmma
    chip_smoke.kernel_resources = earlier_resources
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    for name in names or PHASES:
        getattr(chip_smoke, f"phase_{name}")()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
