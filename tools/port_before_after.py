"""The "before" half of a before/after comparison of the port on one card.

Runs ``chip_smoke.py``'s phases 3 (kernel A), 4 (kernel B), 5 (serving),
6 (K1), 7 (kernel B's training forward and K2), 9 (BYOL step), 11 (SER
evaluator, with its device profile) and 13 (fine-tune micro-step, with its
profile) on the package of an earlier commit.  Its kernels A and B, and
before PR 7 its K2 dx kernel, predate wgmma, so the checks that their
SASS holds HGMMA, and the listings of their registers, are skipped there.
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
tree, tree, parent comparison in one call.
"""

import sys

import chip_smoke

# the kernels the checks skipped on an earlier commit belong to
WGMMA_KERNELS = ("gemm_tn_kernel", "EpiDgd", "EpiStoreBf16", "EpiGelu",
                 "EpiBias", "block_attention_fwd")


def skipped(*args, **kwargs) -> list:
    chip_smoke.log("[before] skipped on the earlier commit: no wgmma "
                   "kernel there")
    return []


def main() -> int:
    chip_smoke.check_hgmma = skipped
    resources = chip_smoke.kernel_resources

    def wgmma_free_resources(patterns=("k6_", "ln_row_", "ln_fold"),
                             tag="8d"):
        if any(p in WGMMA_KERNELS for p in patterns):
            return skipped()
        return resources(patterns, tag)

    chip_smoke.kernel_resources = wgmma_free_resources
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    chip_smoke.phase_kernel_a()
    chip_smoke.phase_kernel_b()
    chip_smoke.phase_serving()
    chip_smoke.phase_k1()
    chip_smoke.phase_k2()
    chip_smoke.phase_training()
    chip_smoke.phase_ser()
    chip_smoke.phase_ft_step()
    return 0


if __name__ == "__main__":
    sys.exit(main())
