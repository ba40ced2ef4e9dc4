"""Where K6's time goes on the card: its kernels with parts of their work
cut out.

Builds, beside the port's library, copies of ``csrc/fused_frontend.cu``
with one part removed each (their results are wrong; only their times
count) and times each on layer 1 of the SER fine-tune's frontend (B = 32,
T_in = 31999, k = 3), the CUDA kernels' device time from checked profiler
traces (``chip_smoke.device_us``):

- ``kernel``: the source as it is;
- ``no GELU``: out = x̂ gamma + beta, without the erf;
- ``no stores``: the forward's and dx's staged tiles are not stored;
- ``products only``: the forward's epilogue ends after the row statistics.

The forward's training and serving entries and the backward's kernels are
timed under each.  Run on the card from the root of a checkout:

    python3 tools/k6_breakdown.py
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from nrse_tpu_torch.ops import fused_frontend  # noqa: E402
from nrse_tpu_torch.runtime import cuda_build  # noqa: E402

SOURCE = cuda_build.CSRC_DIR / "fused_frontend.cu"
ENTRIES = ("nrse_fused_frontend_fwd", "nrse_fused_frontend_bwd")
# the parts cut out: (text of the source, its replacement)
GELU = [("gelu_erf(acc[4 * j + 2 * h] * g.x + be.x)",
         "(acc[4 * j + 2 * h] * g.x + be.x)"),
        ("gelu_erf(acc[4 * j + 2 * h + 1] * g.y + be.y)",
         "(acc[4 * j + 2 * h + 1] * g.y + be.y)")]
STORES = [("  if (xhat != nullptr) store_rows(xs, xhat, first, kC, "
           "T_out - t0, wg * 256);\n  store_rows(os, out, first, kC, "
           "T_out - t0, wg * 256);\n", ""),
          ("    store_rows(staging, dx, (static_cast<size_t>(b) * T_in + q) "
           "* kC,\n                  2 * kC, (T_in - q + 1) / 2, nt % 2 * "
           "kGN);\n", "")]
PRODUCTS = [("  consumers_sync();  // the next tile may write the partials "
             "again\n", "  consumers_sync();\n  return;\n")]
VARIANTS = {"kernel": [], "no GELU": GELU, "no stores": STORES,
            "products only": PRODUCTS}


def build() -> dict:
    """``{variant: library path}``, all built at once."""
    src = SOURCE.read_text()
    out_dir = cuda_build.BUILD_DIR / "k6_breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, procs, libs = cuda_build._nvcc(), [], {}
    for i, (name, cuts) in enumerate(VARIANTS.items()):
        text = src
        for old, new in cuts:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"variant{i}.cu"
        cu.write_text(text)
        libs[name] = out_dir / f"variant{i}.so"
        procs.append(subprocess.Popen(
            [nvcc, *cuda_build.NVCC_FLAGS, "-shared",
             f"-I{cuda_build.CSRC_DIR}", "-o", str(libs[name]), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{log[-4000:]}")
    return libs


def use(path) -> None:
    """Make the wrappers launch the library at ``path``."""
    lib = ctypes.CDLL(str(path))
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = cuda_build._ENTRIES[name]
        fn.restype = ctypes.c_int
    cuda_build._lib = lib


def main() -> int:
    chip_smoke.phase_device()
    libs = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    t_in, k = chip_smoke.frontend_shapes(chip_smoke.FT_BATCH,
                                         chip_smoke.FT_CLIP_SECONDS)[1][0]
    x, kernel, (bias, scale, ln_bias), dout = chip_smoke._k6_inputs(
        gen, chip_smoke.FT_BATCH, t_in, k, dev)
    eps = chip_smoke.LN_EPS
    for name, path in libs.items():
        use(path)
        with torch.no_grad():
            train = chip_smoke.device_us(lambda: fused_frontend._kernel_fwd(
                x, kernel, bias, scale, ln_bias, eps, True), iters=5)
            serve = chip_smoke.device_us(lambda: fused_frontend._kernel_fwd(
                x, kernel, bias, scale, ln_bias, eps, False), iters=5)
            _, xhat, rstd = fused_frontend._kernel_fwd(
                x, kernel, bias, scale, ln_bias, eps, True)
            bwd = chip_smoke.device_us(lambda: fused_frontend._kernel_bwd(
                dout, x, xhat, rstd, kernel, scale, ln_bias), iters=5)
        fwd_us = {n: v for n, v in train.items() if n.startswith("k6_")}
        serve_us = {n: v for n, v in serve.items() if n.startswith("k6_")}
        chip_smoke.log(
            f"[k6 breakdown] {name}: forward (training) "
            f"{sum(fwd_us.values()):.1f} us, forward (serving) "
            f"{sum(serve_us.values()):.1f} us on the card; backward "
            f"{chip_smoke._us_line(bwd)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
