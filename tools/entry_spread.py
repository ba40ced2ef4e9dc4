"""JAX's own spread on the entry-trajectory tests' runs: the bounds of
``tests/test_torch_entry_*.py``.

    JAX_PLATFORMS=cpu python3 tools/entry_spread.py [byol] [emotion] [ft] \
        [--port]

For each named test module, its JAX entry point (``jax_run``) on the
test's corpus and config, then again four ways, each a float32
evaluation of the same run as good as the first (the method of
``tools/premixed_spread.py``, which found the one-ulp nudge alone short
of JAX's own spread by up to 5×):

  * ``up``, ``down``: the first batch's waveforms one float32 ulp up or
    down (``np.nextafter``);
  * ``attention``: JAX's Pallas attention (``use_flash_attention``: the
    block kernel up to 384 frames, the flash kernel above) for its XLA
    attention;
  * ``ffn``: JAX's Pallas FFN (``ffn_impl="fused"``) for its XLA pair.

The Pallas kernels run in interpret mode on the CPU, as the JAX
package's own tests run them.  Prints the first run's epoch records
(where a test's early-stopping ``MIN_DELTA`` is read), each way's largest
|Δ| of each metric family against the first run (the module's ``gaps``),
and their maximum, which the test doubles into its ``BOUNDS``; with
``--port``, also the port's entry point from JAX's initial variables (the
module's ``port_run``) against the first run, the gap the test holds to
those bounds; then a JSON summary.  Imports the JAX package; the CPU only.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"
# the tests' eight virtual CPU devices (tests/conftest.py)
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS",
                                                                 ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_"
                               "force_host_platform_device_count=8").strip()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

MODULES = {"byol": "test_torch_entry_byol",
           "emotion": "test_torch_entry_emotion",
           "ft": "test_torch_entry_ft"}


WAYS = {"up": {"nudge": float("inf")},
        "down": {"nudge": float("-inf")},
        "attention": {"variant": {"use_flash_attention": True}},
        "ffn": {"variant": {"ffn_impl": "fused"}}}


# what each module's port_run takes of JAX's first run
START = {"byol": lambda ref: ref["variables"], "emotion": lambda ref: ref,
         "ft": lambda ref: ref["params"]}


def spread(name: str, port: bool = False) -> dict:
    mod = __import__(MODULES[name])
    out = {}
    with tempfile.TemporaryDirectory() as root:
        data = mod.corpus(root)
        ref = mod.jax_run(root, *data)
        out["reference"] = (ref["epochs"] if "epochs" in ref else
                            {task: r["epochs"] for task, r in ref.items()})
        print(f"{name} reference: {json.dumps(out['reference'])}",
              flush=True)
        for way, kwargs in WAYS.items():
            out[way] = mod.gaps(ref, mod.jax_run(root, *data, **kwargs))
            print(f"{name} {way}: {out[way]}", flush=True)
        out["max"] = {k: max(out[w][k] for w in WAYS) for k in out["up"]}
        if port:
            out["port"] = mod.gaps(ref, mod.port_run(root, *data,
                                                     START[name](ref)))
            print(f"{name} port: {out['port']}", flush=True)
    return out


def main(argv=None) -> int:
    args = list(argv if argv is not None else sys.argv[1:])
    port = "--port" in args
    names = [a for a in args if a != "--port"] or list(MODULES)
    print(json.dumps({name: spread(name, port) for name in names},
                     indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
