"""Shared-library offloading (paper §4.4.2 / Table 3).

Accelerates an *unmodified* "pre-built" application by offloading only the
shared libraries it calls (zlib/libpng analogues).  The app's own functions
are never compiled — exactly like replacing a guest .so with an
offload-enabled build while the application binary stays untouched.

    PYTHONPATH=src python -m repro_torch.examples.offload_library [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from .. import mixed
from ..core.api import resolve_device
from ..workloads.libs import build_library_app, library_unit_filter

APPS = ["zlibflate", "imagemagick"]
LIB_SETS = [("zlib only", ("zlib.",)),
            ("libpng only", ("libpng.",)),
            ("zlib+libpng", ("zlib.", "libpng."))]


def bench(prog, args, unit_filter=None, scheme="tech-gfp", device=None):
    if unit_filter is None:
        hybrid = mixed.trace(prog).plan("qemu").compile(backend=device)
    else:
        hybrid = mixed.trace(prog).plan(
            scheme, unit_filter=unit_filter).compile(backend=device)
    hybrid(*args)  # warmup: plan + unit build
    t0 = time.perf_counter()
    out = hybrid(*args)
    return time.perf_counter() - t0, out, hybrid


def run(device=None, *, scale: str = "bench") -> dict:
    """Print the demo; returns ``{app: {label: (seconds, sorted units)}}``
    with ``"pure emulation"`` beside the three library sets."""
    resolve_device(device)
    out = {}
    for app in APPS:
        prog, args = build_library_app(app, scale)
        t_qemu, ref, _ = bench(prog, args, device=device)
        res = out[app] = {"pure emulation": (t_qemu, [])}
        print(f"== {app} (unmodified app binary) ==")
        print(f"  pure emulation            {t_qemu*1e3:8.1f} ms")
        for label, libs in LIB_SETS:
            t, outs, hybrid = bench(prog, args, library_unit_filter(libs),
                                    device=device)
            np.testing.assert_allclose(outs[0], ref[0], rtol=2e-3, atol=2e-3)
            units = sorted(hybrid.last_plan.units)
            res[label] = (t, units)
            print(f"  offload {label:12s}      {t*1e3:8.1f} ms   "
                  f"speedup {t_qemu/t:4.2f}x   units={units}")
        print()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="unit device: omit for the CUDA card, 'cpu' for the CPU")
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
