"""Table 3 analogue: shared-library offloading for unmodified apps.

Offloading only zlib / only libpng / both, measured on four "pre-built"
downstream apps whose own functions are never offloaded (unit_filter).
Paper claims: zlib acceleration ≫ libpng; effects of multiple libraries are
additive (imagemagick: 1.20× libpng, 3.87× zlib, 3.96× both); library-level
acceleration needs no app modification (C8).
"""
from __future__ import annotations

from ..workloads.libs import build_library_app, library_unit_filter
from .common import SchemeRun, compile_scheme, csv_row, run_compiled

APPS = ["apng2gif", "optipng", "imagemagick", "zlibflate"]
LIB_SETS = {
    "libpng": ("libpng.",),
    "zlib": ("zlib.",),
    "libpng+zlib": ("libpng.", "zlib."),
}


def sweep(scale: str = "bench", *, device=None, repeats: int = 3
          ) -> dict[str, dict[str, SchemeRun]]:
    """{app: {"qemu" | lib set: SchemeRun}}; the lib sets under tech-gfp."""
    out = {}
    for app in APPS:
        prog, args = build_library_app(app, scale)
        res = {"qemu": run_compiled(compile_scheme(prog, "qemu", device=device), args,
                                    repeats=repeats)}
        for lib_name, prefixes in LIB_SETS.items():
            hybrid = compile_scheme(prog, "tech-gfp", device=device,
                                    unit_filter=library_unit_filter(prefixes))
            res[lib_name] = run_compiled(hybrid, args, repeats=repeats)
        out[app] = res
    return out


def rows(sweeps: dict[str, dict[str, SchemeRun]]) -> list[str]:
    out = []
    for app, res in sweeps.items():
        t_qemu = res["qemu"].seconds
        out.append(csv_row(f"table3/{app}/qemu", t_qemu * 1e6, "speedup=1.000"))
        for lib_name in LIB_SETS:
            r = res[lib_name]
            out.append(csv_row(
                f"table3/{app}/{lib_name}", r.seconds * 1e6,
                f"speedup={t_qemu / r.seconds:.3f};"
                f"offloaded_units={len(r.hybrid.last_plan.units)}"))
    return out


def run(scale: str = "bench", *, device=None):
    return rows(sweep(scale, device=device))


if __name__ == "__main__":
    for r in run():
        print(r)
