"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload decode.paged --seed 7 --seconds 40 --trace 0

From the root of a checkout: the program is ``src/repro_torch`` of that
checkout.  The last line on standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared and its limit, which
also end standard error).  Without a CUDA card, or with fewer than the cell
asks for, it prints no result and exits 2; if the process holds JAX or the
JAX package ``repro`` once the window has closed, it names them and exits 3.

``--control 1`` also puts the control (the plain reference with its products
on TF32 operands) in the program's place after the window, judges it by the
same check and limits, and reports the verdict as ``control`` in the line,
before ``checks``; it has to read not correct.  The benchmark's own runs do
not use it.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path[0] = str(REPO)                 # the folder itself would shadow stdlib names
sys.path.insert(1, str(REPO / "src"))


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (REPO / "src" / "repro_torch").is_dir():
        log(f"no program at {REPO / 'src' / 'repro_torch'}: run from a checkout of the repo")
        return 2
    from portbench import harness, registry

    bench = registry.benchmark()
    entry = registry.bench_cell(bench, args.workload)
    cell = registry.cell(args.workload)
    if cell["config"] != entry["config"]:
        raise SystemExit(f"{args.workload}: workload file names {cell['config']!r}, "
                         f"BENCHMARK.json {entry['config']!r}")
    config = registry.config(cell["config"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        log(f"needs {entry['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = harness.run(cell, config, bench, seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace), t_start=T_START, control=bool(args.control),
                         log=log)
    found = harness.forbidden_modules(sys.modules)
    if found:
        log(f"the process holds {', '.join(found)}: the port may not load JAX or the "
            f"JAX package")
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
