"""One run of one cell: set-up, the measured window, the check, the metrics
and the result line.

    result = run(cell, config, bench, seed=7, seconds=40, trace=False)

The driver named by the configuration builds the system under test from the
seed and warms every shape the cell's traffic uses; that is set-up.  Then the
cell's clients offer load for ``seconds``; no client sends after the window
closes, and the answers still in flight are waited for.  Without ``trace``
the end-to-end metrics are read over the whole window.  With it the
per-layer metrics are: the window's first half runs under
``torch.profiler`` (device activity only) and the program's ``obs`` spans,
which the device-trace and span metrics read; the second half runs without
either, and the program-counter metrics read its counters, so that the
profiler's cost to the host does not enter them.  After the window the
driver frees the program's state and checks the answers against the plain
reference.  With ``control`` the control (the reference in a lower
precision, put in the program's place) is judged by the same check and the
same limits; it has to come out not correct.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time

from . import devtrace, registry
from .loadgen import ClosedLoop, Traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DRAIN_S = 60.0          # how long past the close an answer may still come


def forbidden_modules(names) -> list[str]:
    """Top-level names among ``names`` (module names) that the benchmark's
    process may not hold, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def scalar_fields(report) -> dict:
    """A report dataclass's numeric fields, by name."""
    return {f.name: getattr(report, f.name) for f in dataclasses.fields(report)
            if isinstance(getattr(report, f.name), (int, float))}


def counter_delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def _metric_values(entries, record, per_layer: bool, root) -> dict:
    out = {}
    for m in entries:
        value = registry.metric_reader(m["name"], per_layer, root).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def verdict(checks: list[dict], limits: dict, *, drained: bool, failed: int) -> bool:
    """``correct``: every answer came back, none failed, every number the
    configuration limits was read, and each is within its limit."""
    return (drained and failed == 0 and set(limits) <= {c["name"] for c in checks}
            and all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks))


def _limited(checks: list[dict], limits: dict) -> list[dict]:
    for c in checks:
        c.setdefault("limit", limits.get(c["name"]))
    return checks


def _by_name(checks: list[dict]) -> dict:
    return {c["name"]: {k: v for k, v in c.items() if k != "name"} for c in checks}


def _until(t: float) -> None:
    time.sleep(max(0.0, t - time.perf_counter()))


def run(cell: dict, config: dict, bench: dict, *, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float | None = None, root=registry.ROOT,
        control: bool = False, log=None) -> dict:
    """Run ``cell`` once; returns the result line's object (``log`` gets
    progress lines).  ``control`` also judges the driver's control."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: None)
    driver_mod = registry.driver(config["driver"], root)
    ref = registry.reference(config["reference"], root)
    t_driver = time.perf_counter()
    drv = driver_mod.Driver(config, cell, seed=seed, device=device, reference=ref)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    traffic = Traffic(cell["traffic"], seed, drv.vocab)
    tracer = dtrace = None
    if trace:
        from repro_torch import obs

        tracer = obs.Tracer(capacity=2_000_000, label="portbench")
        obs.install(tracer)
        if on_card:
            dtrace = devtrace.DeviceTrace(torch)
            dtrace.start()
    loop = ClosedLoop(traffic, drv.submit, tracer=tracer)
    setup_s = time.perf_counter() - t_start
    parts = {"before_driver": t_driver - t_start, **getattr(drv, "setup_parts", {})}
    log(f"set-up {setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))

    c0 = drv.counters()
    t0 = loop.start()
    ts, cs, tu, cu, spans = t0, c0, t0, c0, []
    if trace:
        _until(t0 + seconds / 2)
        ts, cs = time.perf_counter(), drv.counters()
        if dtrace is not None:
            dtrace.stop()
        from repro_torch import obs

        obs.install(None)
        spans = tracer.snapshot()
        tu, cu = time.perf_counter(), drv.counters()
    _until(t0 + seconds)
    t1 = loop.stop()
    c1 = drv.counters()
    drained = loop.join(t1 + DRAIN_S)
    t2 = time.perf_counter()
    dev = None
    if dtrace is not None:
        dev = devtrace.reduce(dtrace, int(t0 * 1e9), int(ts * 1e9), spans)
        log(f"device trace: {dev['events']} events in the traced half, reduced in "
            f"{time.perf_counter() - t2:.1f} s")
    log(f"window {t1 - t0:.3f} s, drained {t2 - t1:.3f} s, "
        f"{len(loop.completions)} answers of {loop.submitted}")

    drv.close()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    completions, attempted = list(loop.completions), loop.submitted
    failed = sum(not c.ok for c in completions) + (attempted - len(completions))
    for c in [c for c in completions if not c.ok][:3]:
        log(f"failed: client {c.request.client} request {c.request.index}: {c.error}")
    limits = config["check"]["limits"]
    checks = _limited(drv.check(completions), limits)
    correct = verdict(checks, limits, drained=drained, failed=failed)
    if control:
        control_checks = _limited(drv.check(drv.control(completions)), limits)
        control_correct = verdict(control_checks, limits, drained=drained, failed=failed)
    del drv, loop
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    record = {
        "cell": cell, "config": config, "setup_s": setup_s, "t0": t0, "t1": t1,
        "completions": completions,
        # the program's counters: over the window, or its untraced half
        "counters": counter_delta(c1, cu), "window_s": t1 - tu,
        # the traced half's, beside its device trace and spans
        "traced_counters": counter_delta(cs, c0), "traced_window_s": ts - t0,
        "spans": spans, "device": dev,
    }
    e2e, layer = registry.cell_metrics(bench, cell["name"])
    metrics = _metric_values(layer if trace else e2e, record, trace, root)
    result = {
        "correct": bool(correct),
        "attempted": int(attempted),
        "failed": int(failed),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if dev is not None:
        result["device"]["busy_s"] = dev["busy_s"]
        result["device"]["window_s"] = dev["window_s"]
        result["breakdown"] = devtrace.breakdown(dev)
    if tracer is not None:
        result["spans_dropped"] = tracer.spans_dropped
    if control:
        result["control"] = {"correct": bool(control_correct),
                             "checks": _by_name(control_checks)}
    result["checks"] = _by_name(checks)
    return result


def emit(result: dict, out=sys.stdout, err=sys.stderr) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error (the control's, where read, before the program's), then
    the result as the last line on standard output."""
    def lines(prefix, checks):
        for name, c in checks.items():
            extra = "".join(f" {k} {v!r}" for k, v in c.items() if k not in ("value", "limit"))
            print(f"{prefix} {name} {c['value']!r} limit {c['limit']!r}{extra}", file=err)

    if "control" in result:
        print(f"control correct {result['control']['correct']}", file=err)
        lines("control-check", result["control"]["checks"])
    lines("check", result["checks"])
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
