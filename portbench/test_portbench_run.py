"""The run's outside: the last line's keys, the device trace's reduction, the
refusal without a card or without the program, and the import check by
whole top-level name."""
from __future__ import annotations

import io
import json
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

from portbench import devtrace, harness, registry, tiny

RUN = registry.ROOT / "run.py"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: run.py would run the cell")


def _run_cli(cwd, *args):
    return subprocess.run([sys.executable, str(cwd / "portbench" / "run.py"), *args],
                          cwd=cwd, capture_output=True, text=True, timeout=120)


def test_no_card_no_result(no_card):
    p = _run_cli(registry.REPO, "--workload", "decode.paged", "--seed", "1", "--seconds", "1")
    assert p.returncode == 2 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_benchmark_files_alone_do_not_run(tmp_path, no_card):
    shutil.copy(registry.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(registry.ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_cli(tmp_path, "--workload", "decode.paged", "--seed", "1", "--seconds", "1")
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(trace):
    cell, config = tiny.decode()
    result = harness.run(cell, config, registry.benchmark(), seed=2**31 + 5, seconds=0.5,
                         trace=trace, device="cpu")
    out, err = io.StringIO(), io.StringIO()
    harness.emit(result, out, err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    e2e, layer = registry.cell_metrics(registry.benchmark(), cell["name"])
    want = {m["name"] for m in (layer if trace else e2e)}
    assert set(line["metrics"]) <= want and line["metrics"]
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"}
    tail = err.getvalue().strip().splitlines()
    assert [t.split()[1] for t in tail] == list(line["checks"])
    for name, c in line["checks"].items():
        assert f"check {name} {c['value']!r} limit {c['limit']!r}" in err.getvalue()


def test_a_traced_run_reads_counters_in_its_untraced_half(monkeypatch):
    """The spans and the device trace cover the window's first half; the
    program-counter metrics read the counters of its second, untraced half."""
    seen = {}
    read = harness._metric_values
    monkeypatch.setattr(harness, "_metric_values",
                        lambda entries, record, *a: seen.update(record) or read(entries, record, *a))
    cell, config = tiny.decode()
    result = harness.run(cell, config, registry.benchmark(), seed=2**31 + 9, seconds=1.0,
                         trace=True, device="cpu")
    assert result["correct"]
    assert seen["traced_window_s"] == pytest.approx(0.5, abs=0.1)
    assert seen["window_s"] == pytest.approx(0.5, abs=0.1)
    assert seen["counters"]["tokens"] > 0 and seen["traced_counters"]["tokens"] > 0
    split_ns = (seen["t0"] + seen["traced_window_s"]) * 1e9
    assert seen["spans"] and all(s.start_ns <= split_ns for s in seen["spans"])


def test_device_trace_reduction():
    """Busy time is the union of device intervals; idle time goes to the
    innermost host span open at each gap; the breakdown keeps ten."""
    Span = lambda name, kind, a, b: SimpleNamespace(  # noqa: E731
        name=name, kind=kind, start_ns=a * 1000, dur_ns=(b - a) * 1000, tid=1)
    trace = SimpleNamespace(mark_ns=0, intervals=lambda: [
        (1000.0, 1001.0, "void spin_kernel(long)"),          # the marker at host 0 us
        (1010.0, 1030.0, "void k1(float*)"), (1020.0, 1040.0, "void k2(float*)"),
        (1100.0, 1110.0, "Memcpy HtoD (Pageable -> Device)")])
    spans = [Span("request", "harness", 0, 200), Span("layer0", "crossing", 40, 100)]
    dev = devtrace.reduce(trace, 0, 200_000, spans)
    assert dev["window_s"] == pytest.approx(200e-6)
    assert dev["busy_s"] == pytest.approx(40e-6)
    assert dev["kernels"]["void k1(float*)"] == {"seconds": pytest.approx(20e-6), "count": 1}
    assert dev["idle_by_host"] == {"harness:request": pytest.approx(100e-6),
                                   "crossing:layer0": pytest.approx(60e-6)}
    b = devtrace.breakdown(dev)
    assert b["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    assert set(b) == {"device_ops", "idle_gaps"} and len(b["device_ops"]) <= 10


def test_import_check_compares_whole_top_level_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.serve", "numpy"]) == []
    assert harness.forbidden_modules(["repro.core.api", "jaxlib.xla", "flax"]) == [
        "flax", "jaxlib", "repro"]
    assert harness.forbidden_modules(["jax"]) == ["jax"]
    assert harness.forbidden_modules(["jax_cpu_plugin", "reprox"]) == []


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from portbench import harness, tiny, registry\n"
            "c, cfg = tiny.mixed()\n"
            "r = harness.run(c, cfg, registry.benchmark(), seed=1, seconds=0.3, trace=True,"
            " device='cpu')\n"
            "assert r['correct'], r\n"
            "print(harness.forbidden_modules(sys.modules))\n"
            % (str(registry.REPO), str(registry.REPO / "src")))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
