"""The cell ``mixed.hybrid`` and its configuration ``granite-4.0-h-micro-mixed``:
found by name, a reference that loads nothing of the program, the three
readers on synthetic records, ``work_hybrid`` against a hand count, and the
whole harness on the CPU at a tiny cut: sound runs correct, a broken answer
and the TF32 control not."""
from __future__ import annotations

import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness, registry, work, work_hybrid

CELL, CONFIG = "mixed.hybrid", "granite-4.0-h-micro-mixed"
SEED = 2**31 + 43
TINY = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, mamba_n_heads=4,
            mamba_d_head=16, mamba_d_state=16, mamba_expand=1, shared_intermediate_size=128,
            intermediate_size=128, vocab_size=256, num_hidden_layers=4,
            layer_types=["mamba", "attention", "mamba", "mamba"])


def tiny() -> tuple[dict, dict]:
    """The cell and its configuration cut for the CPU: every kind of layer,
    widths of 16, 40 positions against a chunk of 16."""
    c, cfg = registry.cell(CELL), registry.config(CONFIG)
    cfg.update(TINY)
    cfg["system"]["ssd_chunk"] = 16
    cfg["check"].update(share=0.5)
    c["traffic"].update(clients=4, prompt_tokens=40)
    return c, cfg


def test_registry_finds_the_cell_and_its_files():
    bench = registry.benchmark()
    entry = registry.bench_cell(bench, CELL)
    assert entry["config"] == CONFIG and entry["chips"] == 1
    cell, config = registry.cell(CELL), registry.config(CONFIG)
    assert cell["traffic"] == {"clients": 16, "prompt_tokens": 512, "rows_cycle": [1, 1, 1, 2]}
    assert config["reduced"] == ["torch_dtype"] and config["system"]["ssd_chunk"] == 128
    assert config["mamba_chunk_size"] == 256          # as published
    driver = registry.driver(config["driver"])
    assert issubclass(driver.Driver, registry.driver("mixed_server").Driver)
    ref = registry.reference(config["reference"])
    assert all(callable(getattr(ref, f)) for f in ("make_weights", "dims", "logits"))
    n = ref.dims(config)
    assert (n["Lm"], n["La"], n["I"]) == (36, 4, 4096)
    e2e, layer = registry.cell_metrics(bench, CELL)
    assert {m["name"] for m in e2e} == {"rows_per_s", "request_p95_ms", "setup_s"}
    assert {m["name"] for m in layer} == {"device_idle.mixed", "fetch_ms_per_batch.mixed",
                                          "ssd_roofline.hybrid", "ssd_share.hybrid",
                                          "mfu.hybrid"}


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; from portbench import registry; "
            f"registry.reference({CONFIG!r}); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro', 'repro_torch', 'jax', 'jaxlib', 'flax'}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=registry.REPO, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def _span(kind, args, dur=1000):
    return SimpleNamespace(name="ssd_scan", kind=kind, start_ns=0, dur_ns=dur, tid=1, args=args)


SSD_ARGS = {"b": 8, "t": 512, "h": 64, "n": 128, "p": 64, "chunk": 128, "route": "simt"}
SIMT = "void (anonymous namespace)::ssd_scan_kernel<float>(float const*, long long)"
MMA = "void ssd_mma::scan_kernel<float>(float const*)"


def _record(kernels, busy_s=2.0, spans=()):
    return {"device": {"kernels": {n: {"seconds": s, "count": 1} for n, s in kernels.items()},
                       "busy_s": busy_s, "window_s": 4.0},
            "spans": list(spans)}


def read(name, rec):
    return registry.metric_reader(name, True).read(rec)


def test_ssd_roofline_reads_spans_against_both_bodies():
    bound = work_hybrid.ssd_bound_s(8, 512, 64, 128, 64)
    spans = [_span("ssd", SSD_ARGS), _span("ssd", SSD_ARGS), _span("unit", None)]
    rec = _record({SIMT: 0.004, MMA: 0.001, "gemm": 5.0}, spans=spans)
    assert read("ssd_roofline.hybrid", rec) == pytest.approx(100 * 2 * bound / 0.005)
    assert read("ssd_roofline.hybrid", _record({"gemm": 5.0}, spans=spans)) is None
    assert read("ssd_roofline.hybrid", _record({SIMT: 0.004}, spans=spans[2:])) is None
    assert read("ssd_roofline.hybrid", {"device": None, "spans": spans}) is None


def test_ssd_share_reads_kernel_time_over_busy_time():
    assert read("ssd_share.hybrid", _record({SIMT: 0.3, MMA: 0.1, "gemm": 1.0})) \
        == pytest.approx(20.0)
    assert read("ssd_share.hybrid", _record({"gemm": 1.0})) is None
    assert read("ssd_share.hybrid", _record({SIMT: 0.3}, busy_s=0.0)) is None


def test_mfu_hybrid_reads_the_untraced_rows():
    m = registry.config(CONFIG)
    rec = {"counters": {"request_rows": 40}, "window_s": 25.0,
           "cell": {"traffic": {"prompt_tokens": 512}}, "config": m}
    want = 100 * 40 * work_hybrid.hybrid_forward_flops(m, 512) / (25.0 * work.FP32_TC_FLOPS)
    assert read("mfu.hybrid", rec) == pytest.approx(want)
    assert read("mfu.hybrid", {**rec, "counters": {"request_rows": 0}}) is None


def test_work_hybrid_by_hand_at_the_tiny_size():
    m = {**registry.config(CONFIG), **TINY}
    t = 5
    # a Mamba layer: in-projection 64 -> 2*64 + 2*16 + 4 (z, x, B, C, dt),
    # SSD 4 N P per token and head, out-projection 64 -> 64
    mamba = 2 * t * 64 * 164 + 4 * t * 4 * 16 * 16 + 2 * t * 64 * 64
    # attention: q, o 64 wide, k, v 2 heads of 16; 15 causal pairs, 4 heads
    attn = 2 * t * 64 * (64 + 64 + 32 + 32) + 4 * 4 * 15 * 16
    mlp = 2 * t * 3 * 64 * 128
    head = 2 * t * 64 * 256
    assert work_hybrid.hybrid_forward_flops(m, t) == 3 * mamba + attn + 4 * mlp + head
    assert work_hybrid.ssd_flops(2, 3, 4, 5, 6) == 4 * 2 * 3 * 4 * 5 * 6
    assert work_hybrid.ssd_bytes(2, 3, 4, 5, 6) == (2 * 144 + 24 + 2 * 30) * 4
    # the published model: ~3.31 TFLOP a 512-token row, 30% in the Mamba layers
    full = registry.config(CONFIG)
    assert 3.2e12 < work_hybrid.hybrid_forward_flops(full, 512) < 3.4e12


def _run(cell, config, **kw):
    return harness.run(cell, config, registry.benchmark(), seed=SEED, seconds=0.8,
                       trace=False, device="cpu", **kw)


def test_a_sound_run_is_correct_and_the_control_is_not():
    result = _run(*tiny(), control=True)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["checks"]["logit_rel_err"]["value"] < 1e-5
    ctl = result["control"]
    assert not ctl["correct"]
    assert ctl["checks"]["logit_rel_err"]["limit"] == registry.config(
        CONFIG)["check"]["limits"]["logit_rel_err"]


def test_an_altered_answer_is_not_correct(monkeypatch):
    from repro_torch.core.api import CompiledHybrid

    call = CompiledHybrid.call_reported

    def broken(self, *args):
        outs, report = call(self, *args)
        logits = np.array(outs[0])
        logits[..., 0] += 0.5
        return (logits,) + tuple(outs[1:]), report

    monkeypatch.setattr(CompiledHybrid, "call_reported", broken)
    assert not _run(*tiny())["correct"]
