"""The check that decides ``correct``: the references agree with the port at
a reduced size on the CPU, sound runs pass, and a run whose timed path is
broken underneath fails, once for each fault a serving cell can have.  The
control (the reference in TF32 in the program's place), judged by the same
check and limits, is not correct."""
from __future__ import annotations

import io
import json

import numpy as np
import pytest
import torch

from portbench import harness, registry, tiny

SEED = 2**31 + 41


def _run(cell, config, seconds=0.6):
    return harness.run(cell, config, registry.benchmark(), seed=SEED, seconds=seconds,
                       trace=False, device="cpu")


def test_attn_lm_reference_draws_the_programs_weights():
    from repro_torch.models.programs import export_attn_decode_lm

    ref = registry.reference("attn-decode-lm-960")
    program = export_attn_decode_lm(vocab=64, d_model=32, max_context=64, seed=SEED)
    for name, w in ref.draw_weights(64, 32, SEED).items():
        assert np.array_equal(w, program.constants[name]), name


def test_attn_lm_reference_against_the_port():
    from repro_torch import mixed
    from repro_torch.models.programs import export_attn_decode_lm

    ref = registry.reference("attn-decode-lm-960")
    program = export_attn_decode_lm(vocab=64, d_model=32, max_context=64, seed=SEED)
    prefill = mixed.trace(program).plan("tech-gfp").compile(backend="cpu")
    tokens = np.random.default_rng(1).integers(0, 64, (3, 20), dtype=np.int32)
    got = prefill(tokens)[0]
    w = {k: torch.from_numpy(v) for k, v in ref.draw_weights(64, 32, SEED).items()}
    for row, logits in zip(tokens, got):
        want = ref.logits(w, torch.from_numpy(row.astype(np.int64)))[-1]
        np.testing.assert_allclose(logits, want.numpy(), rtol=1e-5, atol=1e-5)


def test_dense_reference_against_the_port():
    from repro_torch import mixed
    from repro_torch.models.programs import export_dense_forward

    drv = registry.driver("mixed_server")
    ref = registry.reference("smollm-360m-mixed")
    cell, config = tiny.mixed()
    m = config["model"]
    w = ref.make_weights(m, SEED, "cpu")
    program, _ = export_dense_forward(drv.port_config(config["system"], m),
                                      drv.port_params(w, ref.dims(m)), batch=1, seq=16,
                                      with_host_check=True, tp=1)
    hybrid = mixed.trace(program).plan("tech-gfp").compile(backend="cpu")
    tokens = np.random.default_rng(2).integers(0, m["vocab_size"], (2, 16), dtype=np.int32)
    logits, row_max = hybrid(tokens)
    want = ref.logits(w, m, torch.from_numpy(tokens.astype(np.int64)))
    np.testing.assert_allclose(logits, want.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(row_max, want.max(-1).values.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("make", [lambda: tiny.decode("decode.paged"),
                                  lambda: tiny.decode("decode.shared-prefix"),
                                  lambda: tiny.mixed()],
                         ids=["decode.paged", "decode.shared-prefix", "mixed.coalesce"])
def test_sound_runs_are_correct(make):
    result = _run(*make())
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0


def _token_altered(monkeypatch):
    from repro_torch.serve import runtime

    monkeypatch.setattr(runtime, "greedy_sample",
                        lambda row: (int(np.argmax(row)) + 1) % len(row))


def _state_unchanged(monkeypatch):
    """A step whose fresh k/v rows never reach the state."""
    from repro_torch.serve.batcher import PagedKVState

    append = PagedKVState.append_row
    monkeypatch.setattr(PagedKVState, "append_row", lambda self, slot, rows: append(
        self, slot, {k: np.zeros_like(v) for k, v in rows.items()}))


def _entry_outputs(monkeypatch, alter):
    from repro_torch.core.api import CompiledHybrid

    call = CompiledHybrid.call_reported

    def broken(self, *args):
        outs, report = call(self, *args)
        return alter(args, outs, lambda a: call(self, *a)[0]), report

    monkeypatch.setattr(CompiledHybrid, "call_reported", broken)


def _answer_altered(monkeypatch):
    def alter(args, outs, _):
        logits = np.array(outs[0])
        logits[..., 0] += 0.5
        return (logits,) + tuple(outs[1:])

    _entry_outputs(monkeypatch, alter)


def _half_batch_left_out(monkeypatch):
    """The entry runs the first half of its rows and hands the second half
    the first half's answers."""
    def alter(args, outs, call):
        rows = args[0].shape[0]
        if rows < 2:
            return outs
        half = call(tuple(a[: rows // 2] for a in args))
        return tuple(np.concatenate([h, h, h[:rows % 2]])[:rows] for h in half)

    _entry_outputs(monkeypatch, alter)


@pytest.mark.parametrize("make,fault", [
    (lambda: tiny.decode(), _token_altered),
    (lambda: tiny.decode(), _state_unchanged),
    (lambda: tiny.mixed(), _answer_altered),
    (lambda: tiny.mixed(), _half_batch_left_out),
], ids=["decode-token-altered", "decode-state-unchanged", "mixed-answer-altered",
        "mixed-half-batch-left-out"])
def test_a_broken_path_is_not_correct(make, fault, monkeypatch):
    fault(monkeypatch)
    result = _run(*make())
    assert not result["correct"], result["checks"]


def _control_run(cell, config, seconds):
    """A run with the control judged beside the program, and its last lines."""
    result = harness.run(cell, config, registry.benchmark(), seed=SEED, seconds=seconds,
                         trace=False, device="cpu", control=True)
    out, err = io.StringIO(), io.StringIO()
    harness.emit(result, out, err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[-2:] == ["control", "checks"]
    assert "control correct False" in err.getvalue()
    return result


def test_the_mixed_control_fails_its_limit():
    """The dense reference in TF32, put in the program's place and judged
    by the harness's own check at the configuration's limits, is not
    correct where the program is."""
    result = _control_run(*tiny.mixed(), seconds=0.6)
    ctl = result["control"]
    assert result["correct"] and not ctl["correct"]
    assert ctl["checks"]["logit_rel_err"]["limit"] == registry.config(
        "smollm-360m-mixed")["check"]["limits"]["logit_rel_err"]
    assert ctl["checks"]["logit_rel_err"]["requests"] == result["checks"]["logit_rel_err"][
        "requests"]


def test_the_decode_control_fails_its_limit():
    """The attention LM's reference in TF32, decoding greedily in the
    program's place and judged by the harness's own check at the
    configuration's limit, is not correct where the program is.  A TF32
    choice differs from float32's at about one position in a thousand, so
    the run serves 64 streams of 120 tokens at a vocabulary of 4096; the
    window is shorter than any stream, so each client sends one."""
    cell, config = tiny.decode()
    config["model"].update(vocab=4096, max_context=256)
    config["system"]["page_size"] = 16
    cell["traffic"].update(clients=64, prompt_tokens=32, shared_prefix_tokens=0,
                           new_tokens={"min": 120, "max": 120})
    result = _control_run(cell, config, seconds=0.05)
    ctl = result["control"]
    assert result["correct"] and result["attempted"] == 64 and not ctl["correct"]
    assert ctl["checks"]["logit_gap"]["limit"] == registry.config(
        "attn-decode-lm-960")["check"]["limits"]["logit_gap"]
    assert ctl["checks"]["logit_gap"]["tokens"] == 64 * 120


def test_a_run_that_compares_nothing_is_not_correct(monkeypatch):
    """Every number the configuration limits has to be read: a run whose
    check compared no answer is not correct."""
    monkeypatch.setattr(registry.driver("mixed_server").Driver, "kept", lambda self, req: False)
    result = _run(*tiny.mixed())
    assert result["failed"] == 0 and not result["correct"]
    assert "logit_rel_err" not in result["checks"]
