"""The traffic generator is a pure function of the seed, every seed gets the
same sizes, and the tails are taken over every sample of the window."""
from __future__ import annotations

import collections

import numpy as np
import pytest

from portbench import registry, tails
from portbench.loadgen import Completion, Request, Traffic

BIG = 2**31 + 977


def _requests(traffic, n):
    return [traffic.request(c, i) for c in range(traffic.clients) for i in range(n)]


@pytest.mark.parametrize("cell", ["decode.paged", "decode.shared-prefix", "mixed.coalesce"])
def test_same_seed_same_requests(cell):
    params = registry.cell(cell)["traffic"]
    a, b = Traffic(params, BIG, 49152), Traffic(params, BIG, 49152)
    for x, y in zip(_requests(a, 20), _requests(b, 20)):
        assert np.array_equal(x.tokens, y.tokens) and x.new_tokens == y.new_tokens
        assert x.tokens.dtype == np.int32 and x.tokens.shape[1] == params["prompt_tokens"]
        assert 0 <= x.tokens.min() and x.tokens.max() < 49152
    other = _requests(Traffic(params, BIG + 1, 49152), 20)
    assert any(not np.array_equal(x.tokens, y.tokens) for x, y in zip(_requests(a, 20), other))


def test_every_seed_gets_the_same_sizes():
    params = registry.cell("decode.paged")["traffic"]
    nt = params["new_tokens"]
    cycle = (nt["max"] - nt["min"]) // nt.get("step", 1) + 1
    sizes = []
    for seed in (1, 2, BIG):
        reqs = _requests(Traffic(params, seed, 100), cycle)
        sizes.append(collections.Counter(r.new_tokens for r in reqs))
    assert sizes[0] == sizes[1] == sizes[2]
    orders = [[Traffic(params, s, 100).request(0, i).new_tokens for i in range(cycle)]
              for s in (1, 2)]
    assert orders[0] != orders[1]
    mix = registry.cell("mixed.coalesce")["traffic"]
    rows = [collections.Counter(r.rows for r in _requests(Traffic(mix, s, 100), 16))
            for s in (5, 6)]
    assert rows[0] == rows[1] == {1: 12 * mix["clients"], 2: 4 * mix["clients"]}


def test_shared_prefix_is_one_per_run():
    params = registry.cell("decode.shared-prefix")["traffic"]
    p = params["shared_prefix_tokens"]
    reqs = _requests(Traffic(params, 11, 49152), 3)
    assert all(np.array_equal(r.tokens[0, :p], reqs[0].tokens[0, :p]) for r in reqs)
    assert len({r.tokens[0, p:].tobytes() for r in reqs}) == len(reqs)


def _window(latencies_ms, tokens=4):
    out = []
    for i, lat in enumerate(latencies_ms):
        req = Request(0, i, np.zeros((1, 4), np.int32), tokens)
        t = i * 0.01
        out.append(Completion(req, t, t + lat / 1e3, True, np.zeros(tokens, np.int32)))
    return out


def test_a_stall_moves_the_tails():
    """One stall of a few requests in a window of 200 moves the p95, which a
    median of chunks would hide."""
    steady = _window([100.0] * 200)
    stalled = _window([100.0] * 185 + [900.0] * 15)
    e2e = {n: registry.metric_reader(n, False) for n in ("request_p95_ms", "tpot_p95_ms")}
    record = {"t1": 1e9, "window_s": 2.0}
    for name, reader in e2e.items():
        calm = reader.read({**record, "completions": steady})
        hit = reader.read({**record, "completions": stalled})
        assert hit > 2 * calm, name
    assert tails.percentile([1, 2, 3, 4], 50) == 2.5
    assert tails.percentile(list(range(101)), 95) == 95
    assert abs(tails.spread([1.0, 1.0, 1.1, 1.0, 1.0, 1.0]) - 0.025) < 1e-12


def test_answers_after_the_close_stay_out_of_the_tails():
    window = _window([100.0] * 50)
    late = _window([5000.0])[0]
    reader = registry.metric_reader("request_p95_ms", False)
    t1 = max(c.done for c in window)
    assert reader.read({"t1": t1, "completions": window + [late]}) == pytest.approx(100.0)
