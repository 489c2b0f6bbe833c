"""Entry kind ``mixed_server``: requests through the port's ``MixedServer``
over the dense forward exported by
``repro_torch.models.programs.export_dense_forward`` (with the host check,
the paper's printf case) and planned by the paper's mechanism (``trace ->
plan(scheme) -> compile``): the server buckets concurrent requests by padded
shape, runs each bucket as one batched entry call, guest and offload units
on the card, and splits the answers.

A request is rows of token ids; its answer is the entry's outputs, the
logits at every position and their row maxima.  The weights are made by the
configuration's reference, on the device from the seed, and handed to the
exporter and to the reference alike.  The check compares the answers of a
sample of requests, drawn from the seed before the window, with the
reference's logits.  The control answers them by the reference in TF32.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from portbench.checks import rel_err
from portbench.harness import scalar_fields
from portbench.loadgen import seed_words

KEEP_TAG = 5


def port_params(w: dict, n: dict) -> dict:
    """The reference's weights in the layout ``export_dense_forward`` reads."""
    L, D, Hq, Hkv, hd = n["L"], n["D"], n["Hq"], n["Hkv"], n["hd"]
    return {
        "embed": {"table": w["embed"]},
        "layers": {
            "ln1": {"scale": w["ln1"]},
            "attn": {"wq": w["wq"].view(L, D, Hq, hd), "wk": w["wk"].view(L, D, Hkv, hd),
                     "wv": w["wv"].view(L, D, Hkv, hd), "wo": w["wo"].view(L, Hq, hd, D)},
            "ln2": {"scale": w["ln2"]},
            "mlp": {"wg": w["wg"], "wu": w["wu"], "wd": w["wd"]},
        },
        "ln_f": {"scale": w["ln_f"]},
    }


def port_config(system: dict, m: dict):
    """The port's model configuration with the widths of the file."""
    from repro_torch.configs import get_config

    return dataclasses.replace(
        get_config(system["arch"]), n_layers=m["num_hidden_layers"], d_model=m["hidden_size"],
        n_heads=m["num_attention_heads"], n_kv_heads=m["num_key_value_heads"],
        d_ff=m["intermediate_size"], vocab=m["vocab_size"], rope_theta=m["rope_theta"],
        tie_embeddings=m["tie_word_embeddings"], compute_dtype=system["compute_dtype"])


class Driver:
    def __init__(self, config: dict, cell: dict, *, seed: int, device: str, reference):
        marks = [("start", time.perf_counter())]
        from repro_torch import mixed
        from repro_torch.models.programs import export_dense_forward
        from repro_torch.serve import BucketLadder, MixedServer

        marks.append(("imports", time.perf_counter()))
        self.model, self.ref, self.device = config["model"], reference, device
        self.check_cfg = config["check"]
        self.seed = seed_words(seed)
        system = {**config["system"], **cell.get("system", {})}
        m = self.model
        self.vocab = m["vocab_size"]
        self.seq = cell["traffic"]["prompt_tokens"]
        self.w = reference.make_weights(m, seed, device)
        marks.append(("weights", time.perf_counter()))
        cfg = port_config(system, m)
        program, _ = export_dense_forward(cfg, port_params(self.w, reference.dims(m)),
                                          batch=1, seq=self.seq,
                                          with_host_check=system["host_check"], tp=1)
        marks.append(("export", time.perf_counter()))
        planned = mixed.trace(program).plan(system["scheme"])
        marks.append(("trace_plan", time.perf_counter()))
        self.server = MixedServer(
            planned, ladder=BucketLadder(batch_sizes=tuple(system["buckets"])),
            max_batch_delay=system["max_batch_delay_s"], workers=system["workers"],
            backend=None if device == "cuda" else device)
        marks.append(("compile", time.perf_counter()))
        self.server.warm(np.zeros((1, self.seq), np.int32))
        marks.append(("warm", time.perf_counter()))
        #: seconds of each set-up step, in order
        self.setup_parts = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}

    def kept(self, req) -> bool:
        """Whether the check compares this request's answer: each client's
        first, and others at the configuration's share, drawn from the seed."""
        draw = np.random.default_rng([*self.seed, KEEP_TAG, req.client, req.index]).random()
        return req.index == 0 or draw < self.check_cfg["share"]

    def submit(self, req):
        logits, row_max = self.server.request(req.tokens)
        shape_ok = (logits.shape == (req.rows, self.seq, self.vocab)
                    and row_max.shape == (req.rows, self.seq))
        return shape_ok, ((logits, row_max) if self.kept(req) else None)

    def counters(self) -> dict:
        return scalar_fields(self.server.report())

    def close(self) -> None:
        self.server.close()
        del self.server

    def check(self, completions) -> list[dict]:
        """The kept answers against the reference's logits, one pass over
        ``completions``."""
        import torch

        malformed = requests = rows = 0
        err = 0.0
        for c in completions:
            if not c.ok:
                continue
            shape_ok, kept = c.answer
            malformed += not shape_ok
            if kept is None:
                continue
            logits, row_max = (a if isinstance(a, torch.Tensor) else
                               torch.from_numpy(np.asarray(a)).to(self.device) for a in kept)
            tokens = torch.from_numpy(c.request.tokens.astype(np.int64)).to(self.device)
            ref = self.ref.logits(self.w, self.model, tokens)
            err = max(err, rel_err(logits, ref),
                      float((row_max - ref.max(-1).values).abs().max() / ref.abs().max()))
            requests += 1
            rows += c.request.rows
        out = [{"name": "malformed", "value": float(malformed)}]
        if requests:
            out.insert(0, {"name": "logit_rel_err", "value": err, "requests": requests,
                           "rows": rows})
        return out

    def control(self, completions):
        """The completions with each kept answer replaced by the reference's
        in TF32 from the same rows: the control in the program's place."""
        import torch

        for c in completions:
            if c.ok and c.answer[1] is not None:
                tokens = torch.from_numpy(c.request.tokens.astype(np.int64)).to(self.device)
                low = self.ref.logits(self.w, self.model, tokens, tf32=True)
                c = dataclasses.replace(c, answer=(c.answer[0], (low, low.max(-1).values)))
            yield c
