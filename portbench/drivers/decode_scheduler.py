"""Entry kind ``decode_scheduler``: decode streams through the port's
``DecodeScheduler`` over a decode-loop program exported by
``repro_torch.models.programs.export_attn_decode_lm`` and planned by the
paper's mechanism (``trace -> plan(scheme) -> compile``): a batched prefill
at admission (or the prefix-sharing suffix prefill), then one batched paged
decode step a token, the KV state in pages.

A request is one stream: its prompt (one row) and the tokens it asks for;
its answer is the tokens served.  The check runs the plain reference over
every finished stream's prompt and served tokens and takes the widest gap
by which a served token's reference logit lies below the reference's best.
The control serves each stream by the reference in TF32 instead.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from portbench.checks import logit_gap
from portbench.harness import scalar_fields


class Driver:
    def __init__(self, config: dict, cell: dict, *, seed: int, device: str, reference):
        marks = [("start", time.perf_counter())]
        from repro_torch import mixed
        from repro_torch.models.programs import export_attn_decode_lm
        from repro_torch.serve import DecodeScheduler, StateSpec

        marks.append(("imports", time.perf_counter()))
        self.model, self.ref, self.device = config["model"], reference, device
        self.seed = int(seed) % 2**63
        system = {**config["system"], **cell.get("system", {})}
        m = self.model
        self.vocab = m["vocab"]
        program = export_attn_decode_lm(vocab=m["vocab"], d_model=m["d_model"],
                                        max_context=m["max_context"], seed=self.seed)
        marks.append(("export", time.perf_counter()))
        planned = mixed.trace(program).plan(system["scheme"])
        marks.append(("trace_plan", time.perf_counter()))
        share = bool(system.get("share_prefixes", False))
        spec = StateSpec(growing={0: 1, 1: 1}, max_context=m["max_context"],
                         page_size=system["page_size"], share_prefixes=share)
        self.sched = DecodeScheduler(
            planned, step=system["step"], paged_step=system["paged_step"],
            prefill_suffix=system["prefill_suffix"] if share else None,
            capacity=system["capacity"], state=spec,
            backend=None if device == "cuda" else device)
        marks.append(("compile", time.perf_counter()))
        self.sched.warm(cell["traffic"]["prompt_tokens"])
        marks.append(("warm", time.perf_counter()))
        #: seconds of each set-up step, in order
        self.setup_parts = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}

    def submit(self, req) -> np.ndarray:
        if req.rows != 1:
            raise ValueError(f"a decode stream has one prompt row, got {req.rows}")
        return self.sched.submit(req.tokens[0], req.new_tokens).result()

    def counters(self) -> dict:
        return scalar_fields(self.sched.report())

    def close(self) -> None:
        self.sched.close()
        del self.sched

    def _weights(self):
        import torch

        m = self.model
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.ref.draw_weights(m["vocab"], m["d_model"], self.seed).items()}

    def _rows(self, c):
        """A stream's prompt and served tokens as device rows, and the
        positions whose logits chose the served tokens."""
        import torch

        served = torch.from_numpy(np.asarray(c.answer, np.int64)).to(self.device)
        prompt = torch.from_numpy(c.request.tokens[0].astype(np.int64)).to(self.device)
        return prompt, served, slice(prompt.numel() - 1, None)

    def check(self, completions) -> list[dict]:
        """Every finished stream's served tokens against the reference, one
        pass over ``completions``."""
        import torch

        w = None
        malformed = streams = tokens = 0
        gap = 0.0
        for c in completions:
            if not c.ok:
                continue
            a = np.asarray(c.answer)
            if a.shape != (c.request.new_tokens,) or not np.all((0 <= a) & (a < self.vocab)):
                malformed += 1
                continue
            w = self._weights() if w is None else w
            prompt, served, at = self._rows(c)
            ref = self.ref.logits(w, torch.cat([prompt, served[:-1]]), positions=at)
            gap = max(gap, logit_gap(ref, served))
            streams += 1
            tokens += served.numel()
        out = [{"name": "malformed", "value": float(malformed)}]
        if streams:
            out.insert(0, {"name": "logit_gap", "value": gap, "streams": streams,
                           "tokens": tokens})
        return out

    def control(self, completions):
        """The completions with each finished stream's tokens served by the
        reference in TF32 instead, decoding greedily from the same prompt:
        the control in the program's place.  Decoded by refinement from the
        program's tokens: each pass runs the TF32 forward over the prompt and
        the tokens so far, keeps the tokens before the first position whose
        TF32 choice differs and takes the TF32 choices from there on; when no
        choice differs, the tokens are the TF32 greedy decode."""
        import torch

        w = None
        for c in completions:
            a = np.asarray(c.answer) if c.ok else None
            if a is None or a.shape != (c.request.new_tokens,):
                yield c
                continue
            w = self._weights() if w is None else w
            prompt, served, at = self._rows(c)
            for _ in range(served.numel()):
                low = self.ref.logits(w, torch.cat([prompt, served[:-1]]), positions=at,
                                      tf32=True).argmax(dim=-1)
                diff = (low != served).nonzero()
                if not diff.numel():
                    break
                served = torch.cat([served[:int(diff[0])], low[int(diff[0]):]])
            yield dataclasses.replace(c, answer=served.cpu().numpy())
