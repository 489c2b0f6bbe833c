"""Entry kind ``mixed_server_hybrid``: requests through the port's
``MixedServer`` over the hybrid Mamba-2/attention forward exported by
``repro_torch.models.programs.export_hybrid_forward`` (with the host check)
and planned by the paper's mechanism, with the settings of
``mixed_server`` (whose submission, counters, check and control it
keeps): the server buckets concurrent requests by padded shape and runs
each bucket as one batched entry call, guest and offload units on the card.

The weights are made by the configuration's reference, on the device from
the seed, and mapped here into the exporter's layout: ``in_proj`` split by
its outputs into z, x, B, C and dt, the depthwise conv by its channels into
x, B and C, ``input_linear`` into gate and up.  The SSD runs in chunks of
the configuration's ``system.ssd_chunk``.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np

from portbench.loadgen import seed_words
from portbench.registry import load_module

_base = load_module(Path(__file__).with_name("mixed_server.py"))


def port_params(w: dict, n: dict) -> dict:
    """The reference's weights in the layout ``export_hybrid_forward`` reads."""
    I, N, H = n["I"], n["N"], n["H"]
    layers, jm, ja = [], 0, 0
    for i, kind in enumerate(n["types"]):
        wg, wu = w["w_in"][i].chunk(2, dim=-1)
        layer = {"ln1": {"scale": w["ln1"][i]}, "ln2": {"scale": w["ln2"][i]},
                 "mlp": {"wg": wg, "wu": wu, "wd": w["w_out"][i]}}
        if kind == "mamba":
            z, x, B, C, dt = w["in_proj"][jm].split([I, I, N, N, H], dim=-1)
            cw, cb = w["conv_w"][jm], w["conv_b"][jm]
            layer["mamba"] = {
                "w_z": z, "w_x": x, "w_B": B, "w_C": C, "w_dt": dt,
                "conv_x": cw[:I], "conv_x_bias": cb[:I], "conv_B": cw[I:I + N],
                "conv_B_bias": cb[I:I + N], "conv_C": cw[I + N:], "conv_C_bias": cb[I + N:],
                "dt_bias": w["dt_bias"][jm], "A_log": w["A_log"][jm], "D": w["D"][jm],
                "norm": w["mnorm"][jm], "w_out": w["out_proj"][jm]}
            jm += 1
        else:
            layer["attn"] = {k: w[k][ja] for k in ("wq", "wk", "wv", "wo")}
            ja += 1
        layers.append(layer)
    return {"embed": {"table": w["embed"]}, "ln_f": {"scale": w["ln_f"]}, "layers": layers}


def port_config(system: dict, m: dict):
    """The port's model configuration with the sizes of the file."""
    from repro_torch.configs import HybridLayout, SSMConfig
    from repro_torch.configs.granite_4_0_h_micro import CONFIG

    if m["position_embedding_type"] != "nope":
        raise ValueError(f"export_hybrid_forward has no positional encoding, the file asks "
                         f"for {m['position_embedding_type']!r}")
    return dataclasses.replace(
        CONFIG, n_layers=m["num_hidden_layers"], d_model=m["hidden_size"],
        n_heads=m["num_attention_heads"], n_kv_heads=m["num_key_value_heads"],
        head_dim=m["hidden_size"] // m["num_attention_heads"],
        d_ff=m["shared_intermediate_size"], vocab=m["vocab_size"],
        tie_embeddings=m["tie_word_embeddings"], compute_dtype=system["compute_dtype"],
        ssm=SSMConfig(state_dim=m["mamba_d_state"], conv_kernel=m["mamba_d_conv"],
                      expand=m["mamba_expand"], chunk=system["ssd_chunk"],
                      head_dim=m["mamba_d_head"]),
        layout=HybridLayout(
            layer_types=tuple(m["layer_types"]),
            embedding_multiplier=m["embedding_multiplier"],
            residual_multiplier=m["residual_multiplier"],
            attention_multiplier=m["attention_multiplier"],
            logits_scaling=m["logits_scaling"], norm_eps=m["rms_norm_eps"]))


class Driver(_base.Driver):
    def __init__(self, config: dict, cell: dict, *, seed: int, device: str, reference):
        marks = [("start", time.perf_counter())]
        from repro_torch import mixed
        from repro_torch.models.programs import export_hybrid_forward
        from repro_torch.serve import BucketLadder, MixedServer

        marks.append(("imports", time.perf_counter()))
        # the file holds the published configuration's keys at its top level
        self.model, self.ref, self.device = config, reference, device
        self.check_cfg = config["check"]
        self.seed = seed_words(seed)
        system = {**config["system"], **cell.get("system", {})}
        m = self.model
        self.vocab = m["vocab_size"]
        self.seq = cell["traffic"]["prompt_tokens"]
        self.w = reference.make_weights(m, seed, device)
        marks.append(("weights", time.perf_counter()))
        cfg = port_config(system, m)
        program, _ = export_hybrid_forward(cfg, port_params(self.w, reference.dims(m)),
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
