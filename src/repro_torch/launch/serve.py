"""Standard serving entry point of the port: batched greedy generation.

The *standard* path of the reference's ``launch/serve.py``: prefill once,
then one-token decode steps against a KV cache, every step on the card (the
reference jits them wholesale).  The *mixed* path is the Program export in
:mod:`repro_torch.models.programs` run by :mod:`repro_torch.mixed`.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-1b-a400m

Every token-only architecture serves (dense: SmolLM, Llama 3.2, Qwen2; moe:
Granite MoE, DBRX; hybrid: Zamba2; ssm: xLSTM), at its reduced size, with
random weights.  The encoder-decoder and VLM families need frames or
patches beside the tokens, which ``greedy_generate`` does not take, as in
the reference: their callers drive ``models.api.prefill`` and
``models.api.decode`` themselves.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import reduced_config
from ..core.api import resolve_device
from ..models import api
from .steps import make_decode_step, make_prefill_step


def greedy_generate(cfg, params, prompt: np.ndarray, *, steps: int, tp: int = 1,
                    max_len: int | None = None) -> np.ndarray:
    """Batched greedy decoding: prompt (B,T) -> tokens (B, steps + 1).

    Runs on the parameters' device; the tokens stay there until the end.
    """
    if cfg.family in ("encdec", "vlm"):
        raise ValueError(f"greedy_generate feeds tokens only; the {cfg.family!r} family "
                         f"({cfg.name}) also takes frames or patches: drive "
                         f"models.api.prefill and models.api.decode")
    B, T = prompt.shape
    max_len = max_len or (T + steps + 1)
    device = params["embed"]["table"].device
    cache = api.init_cache(cfg, B, max_len, tp=tp, device=device)
    prefill = make_prefill_step(cfg, tp=tp)
    decode = make_decode_step(cfg, tp=tp)
    logits, cache = prefill(params, {"tokens": torch.as_tensor(prompt, device=device)}, cache)
    tok = torch.argmax(logits[..., : cfg.vocab], dim=-1).to(torch.int32)
    out_tokens = []
    for _ in range(steps):
        out_tokens.append(tok)
        logits, cache = decode(params, cache, {"token": tok})
        tok = torch.argmax(logits[..., : cfg.vocab], dim=-1).to(torch.int32)
    out_tokens.append(tok)
    return torch.cat(out_tokens, dim=1).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = api.init(cfg, gen, tp=1, device=device)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (args.requests, args.prompt_len), dtype=np.int32)
    t0 = time.time()
    out = greedy_generate(cfg, params, prompt, steps=args.gen, tp=1)
    dt = time.time() - t0
    print(f"served {args.requests} requests × {args.gen} tokens in {dt:.2f}s "
          f"({args.requests*args.gen/dt:.1f} tok/s) on {device}")
    print("sample:", out[0][:12])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
