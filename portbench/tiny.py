"""Reduced copies of the cells and configurations, for the CPU tests: the
same files, with their widths and traffic cut so that a run takes a second
on the CPU, with the kernels' plain versions; the check and its limits as
they are."""
from __future__ import annotations

from . import registry


def decode(cell: str = "decode.paged") -> tuple[dict, dict]:
    c, cfg = registry.cell(cell), registry.config("attn-decode-lm-960")
    cfg["model"].update(d_model=32, vocab=64, max_context=64)
    cfg["system"]["page_size"] = 4
    shared = 8 if c["traffic"].get("shared_prefix_tokens") else 0
    c["traffic"].update(clients=3, prompt_tokens=16, shared_prefix_tokens=shared,
                        new_tokens={"min": 2, "max": 6})
    return c, cfg


def mixed(cell: str = "mixed.coalesce") -> tuple[dict, dict]:
    c, cfg = registry.cell(cell), registry.config("smollm-360m-mixed")
    cfg["model"].update(hidden_size=64, intermediate_size=128, num_attention_heads=4,
                        num_key_value_heads=2, num_hidden_layers=2, vocab_size=256)
    c["traffic"].update(clients=4, prompt_tokens=16)
    cfg["check"].update(share=0.5)
    return c, cfg
