"""Decode scheduler: prompt positions mapped from shared prefix pages over
the prompt positions admitted (``DecodeReport``), in %."""


def read(record):
    c = record["counters"]
    admitted = c["admitted"] * record["cell"]["traffic"]["prompt_tokens"]
    return 100.0 * c["prefix_tokens_reused"] / admitted if admitted else None
