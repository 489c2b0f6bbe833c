"""Time per output token, 95th percentile over every stream that finished
in the window: (its answer's return - its submission) / the tokens it
emitted, taken on the client's side."""
from portbench.tails import percentile


def read(record):
    xs = [(c.done - c.submit) * 1e3 / len(c.answer) for c in record["completions"]
          if c.ok and c.done <= record["t1"]]
    return percentile(xs, 95) if xs else None
