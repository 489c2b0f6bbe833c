"""Request latency, 95th percentile over every request answered in the
window: submission to response, taken on the client's side."""
from portbench.tails import percentile


def read(record):
    xs = [(c.done - c.submit) * 1e3 for c in record["completions"]
          if c.ok and c.done <= record["t1"]]
    return percentile(xs, 95) if xs else None
