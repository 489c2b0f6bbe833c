"""All request rows answered in the window, over the window."""


def read(record):
    rows = sum(c.request.rows for c in record["completions"]
               if c.ok and c.done <= record["t1"])
    return rows / record["window_s"]
