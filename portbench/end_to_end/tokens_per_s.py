"""All tokens every stream emitted in the window, over the window: the
scheduler's token counter read as the window opens and as it closes."""


def read(record):
    return record["counters"]["tokens"] / record["window_s"]
