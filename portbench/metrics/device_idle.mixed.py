"""Device: the share of the traced window in which no kernel, copy or fill
ran on the card (``torch.profiler``'s device activity), in %."""


def read(record):
    dev = record["device"]
    if not dev or not dev["window_s"]:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
