"""Set-up: process start to the window's opening (imports, loading the
kernels' libraries, weights, export, trace, plan and warm-up)."""


def read(record):
    return record["setup_s"]
