"""setup_s: seconds from the process's start to the window's start (host
clock): imports, kernel builds or loads, data, weights, the checked steps,
warm-up and graph capture."""


def read(run):
    return run.setup_s
