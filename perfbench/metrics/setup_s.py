"""setup_s: seconds from the process's start to the first timed call
(loading, building or loading the kernels, making the inputs, warm-up)."""


def read(run):
    return run["setup_s"]
