"""Set-up: seconds from the process's start to the first timed item
(loading, building, weights, inputs, warm-up, kernel #1's build where it is
not built yet)."""


def read(run):
    return run.setup_s
