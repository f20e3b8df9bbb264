"""setup_s: seconds from the process's start to the window's opening:
importing, building or loading the kernels, making the weights, building
the server, warming every shape the cell uses."""


def read(run) -> float:
    return run.setup_s
