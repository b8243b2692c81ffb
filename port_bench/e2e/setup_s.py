"""Seconds from the process's start to the first request falling due:
importing torch, the CUDA context, loading the kernels' libraries, making the
weights, building the server and warming up every shape the traffic uses."""


def read(run):
    return run.setup_s
