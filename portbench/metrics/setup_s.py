"""Process start to the window's start (host clock): loading and building
the kernels, drawing and quantising the weights, the server's warm-up and
the traffic's ramp."""


def read(run):
    return run.setup_s
