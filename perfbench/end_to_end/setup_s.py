"""Process start to the window's start: imports, weights, kernels,
traffic and warm-up, in s."""


def read(window):
    return window.setup_s
