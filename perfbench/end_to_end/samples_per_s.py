"""Samples completed in the window over the window's seconds."""


def read(window):
    return window.samples / window.window_s
