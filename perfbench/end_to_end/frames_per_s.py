"""Stream frames completed in the window over the window's seconds (a
call serves one frame of every stream)."""


def read(window):
    return window.samples / window.window_s
