"""Device time of the host-to-device copies, ms a call (profiler)."""


def read(run):
    s, n = run.timeline.device_s(lambda name: 'HtoD' in name)
    return s * 1e3 / run.window.requests if n else None
