"""Share of the traced window in which the device runs neither a kernel
nor a copy, in % (profiler)."""

from perfbench.stats import idle_share_pct


def read(run):
    return idle_share_pct(run.timeline.busy_s(), run.timeline.window_s)
