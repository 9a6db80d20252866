"""95th percentile of the latency of every call in the window, from its
start to its outputs being ready on the device, in ms."""

from perfbench.stats import percentile


def read(window):
    return percentile(window.latencies_s, 95) * 1e3
