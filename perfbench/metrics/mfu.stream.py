"""Model FLOPs a stream frame (the benchmark's own reference forward at
the cell's shapes, counted by ``FlopCounterMode``) times the frames the
window completed, over its seconds, as a share of the H100's dense bf16
peak (989 TFLOP/s, data sheet), in %."""

from perfbench.stats import mfu_pct


def read(run):
    return mfu_pct(run.driver.flops_per_sample(), run.window.samples,
                   run.window.window_s)
