"""Model FLOPs a sample of the forward and the backward (the benchmark's
own reference at the cell's shapes, counted by ``FlopCounterMode``) times
the samples the window's steps completed, over its seconds, as a share of
the H100's dense bf16 peak (989 TFLOP/s, data sheet), in %."""

from perfbench.stats import mfu_pct


def read(run):
    return mfu_pct(run.driver.flops_per_sample(), run.window.samples,
                   run.window.window_s)
