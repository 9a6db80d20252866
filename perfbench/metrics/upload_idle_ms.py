"""Device-idle ms a call that falls inside the program's
``omnihd.serve.upload`` ranges: the stretches in which the device runs
neither a kernel nor a copy (``perfbench.stats.idle_gaps`` over the
profiler's device events) intersected with the upload's host ranges, all
on the profiler's one clock."""

from perfbench import program_spans, stats

RANGE = 'omnihd.serve.upload'


def attach(run):
    program_spans.attach(run)


def read(run):
    tl = run.timeline
    ranges = stats.merge_intervals(
        (s, e) for name, s, e in tl.host if name == RANGE)
    if not ranges:
        return None
    gaps = stats.idle_gaps([(s, e) for _, s, e in tl.device], tl.lo, tl.hi)
    idle, i = 0, 0
    for s, e in ranges:                 # both sorted and disjoint
        while i < len(gaps) and gaps[i][1] <= s:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < e:
            idle += min(e, gaps[j][1]) - max(s, gaps[j][0])
            j += 1
    return idle / 1e6 / run.window.requests
