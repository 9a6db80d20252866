"""Host s the program spends building its served model, a model built:
its set-up spans ``setup.build`` (the model on the host),
``setup.load_state_dict`` and ``setup.to_device`` (fold, move, cast), as
``Predictor`` and ``StreamPredictor`` record them with spans on or off
(one model in a run)."""

from perfbench import program_spans

NAMES = ('setup.build', 'setup.load_state_dict', 'setup.to_device')


def attach(run):
    program_spans.attach(run)


def read(run):
    found = program_spans.spans()
    hits = [found[n] for n in NAMES if n in found]
    if not hits:
        return None
    return sum(h['host_ms'] / h['calls'] for h in hits) / 1e3
