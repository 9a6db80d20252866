"""Device ms a step from the step's ``mark('loss')`` to its
``mark('backward')``: the backward pass."""


def attach(run):
    run.driver.marks = run.spans


def read(run):
    return run.spans.between_ms('loss', 'backward') / run.window.requests
