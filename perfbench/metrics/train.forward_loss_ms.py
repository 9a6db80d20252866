"""Device ms a step from its start to the step's own ``mark('loss')``
(``train/loop.py:make_train_step``): upload, forward, target assignment
and the loss."""


def attach(run):
    run.driver.marks = run.spans


def read(run):
    return run.spans.between_ms('step_start', 'loss') / run.window.requests
