"""Device ms a step in the program's span ``train.optimizer``
(``train/loop.py:make_train_step``: the gradients' clip and AdamW)."""

from perfbench import program_spans


def attach(run):
    program_spans.attach(run)


def read(run):
    return program_spans.ms_a_call(run, 'train.optimizer')
