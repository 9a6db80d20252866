"""Device ms a call in the program's span ``bevformer.decoder``
(``models/bevformer/transformer.py``: the reference points and the DETR
decoder's layers)."""

from perfbench import program_spans


def attach(run):
    program_spans.attach(run)


def read(run):
    return program_spans.ms_a_call(run, 'bevformer.decoder')
