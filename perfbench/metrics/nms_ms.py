"""Device ms a call in the program's span ``decode.nms``
(``ops/nms.py:multiclass_nms_rotated``: the rotated IoU matrix, the
greedy fixpoint, the top ``max_num``)."""

from perfbench import program_spans


def attach(run):
    program_spans.attach(run)


def read(run):
    return program_spans.ms_a_call(run, 'decode.nms')
