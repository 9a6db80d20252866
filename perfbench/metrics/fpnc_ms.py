"""Device ms a call in the program's span ``bevfusion.fpnc``
(``models/fpnc.py:FPNC``)."""

from perfbench import program_spans


def attach(run):
    program_spans.attach(run)


def read(run):
    return program_spans.ms_a_call(run, 'bevfusion.fpnc')
