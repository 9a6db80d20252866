"""Device ms a call in the radar branch: the program's spans
``bevfusion.pillars`` (the dense pillar encoder's canvas),
``bevfusion.second`` and ``bevfusion.secondfpn``."""

from perfbench import program_spans


def attach(run):
    program_spans.attach(run)


def read(run):
    return program_spans.ms_a_call(run, 'bevfusion.pillars',
                                   'bevfusion.second', 'bevfusion.secondfpn')
