"""Device ms a call in the BEV conv stack and the head: the program's
spans ``lss.bevencode`` (``models/lss.py:BevEncoderConvs``) and
``bevfusion.fuse_head`` (resize, concat fusion, SE, anchor head)."""

from perfbench import program_spans


def attach(run):
    program_spans.attach(run)


def read(run):
    return program_spans.ms_a_call(run, 'lss.bevencode',
                                   'bevfusion.fuse_head')
