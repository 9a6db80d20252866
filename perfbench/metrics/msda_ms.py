"""Device ms a call in every ``msda`` span
(``ops/ms_deform_attn.py:multi_scale_deformable_attn``: the temporal
self-attention, the spatial cross-attention once a camera, the decoder's
cross-attention)."""

from perfbench import program_spans


def attach(run):
    program_spans.attach(run)


def read(run):
    return program_spans.ms_a_call(run, 'msda')
