"""Host ms a call in the program's span ``serve.upload``
(``serve/inputs.py:upload``: the host rotation check, the casts and the
copies of the request to the device)."""

from perfbench import program_spans


def attach(run):
    program_spans.attach(run)


def read(run):
    return program_spans.ms_a_call(run, 'serve.upload', key='host_ms')
