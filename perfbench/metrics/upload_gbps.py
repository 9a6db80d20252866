"""GB/s the host stages the request at: the bytes handed to the program's
upload (its counter ``serve.upload_bytes``) over the host time of its
span ``serve.upload`` (``serve/inputs.py:upload``), over the window."""

from perfbench import program_spans


def attach(run):
    program_spans.attach(run)


def read(run):
    moved = program_spans.counters().get('serve.upload_bytes')
    upload = program_spans.spans().get('serve.upload')
    if not moved or upload is None:
        return None
    return moved / 1e9 / (upload['host_ms'] / 1e3)
