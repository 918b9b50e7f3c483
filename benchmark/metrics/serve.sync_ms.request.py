"""Host time in ``serve.sync`` (the host waiting for the card at the end
of the compute phase), in ms per request."""

from benchmark.program_spans import ms_per


def read(run):
    return ms_per(run, ["serve.sync"], "requests", "host")
