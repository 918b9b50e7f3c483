"""Host time in ``serve.fetch`` (``cli.fetch_clips``: the streams' copies
to the host and their conversion), in ms per request: in series with
generation in this cell."""

from benchmark.program_spans import ms_per


def read(run):
    return ms_per(run, ["serve.fetch"], "requests", "host")
