"""Host time in ``serve.sync`` (``cli.generate_group``'s synchronize that
ends the compute phase: the host waiting for the card), in ms per served
clip. Small against the compute phase means the host, not the card, sets
its pace."""

from benchmark.program_spans import ms_per


def read(run):
    return ms_per(run, ["serve.sync"], "clips", "host")
