"""Stream time in ``flow.forward`` (FlowNet2's forward and the L1 loss of
the harness step), in ms per step."""

from benchmark.program_spans import ms_per


def read(run):
    return ms_per(run, ["flow.forward"], "steps", "stream")
