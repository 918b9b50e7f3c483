"""Stream time in ``flow.update`` (Adam's step over FlowNet2's 162 M
parameters), in ms per step."""

from benchmark.program_spans import ms_per


def read(run):
    return ms_per(run, ["flow.update"], "steps", "stream")
