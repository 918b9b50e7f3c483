"""Stream time in ``flow.backward`` (``zero_grad`` and the backward
through the five nets), in ms per step."""

from benchmark.program_spans import ms_per


def read(run):
    return ms_per(run, ["flow.backward"], "steps", "stream")
