"""Host time inside ``flow.step`` (the harness step, before the loop's
synchronize), in ms per step. Close to the step's wall time means the step
is bound by its launches, or waits for the card inside."""

from benchmark.program_spans import ms_per


def read(run):
    return ms_per(run, ["flow.step"], "steps", "host")
