"""Host time inside ``train.step`` (the step function, before the
loop's synchronize), in ms per stage-4 step. Close to the step's wall
time means the step is bound by its launches, or waits for the card
inside."""

from benchmark.program_spans import ms_per


def read(run):
    return ms_per(run, ["train.step"], "steps", "host")
