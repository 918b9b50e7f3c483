"""Stream time in ``train.flow`` (the step's flow without a graph) and
``train.gen_forward`` (the generator forward and the face crops), in ms
per stage-4 step."""

from benchmark.program_spans import ms_per


def read(run):
    return ms_per(run, ["train.flow", "train.gen_forward"], "steps",
                  "stream")
