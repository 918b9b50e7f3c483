"""Stream time in ``train.fd`` (the face discriminator's update) and
``train.d`` (the image discriminator's three), their backward and
optimizer steps included, in ms per stage-4 step."""

from benchmark.program_spans import ms_per


def read(run):
    return ms_per(run, ["train.fd", "train.d"], "steps", "stream")
