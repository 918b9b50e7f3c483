"""Stream time in every ``train.update`` (each optimizer step, its
``zero_grad`` and its scheduler step: the generator's, D's three and
FD's), in ms per stage-4 step. A cross-cut: it is part of
``train.disc_ms`` and ``train.gen_backward_ms``."""

from benchmark.program_spans import ms_per


def read(run):
    return ms_per(run, ["train.update"], "steps", "stream")
