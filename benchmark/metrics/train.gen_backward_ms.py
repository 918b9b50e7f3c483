"""Stream time in ``train.g_loss`` (VGG19, D and FD on the output) and the
generator's own ``train.backward`` and ``train.update`` (those directly in
``train.step``), in ms per stage-4 step."""

from benchmark.program_spans import ms_per, under_step


def read(run):
    tail = ms_per(run, ["train.g_loss"], "steps", "stream")
    if tail is None:
        return None
    own = ms_per(run, ["train.backward", "train.update"], "steps", "stream",
                 under_step)
    return tail + (own or 0.0)
