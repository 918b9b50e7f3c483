"""Host time in ``gen.h2d`` (``VideoGenerator.generate_batch``'s copies of
the stacked clip from pageable numpy to the card, on the compute thread),
in ms per served clip."""

from benchmark.program_spans import ms_per


def read(run):
    return ms_per(run, ["gen.h2d"], "clips", "host")
