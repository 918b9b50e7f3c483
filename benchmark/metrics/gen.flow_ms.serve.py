"""Stream time in ``gen.flow`` (the generator's flow branch: projection,
B1's prep and launch, the barycentric warp), in ms per served clip."""

from benchmark.program_spans import ms_per


def read(run):
    return ms_per(run, ["gen.flow"], "clips", "stream")
