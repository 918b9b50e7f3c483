"""The generator's "accumulate+inpaint" stage per request (stage clock,
CUDA events), in ms: the part of a request that grows with its 1-4
references."""


def read(run):
    return run.readings.get("texture_ms_per_request")
