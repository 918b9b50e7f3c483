"""The generator's "refine CRN+fuse" stage (``VideoGenerator``'s stage
clock: CUDA events on the stream), in ms per served clip."""


def read(run):
    return run.readings.get("stage_ms_per_clip", {}).get("refine CRN+fuse")
