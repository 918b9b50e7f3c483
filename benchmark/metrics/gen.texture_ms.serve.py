"""The generator's "accumulate+inpaint" stage (the texture nets; stage
clock, CUDA events), in ms per served clip."""


def read(run):
    return run.readings.get("stage_ms_per_clip", {}).get(
        "accumulate+inpaint")
