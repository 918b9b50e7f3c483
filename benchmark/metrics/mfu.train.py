"""Model FLOPs per training sample (the reference's stage-4 step,
``counts``) times the traced window's samples per second, over the card's
dense bf16 peak, in %."""

from benchmark import counts


def read(run):
    if not run.cuda() or "samples_per_s" not in run.readings:
        return None
    return (100.0 * counts.train_flops_per_sample(run.cfg)
            * run.readings["samples_per_s"] / counts.PEAK_BF16_FLOPS)
