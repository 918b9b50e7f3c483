"""Model FLOPs per served clip (the reference's, ``counts``) times the
traced window's clips per second, over the card's dense bf16 peak, in %."""

from benchmark import counts


def read(run):
    if not run.cuda() or "clips_per_s" not in run.readings:
        return None
    flops = counts.generator_flops_per_clip(run.cfg, run.readings["refs"],
                                            run.readings["frames"])
    return 100.0 * flops * run.readings["clips_per_s"] / counts.PEAK_BF16_FLOPS
