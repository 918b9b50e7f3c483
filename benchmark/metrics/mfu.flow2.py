"""Model FLOPs per training sample (the FlowNet2 reference's step at the
cell's crop, ``flow_counts``) times the traced window's samples per
second, over the card's dense bf16 peak, in %."""

from benchmark import counts, flow_counts


def read(run):
    if not run.cuda() or "samples_per_s" not in run.readings:
        return None
    return (100.0 * flow_counts.flownet2_flops_per_sample(run.cfg)
            * run.readings["samples_per_s"] / counts.PEAK_BF16_FLOPS)
