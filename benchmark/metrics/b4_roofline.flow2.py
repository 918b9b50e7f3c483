"""B4 (``csrc/correlation.cu``) against its roofline in the FlowNet2 step,
in %: the least time of one forward and one backward at the step's shape
(``flow_counts.b4_bound_s``, bfloat16), times the forward launches in the
trace, over the device time of the trace's correlation kernels, forward
and backward. None where the trace has none."""

from benchmark import flow_counts


def read(run):
    ts = run.trace_summary
    if not run.cuda() or not ts:
        return None
    fwd = [v for n, v in ts["by_name"].items() if "corr_forward" in n]
    bwd = [v for n, v in ts["by_name"].items() if "corr_backward" in n]
    seconds = sum(v[0] for v in fwd + bwd)
    launches = sum(v[1] for v in fwd)
    if not seconds or not launches:
        return None
    B = run.cfg["batch_size"]
    shape = (B,) + flow_counts.corr_shape(run.cfg["crop_size"])[1:]
    bound = (flow_counts.b4_bound_s(shape)
             + flow_counts.b4_bound_s(shape, backward=True))
    return 100.0 * launches * bound / seconds
