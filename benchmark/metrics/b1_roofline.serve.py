"""B1 (``csrc/rasterizer.cu``) against its roofline, in %: the least time
its bytes take at the HBM's peak (``counts.b1_bound_s`` at the launch's
poses) over the kernel's mean device time per launch in the trace."""

from benchmark import counts


def read(run):
    ts = run.trace_summary
    if not run.cuda() or not ts:
        return None
    hits = [v for n, v in ts["by_name"].items() if "raster_kernel" in n]
    seconds, launches = sum(v[0] for v in hits), sum(v[1] for v in hits)
    if not launches:
        return None
    bound = counts.b1_bound_s(run.cfg, run.readings["poses_per_launch"])
    return 100.0 * bound / (seconds / launches)
