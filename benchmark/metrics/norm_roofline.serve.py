"""The ConvBlock norm's kernels (``csrc/norm.cu``) against their roofline,
in %: the least time their bytes take at the HBM's peak (the ``n`` of the
window's ``nets.norm`` spans, each call's input read once and output
written once) over the device time of the trace's kernels whose name
holds ``sample_norm``. None where the program has neither."""

from benchmark import counts
from benchmark.program_spans import window


def read(run):
    ts = run.trace_summary
    recs = window(run)
    if not run.cuda() or not ts or recs is None:
        return None
    seconds = sum(v[0] for n, v in ts["by_name"].items()
                  if "sample_norm" in n)
    nbytes = sum(r["n"] or 0 for r in recs if r["name"] == "nets.norm")
    if not seconds or not nbytes:
        return None
    return 100.0 * nbytes / counts.PEAK_HBM_BYTES / seconds
