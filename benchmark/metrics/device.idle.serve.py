"""Share of the traced window in which no operation ran on the card (the
union of the profiler's device intervals), in %."""


def read(run):
    ts = run.trace_summary
    if not run.cuda() or not ts or not ts["window_s"]:
        return None
    return 100.0 * (1.0 - ts["busy_s"] / ts["window_s"])
