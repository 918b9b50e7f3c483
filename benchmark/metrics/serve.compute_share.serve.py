"""Share of the serving loop's wall time in which its compute phase (one
``generate_batch`` and its wait) ran: ``cli.serve``'s ``compute_ms`` times
its items over its ``loop_seconds``, in %."""


def read(run):
    st = run.readings.get("serve_stats")
    if not st or not st["items"]:
        return None
    return 100.0 * st["compute_ms"] * st["items"] / (1e3 * st["loop_seconds"])
