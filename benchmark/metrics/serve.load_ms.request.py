"""Mean time of a request's load phase (the pack read), ``cli.serve``'s
``load_ms``, in ms per request: in series with generation in this cell."""


def read(run):
    return run.readings.get("load_ms_per_request")
