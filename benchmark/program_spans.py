"""The program's own spans (``jafpro_tpu_torch.utils.profiling``) in a
traced run's window, for the per-layer readers.

The window is bounded by the earliest start and the latest end of the
run's benchmark spans (``run.spans``), which are around the calls into the
program, so the set-up's and the check's work falls outside it. Times are
"host" (``host_ms``: the host's time inside the span) or "stream"
(``stream_ms``: the time between the span's two CUDA events on the
stream, which includes any time the stream waited for the host inside the
span; not the card's busy time). A program that records no spans (no
``profiling.spans``) gives None, and so does a run that was not traced."""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional


def window(run) -> Optional[List[dict]]:
    if not run.trace or not run.spans:
        return None
    try:
        from jafpro_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    return read(min(s[1] for s in run.spans), max(s[2] for s in run.spans))


def ms_per(run, names: Iterable[str], per: str, clock: str,
           keep: Optional[Callable[[dict, dict], bool]] = None):
    """Milliseconds (``clock``: "host" or "stream") summed over the
    window's spans named in ``names`` that ``keep(record, by_id)`` keeps,
    over ``run.readings[per]`` (clips, requests or steps); None when no
    such span was recorded."""
    recs = window(run)
    count = run.readings.get(per)
    if recs is None or not count:
        return None
    names = set(names)
    by_id = {r["id"]: r for r in recs}
    hits = [r for r in recs if r["name"] in names
            and (keep is None or keep(r, by_id))]
    if not hits:
        return None
    return sum(r[clock + "_ms"] for r in hits) / count


def under_step(r: dict, by_id: dict) -> bool:
    """A span directly inside ``train.step``: the generator's own backward
    and update (those of the discriminators are inside ``train.fd`` and
    ``train.d``)."""
    up = by_id.get(r["parent"])
    return up is not None and up["name"] == "train.step"
