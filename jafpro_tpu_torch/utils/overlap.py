"""Host-I/O / device-compute overlap for serving (a copy of
``jafpro_tpu/utils/overlap.py``, which is pure Python, without its opt-in
phase printout: ``cli.serve`` times the phases).

The reference's test script is a strictly serial per-clip loop — decode all
frames, run the model, write all frames (``test/conv_pro_test.py:143-163``;
its own timing prints show prep/data dominating). At device generation
speeds the host side (decodes, ``cv2.imwrite``) would dominate a serial
loop, so ``run_overlapped`` pipelines the three phases:

  load(i+1)  — prefetch thread(s): decode or pack read
  compute(i) — caller thread: the device work, in item order as in the
               serial loop
  write(i-1) — writer pool: device-to-host copies, encodes, imwrites

cv2 decode/encode and device blocking release the GIL, so the phases
genuinely overlap even single-core.  Exceptions propagate: a failed load or
write re-raises in the caller after in-flight work drains.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator, Sequence


def run_overlapped(
    items: Sequence[Any],
    load: Callable[[Any], Any],
    compute: Callable[[Any, Any], Any],
    write: Callable[[Any, Any], None],
    prefetch: int = 2,
    writers: int = 2,
) -> Iterator[Any]:
    """For each item: ``write(item, compute(item, load(item)))``, with loads
    prefetched ``prefetch`` items ahead and writes running asynchronously.

    ``compute`` runs on the calling thread in item order.  Yields each
    item after its compute finishes (its write may still be in flight);
    all writes are joined before the iterator is exhausted."""
    if not items:
        return
    with ThreadPoolExecutor(max_workers=max(prefetch, 1)) as loader, \
            ThreadPoolExecutor(max_workers=max(writers, 1)) as writer:
        pending = []  # write futures
        loads = {}
        horizon = min(prefetch, len(items))
        for i in range(horizon):
            loads[i] = loader.submit(load, items[i])
        try:
            for i, item in enumerate(items):
                loaded = loads.pop(i).result()
                nxt = i + horizon
                if nxt < len(items):
                    loads[nxt] = loader.submit(load, items[nxt])
                out = compute(item, loaded)
                pending.append(writer.submit(write, item, out))
                # surface write errors early instead of at the final join
                pending = [f for f in pending
                           if not (f.done() and f.result() is None)]
                yield item
        finally:
            for f in list(loads.values()):
                f.cancel()
            for f in pending:
                f.result()
