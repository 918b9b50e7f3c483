"""What the drivers share."""

from __future__ import annotations

import threading

from benchmark import compare, traffic


class Sample:
    """A seeded uniform sample of ``k`` of the served clips (algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, traffic.rng_for(seed, 5)
        self.kept, self.seen = [], 0
        self.lock = threading.Lock()

    def offer(self, item) -> None:
        with self.lock:
            if len(self.kept) < self.k:
                self.kept.append(item)
            else:
                j = int(self.rng.integers(0, self.seen + 1))
                if j < self.k:
                    self.kept[j] = item
            self.seen += 1


def reference_checks(run, kept, mode: str = "float32"):
    """The served clips' numbers: ``kept`` lists (pool index, reference
    count, served streams); each clip is regenerated from the traffic's
    pool and run through the reference in float32. ``mode`` other than
    float32 puts the reference, computed so, in the served clips' place
    (the control)."""
    from benchmark import weights
    from benchmark.harness import Check
    from benchmark.program import reference_faces
    from benchmark.reference import nets, precision
    from benchmark.reference.generate import generate_clip

    tr, pool = run.traffic, run.traffic["pool"]
    precision.strict_float32()
    net = nets.build(run.cfg["image_size"], run.cfg["face_crop_size"],
                     run.cfg["num_parts"], modules=nets.GENERATOR,
                     device=run.device)
    weights.fill(net, run.seed)
    faces = reference_faces(run)
    chunk = (1 << 26) if run.cuda() else (1 << 22)
    pairs = []
    for i, refs, served in kept:
        clip = traffic.make_clip(run.cfg, refs, pool["frames"],
                                 traffic.clip_seed(pool, refs, i))
        ref = generate_clip(net, clip, faces, run.cfg, zbuffer_chunk=chunk)
        if served is None:
            with precision.use(mode):
                served = generate_clip(net, clip, faces, run.cfg,
                                       zbuffer_chunk=chunk)
        pairs.append((served, ref))
    gaps = compare.clip_gaps(pairs, tr["streams"])
    limits = run.workload["check"]["limits"]
    run.readings["checked"] = len(pairs)
    return [Check(f"{s}_lsb", gaps[s], limits[s]) for s in tr["streams"]]

