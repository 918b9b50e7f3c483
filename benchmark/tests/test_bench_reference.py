"""The plain reference against ``jafpro_tpu_torch`` at a small size on the
CPU, both in float32 on the same seeded weights and inputs: the z-buffer,
a served clip's four uint8 streams, and three stage-4 steps."""

import types

import numpy as np
import pytest
import torch

from benchmark import compare, program, traffic, weights
from benchmark.reference import nets, ops
from benchmark.reference.generate import generate_clip
from benchmark.tests.tiny import REPO, SMALL

CFG = dict(SMALL, num_parts=24, viewing_angle=30.0, near=0.1, far=25.0,
           compute_dtype="float32", batch_size=4, face_GAN=True)


def fake_run(seed, **cfg):
    return types.SimpleNamespace(cfg=dict(CFG, **cfg), seed=seed,
                                 device=torch.device("cpu"))


def test_fill_gives_both_trees_the_same_values():
    run = fake_run(2 ** 31 + 3)
    pipe, _ = program.build_pipeline(run)
    net = nets.build(CFG["image_size"], CFG["face_crop_size"], 24)
    weights.fill(net, run.seed)
    a, b = dict(pipe.named_parameters()), dict(net.named_parameters())
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert float(a["refine.ConvBlock_0.Conv_0.weight"].detach().std()) > 0
    gen_only = nets.build(64, 16, 24, modules=nets.GENERATOR)
    weights.fill(gen_only, run.seed)
    for k, v in gen_only.named_parameters():
        assert torch.equal(v, b[k]), k


@pytest.mark.parametrize("scene", ["mesh", "slivers"])
def test_zbuffer_matches_the_port_plain_rasterizer(scene):
    from jafpro_tpu_torch.geometry.rasterizer import (
        rasterize_fim_wim_reference)

    S = 64
    if scene == "mesh":
        cfg = dict(CFG, num_verts=6890)
        verts, cams = traffic.poses(cfg, 2, traffic.rng_for(5))
        _, faces = traffic.mesh(cfg)
        fv = ops.project_faces(torch.from_numpy(cams),
                               torch.from_numpy(verts),
                               torch.from_numpy(faces).long())
    else:
        from jafpro_tpu_torch.utils.meshproxy import sliver_scene

        fv = torch.from_numpy(sliver_scene(S, 3))[None]
    fim, wim = ops.zbuffer(fv.contiguous(), S, chunk=1 << 20)
    pf, pw = rasterize_fim_wim_reference(fv.contiguous(), S)
    assert (fim >= 0).any()
    assert torch.equal(fim.int(), pf)
    assert torch.allclose(wim, pw, atol=1e-6)


def test_served_clip_matches_the_port():
    from jafpro_tpu_torch import cli
    from jafpro_tpu_torch.infer import stack_clips

    run = fake_run(2 ** 33 + 1)
    pipe, pcfg = program.build_pipeline(run)
    gen = cli.serving_generator(pipe, pcfg)
    clip = traffic.make_clip(run.cfg, 2, 4, 17)
    wire = dict(clip, ref_mask=np.ones((1, 2), np.float32))
    out = gen.generate_batch(stack_clips([wire]))
    served = {s: out[s][0].numpy() for s in compare.STREAMS}
    net = nets.build(64, 16, 24, modules=nets.GENERATOR)
    weights.fill(net, run.seed)
    faces = program.reference_faces(run)
    ref = generate_clip(net, clip, faces, run.cfg, zbuffer_chunk=1 << 20)
    for s in compare.STREAMS:
        assert served[s].shape == ref[s].shape
        d = np.abs(served[s].astype(int) - ref[s].astype(int))
        assert d.max() <= 1, (s, d.max())
        assert d.mean() < 0.02, (s, d.mean())


def test_stage4_steps_match_the_port():
    from jafpro_tpu_torch import cli
    from jafpro_tpu_torch.data.shardio import collapse_target_dims
    from jafpro_tpu_torch.data.shardio import interval_spec
    from jafpro_tpu_torch.train.common import (
        TrainState, apply_curriculum, to_device)

    from benchmark.harness import load_driver

    train = load_driver(REPO, "train_steps")
    run = fake_run(2 ** 32 + 9)
    cfg = run.cfg
    spec = interval_spec(num_refs=2, image_size=64, part_size=16,
                         num_parts=24, num_verts=38)
    rng = np.random.RandomState(3)
    batches = []
    for j in range(3):
        recs = [traffic.make_record(cfg, 100 + 4 * j + i) for i in range(4)]
        raw = {k: np.stack([r[k] for r in recs]) for k in recs[0]}
        batches.append(apply_curriculum(collapse_target_dims(spec, raw), 4,
                                        rng, 2))
    pipe, _ = program.build_pipeline(run)
    step, lrs = cli.make_step(pipe, 4)
    state = TrainState(pipe, lrs)
    named = {f"{n}.{k}": p for n in lrs
             for k, p in getattr(pipe, n).named_parameters()}
    theta0 = {k: p.detach().clone() for k, p in named.items()}
    losses, moment = [], {}
    for i, b in enumerate(batches):
        state, m = step(state, to_device(b, run.device))
        losses.append({k: float(v) for k, v in m.items()})
        if i == 0:
            for n in lrs:
                for k, p in getattr(pipe, n).named_parameters():
                    moment[f"{n}.{k}"] = float(
                        state.opts[n].state[p]["exp_avg"].norm())
    prog = {"losses": losses, "moment": moment,
            "change": {k: float((p - theta0[k]).norm())
                       for k, p in named.items()}}
    net = nets.build(64, 16, 24)
    weights.fill(net, run.seed)
    ref = train.follow(net, program.reference_faces(run), cfg, batches)
    gaps = train.gaps_of(prog, ref)
    assert gaps["loss"] < 1e-5, gaps
    assert gaps["grad"] < 1e-4, gaps
    assert gaps["change"] < 1e-3, gaps
