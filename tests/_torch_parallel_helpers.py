"""What the data-parallel tests run on each rank.

``parallel.spawn`` starts every rank as a fresh interpreter that imports
this module, so it imports ``torch``, ``numpy``, the port and
``chip_smoke.py`` (for the helpers phase 11 shares) only: no JAX and no
test module. Each ``rank_*`` function takes the rank's mesh first
and returns numpy results to the test, which holds them to a
single-process run.
"""

import contextlib
import json
import os
from unittest import mock

import numpy as np
import torch

from chip_smoke import state_digest, trained_params
from jafpro_tpu_torch.bridge import ALL_MODULES, load_jax_params
from jafpro_tpu_torch.config import Config
from jafpro_tpu_torch.data import shardio
from jafpro_tpu_torch.geometry.flow import SMPLFlowEngine
from jafpro_tpu_torch.losses import bce_masked
from jafpro_tpu_torch.models.propagation import BatchStatsNorm
from jafpro_tpu_torch.parallel import (
    create_mesh, data_parallel_jit, replicate, shard_batch, spawn)
from jafpro_tpu_torch.parallel.mesh import reduce_gradients, use_mesh
from jafpro_tpu_torch.pipeline import JAFProPipeline
from jafpro_tpu_torch.train.common import (
    TrainState, synthetic_batch, synthetic_quad_mesh)

# tests/_torch_train_pair.py's configuration
SIZES = dict(image_size=64, part_size=16, maximum_ref_frames=2,
             face_crop_size=16, compute_dtype="float32")
SGD_LR = 1e-3


def run_ranks(fn, *args, world=2, tmp=None):
    """``fn(mesh, *args)`` on ``world`` gloo ranks on the CPU, one thread
    each (the suite runs several files at once), a ``file://`` rendezvous
    under ``tmp``. The ranks do not re-run the test session's start-up."""
    os.environ["JAFPRO_TESTS_SANITIZED"] = "1"
    return spawn(fn, world, backend="gloo", args=args, threads=1,
                 workdir=None if tmp is None else str(tmp), timeout_s=300)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


class Holder(torch.nn.Module):
    """A module with one trained child ``net``, for ``TrainState``."""

    def __init__(self, net):
        super().__init__()
        self.net = net


def rank_mesh_basics(mesh):
    """create_mesh's view, shard_batch's slices and refusals, replicate."""
    out = {"world": mesh.world, "rank": mesh.rank, "device": str(mesh.device),
           "backend": mesh.backend}
    batch = {"x": np.arange(8 * 3, dtype=np.float32).reshape(8, 3),
             "y": {"z": np.arange(8, dtype=np.int64)}}
    sh = shard_batch(mesh, batch)
    out["x"], out["z"] = sh["x"].numpy(), sh["y"]["z"].numpy()
    out["passthrough"] = shard_batch(mesh, sh) is sh
    refusals = []
    for call in (lambda: shard_batch(mesh, {"x": np.zeros((3, 2))}),
                 lambda: create_mesh(mesh.world, ("data", "model")),
                 lambda: create_mesh(mesh.world + 1),
                 lambda: create_mesh(shape=(mesh.world, 1))):
        try:
            call()
            refusals.append(None)
        except ValueError as e:
            refusals.append(str(e))
    out["refusals"] = refusals
    # every rank starts from its own weights; replicate makes them rank 0's
    torch.manual_seed(100 + mesh.rank)
    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    net[1].running_mean.add_(mesh.rank)
    replicate(mesh, net)
    out["net"] = {k: v.numpy().copy() for k, v in net.state_dict().items()}
    return out


def rank_linear_sync(mesh, x, y):
    """tests/test_parallel.py's linear model: one SGD step (lr 0.1) on the
    squared error through ``data_parallel_jit``; (w, aux)."""
    net = Holder(torch.nn.Linear(4, 1, bias=False))
    torch.nn.init.zeros_(net.net.weight)
    state = TrainState(net, {"net": 0.1},
                       optimizer=lambda ps, lr: torch.optim.SGD(ps, lr))

    def step(state, batch):
        loss = torch.mean((net.net(batch["x"]) - batch["y"]) ** 2)
        state.apply_gradients(state.grads(loss, ("net",)))
        return state, {"aux": batch["x"].mean()}

    state, m = data_parallel_jit(step, mesh)(state, {"x": x, "y": y})
    return {"w": net.net.weight.detach().numpy().T.copy(),
            "aux": float(m["aux"])}


def batch_stats_norm_case(seed=0, B=4, C=3, H=5, W=6):
    """Inputs, the layer's scale and bias, and a loss weight."""
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(B, C, H, W).astype(np.float32) * 2 + 0.5,
            "scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
            "bias": rng.uniform(-0.5, 0.5, C).astype(np.float32),
            "w": rng.randn(B, C, H, W).astype(np.float32)}


def batch_stats_norm_step(case, mesh=None):
    """(y, d loss/d x, d loss/d (scale, bias)) of loss = mean(y * w) for
    ``BatchStatsNorm(per_sample=False)``: on the whole batch without a
    mesh, on this rank's shard with one. The sharded input gradient is
    scaled to the global loss's (1/world), the parameter gradients
    averaged over the ranks as ``TrainState.grads`` does."""
    norm = BatchStatsNorm(case["scale"].shape[0])
    with torch.no_grad():
        norm.scale.copy_(t(case["scale"]))
        norm.bias.copy_(t(case["bias"]))
    data = {"x": case["x"], "w": case["w"]}
    if mesh is not None:
        data = shard_batch(mesh, data)
    x = torch.as_tensor(data["x"]).clone().requires_grad_(True)
    with use_mesh(mesh):
        y = norm(x, per_sample=False)
        loss = torch.mean(y * torch.as_tensor(data["w"]))
        gx, gs, gb = torch.autograd.grad(loss, [x, norm.scale, norm.bias])
        if mesh is not None:
            gx = gx / mesh.world
            reduce_gradients([gs, gb], mesh)
    return {"y": y.detach().numpy(), "gx": gx.numpy(), "gs": gs.numpy(),
            "gb": gb.numpy()}


def bce_case(seed=0):
    """Four samples' features for a linear face-D stand-in; samples 0 and 1
    (rank 0's shard on 2 ranks) have faces, 2 and 3 (rank 1's) none."""
    rng = np.random.RandomState(seed)
    return {"f": rng.randn(4, 6).astype(np.float32),
            "w": rng.randn(6, 1).astype(np.float32) * 0.5,
            "target": np.ones((4, 1), np.float32),
            "valid": np.asarray([True, True, False, False])}


def bce_step(case, mesh=None, per_rank_mean=False):
    """(value, d/d features, d/d weights) of ``bce_masked(sigmoid(f @ w),
    target, valid)``; with a mesh the value is averaged over the ranks,
    the feature gradient scaled to the global value's and the weight
    gradient averaged (``TrainState``'s convention). ``per_rank_mean``
    computes each rank's shard as if it were alone: the wrong answer."""
    w = t(case["w"]).clone().requires_grad_(True)
    data = {k: case[k] for k in ("f", "target", "valid")}
    if mesh is not None:
        data = shard_batch(mesh, data)
    f = torch.as_tensor(data["f"]).clone().requires_grad_(True)
    with use_mesh(None if per_rank_mean else mesh):
        val = bce_masked(torch.sigmoid(f @ w), torch.as_tensor(
            data["target"]), torch.as_tensor(data["valid"]))
        gf, gw = torch.autograd.grad(val, [f, w])
    if mesh is not None:
        val = mesh.all_reduce(val.detach().clone()) / mesh.world
        gf = gf / mesh.world
        reduce_gradients([gw], mesh)
    return {"val": float(val.detach()), "gf": gf.numpy(), "gw": gw.numpy()}


def sgd_batch(batch=4, seed=0):
    """A global batch on the 6x6 quad mesh (two targets), with a ragged
    share of faces: the last sample's face box is empty, so on 2 ranks
    rank 0 holds 2 faces and rank 1 one, and one reference of sample 1 is
    masked out."""
    verts, _ = synthetic_quad_mesh(6)
    b = synthetic_batch(np.random.RandomState(seed), batch=batch, num_refs=2,
                        part_size=16, image_size=64,
                        num_verts=verts.shape[0], num_targets=2)
    b["prev_verts"] = np.tile(verts[None], (batch, 1, 1))
    b["tgt_verts"] = b["prev_verts"] + np.float32([0.05, 0.0, 0.0])
    b["ref_mask"][1] = np.float32([1, 0])
    b["face_bbox"][1] = np.float32([20.5, 44.5, 10.5, 30.5])
    b["face_bbox"][-1, 1] = b["face_bbox"][-1, 0]
    return b


def face_valid(batch):
    """Which samples of a batch have a face (the stage-3/4 face terms)."""
    return batch["face_bbox"][:, 1] > batch["face_bbox"][:, 0]


def stage_lrs(stage):
    """The modules ``stage`` trains."""
    from jafpro_tpu_torch.train import stage1, stage2, stage34

    return set({1: stage1.stage1_lrs, 2: stage2.stage2_lrs,
                3: stage34.stage3_lrs, 4: stage34.stage4_lrs}[stage]())


def sgd_pipeline(seeded=True, params=None):
    """The configuration's pipeline from the port's seed, or with the JAX
    param tree ``params`` of every module (bridged). ``seeded=False``
    skips the seeded initialisation (seconds on one core) and keeps
    torch's default one: for a rank whose weights ``replicate`` makes
    rank 0's, or that loads ``params``."""
    _, faces = synthetic_quad_mesh(6)
    cfg = Config(**SIZES)
    with contextlib.ExitStack() as stack:
        if not seeded or params is not None:
            stack.enter_context(mock.patch(
                "jafpro_tpu_torch.pipeline.init_params_", lambda *a: None))
        pipe = JAFProPipeline(cfg, flow_engine=SMPLFlowEngine(
            faces=faces, image_size=cfg.image_size), device="cpu",
            generator=torch.Generator().manual_seed(0))
    if params is not None:
        load_jax_params(pipe, params, ALL_MODULES)
    return pipe


def sgd_step(pipe, stage, batch, mesh=None):
    """One SGD step (lr ``SGD_LR``) of ``stage`` (the CLI's ``make_step``)
    on the global ``batch``: single-process without a mesh, through
    ``data_parallel_jit`` with one. Returns the trained modules' params
    before and after (``trained_params``), whether every other module stayed
    bitwise unchanged, and the metrics."""
    from jafpro_tpu_torch.cli import make_step

    step, lrs = make_step(pipe, stage)
    frozen = [p for n in ALL_MODULES if n not in lrs
              for p in getattr(pipe, n).parameters()]
    frozen_before = [p.detach().clone() for p in frozen]
    before = trained_params(pipe, lrs)
    state = TrainState(pipe, lrs,
                       optimizer=lambda ps, lr: torch.optim.SGD(ps, SGD_LR))
    if mesh is not None:
        state, m = data_parallel_jit(step, mesh)(state, batch)
    else:
        state, m = step(state, {k: t(v) for k, v in batch.items()})
    return {"before": before, "after": trained_params(pipe, lrs),
            "frozen_same": all(torch.equal(a, b)
                               for a, b in zip(frozen_before, frozen)),
            "metrics": {k: float(v) for k, v in m.items()}}


def reference(pipe, stage, batch):
    """What a sharded step is held to: the single-process step's update
    per param (after - before) and metrics."""
    r = sgd_step(pipe, stage, batch)
    return {"update": {k: r["after"][k] - r["before"][k] for k in r["after"]},
            "metrics": r["metrics"]}


def update_errors(before, after, ref_update):
    """Per module: how far this update (after - before) is from the
    reference update, in ``tests/_torch_train_pair.py::compare``'s terms:
    the largest entrywise difference, less two float32 ulps of the param
    (the resolution at which an update can be read off the params), over
    the largest entry of the module's reference update. (A conv bias
    before a batch-statistics norm has a gradient that is zero but for
    rounding: it is held to its module's scale, not its own.)"""
    err, scale = {}, {}
    for k, d_ref in ref_update.items():
        m = k.split(".")[0]
        d = after[k] - before[k]
        ulp = float(np.spacing(np.float32(before[k].abs().max())))
        e = max(float((d - d_ref).abs().max()) - 2 * ulp, 0.0)
        err[m] = max(err.get(m, 0.0), e)
        scale[m] = max(scale.get(m, 0.0), float(d_ref.abs().max()))
    return {m: err[m] / max(scale[m], 1e-30) for m in err}


def rank_sgd_check(mesh, stage, batch, params=None, jax_after=None):
    """One sharded SGD step of ``stage`` on the global ``batch`` from rank
    0's seeded (or the bridged ``params``) weights. Rank 0 then holds its
    update to its own single-process step on the whole batch from the
    same weights ("port") and, when given, to the JAX package's update,
    ``jax_after`` being the trained modules' params after it ("jax").
    Returns the metrics, the replica's digest, whether the untrained
    modules stayed unchanged, and rank 0's worst update error per module
    against each reference and the single-process step's metrics."""
    pipe = sgd_pipeline(mesh.rank == 0, params)
    replicate(mesh, pipe)
    start = {k: v.clone() for k, v in pipe.state_dict().items()}
    r = sgd_step(pipe, stage, batch, mesh)
    out = {"metrics": r["metrics"], "digest": state_digest(pipe),
           "frozen_same": r["frozen_same"], "errors": {}}
    if mesh.rank:
        return out
    refs = {}
    if jax_after is not None:
        pipe.load_state_dict(start)
        load_jax_params(pipe, jax_after, list(jax_after))
        jax_trained = trained_params(pipe, list(jax_after))
        refs["jax"] = {k: v - r["before"][k] for k, v in jax_trained.items()}
    pipe.load_state_dict(start)
    port = reference(pipe, stage, batch)
    refs["port"] = port["update"]
    out["port_metrics"] = port["metrics"]
    out["errors"] = {name: update_errors(r["before"], r["after"], ref)
                     for name, ref in refs.items()}
    return out


# ------------------------------------------------------ the CLI over ranks

def shard_of_interval_records(path, n=6, num_refs=2, image_size=64,
                              part_size=16, seed=0):
    """Synthetic stage-3/4 records at the CLI's --synthetic dimensions."""
    rng = np.random.RandomState(seed)
    verts, _ = synthetic_quad_mesh(6)
    spec = shardio.interval_spec(num_refs=num_refs, image_size=image_size,
                                 part_size=part_size,
                                 num_verts=verts.shape[0])

    def gen():
        for _ in range(n):
            b = synthetic_batch(rng, batch=1, num_refs=num_refs,
                                part_size=part_size, image_size=image_size,
                                num_verts=verts.shape[0])
            rec = {}
            for name, shape, dtype in spec:
                if name == "src_imgs":
                    v = np.repeat(b["prev_img"], num_refs, axis=0)
                elif name == "src_cams":
                    v = np.repeat(b["prev_cam"], num_refs, axis=0)
                elif name == "src_verts":
                    v = np.repeat(verts[None], num_refs, axis=0)
                else:
                    v = b[name]
                v = np.asarray(v, np.float32).reshape(shape)
                if dtype == "uint8":
                    v = shardio.encode_field_u8(name, v)
                rec[name] = np.asarray(v, dtype)
            rec["tgt_verts"] = verts[None] + np.float32([0.02, 0, 0])
            yield rec

    return shardio.pack_shard(spec, gen(), str(path))


CKPT = os.path.join("checkpoints", "exp_sh")


def setup_shards(tmp_path, monkeypatch):
    """In ``tmp_path``: 6 packed interval records; the ``train`` command
    line of stage 4 on them at the synthetic size, global batch 2."""
    monkeypatch.chdir(tmp_path)
    for var in ("JAFPRO_DATA_ROOT", "JAFPRO_SMPL_ROOT", "JAFPRO_MASK_ROOT"):
        monkeypatch.delenv(var, raising=False)
    shards = tmp_path / "shards"
    shards.mkdir()
    assert shard_of_interval_records(shards / "train-00000.shard") == 6
    return ["train", "--stage", "4", "--synthetic", "-n", "exp_sh",
            "--batch-size", "2", "--shards", str(shards), "--device", "cpu"]


def check_rows(iters):
    """``losses.jsonl`` holds one row per step of ``iters`` (rank 0 writes
    it alone), with finite global metrics."""
    with open(os.path.join(CKPT, "losses.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["iter"] for r in rows] == list(iters)
    for r in rows:
        assert set(r) >= {"loss", "recon", "G", "FG", "D", "FD"}
        assert all(np.isfinite(r[k]) for k in ("loss", "D", "FD"))


# ------------------------------------------------- generate_batch over ranks

GEN = dict(image_size=32, part_size=16, num_parts=4, maximum_ref_frames=2,
           compute_dtype="float32")   # tests/test_torch_port_batch.py's
GEN_T = 4


def gen_clip(seed):
    """A seeded clip at ``GEN``'s sizes on ``uv_sphere(8, 10)``."""
    from jafpro_tpu_torch.utils.meshproxy import uv_sphere

    S, p, P, R, T = 32, 16, 4, 2, GEN_T
    verts0, _ = uv_sphere(8, 10)
    rng = np.random.RandomState(seed)
    verts = (verts0[None] * np.float32([0.35, 0.9, 0.35])
             + rng.normal(scale=0.02, size=(T, 1, 3))).astype(np.float32)
    verts[..., 2] += 2.0
    iuv = np.zeros((T, S, S, 3), np.uint8)
    iuv[..., 0] = rng.randint(0, P + 1, (T, S, S))
    iuv[..., 1:] = rng.randint(0, 256, (T, S, S, 2))
    cams = np.tile(np.float32([[1.0, 0.0, 0.0]]), (T, 1))
    cams[:, 1:] += rng.uniform(-0.05, 0.05, (T, 2)).astype(np.float32)
    return {
        "src_parts": rng.randint(0, 256, (1, R, P, p, p, 3)).astype(np.uint8),
        "src_mask_parts": (rng.rand(1, R, P, p, p) > 0.5).astype(
            np.uint8) * 255,
        "ref_mask": np.ones((1, R), np.float32),
        "bg_incomplete": rng.uniform(-1, 1, (1, S, S, 3)).astype(np.float32),
        "src_imgs": rng.randint(0, 256, (R, S, S, 3)).astype(np.uint8),
        "chosen_frames": np.array(sorted(rng.choice(T, R, replace=False)),
                                  np.int32),
        "tgt_iuv255": iuv,
        "smpl_mask": (rng.rand(T, S, S, 1) > 0.2).astype(np.uint8) * 255,
        "cams": cams,
        "verts": verts,
    }


def rank_generate_batch(mesh, clips):
    """``generate_batch(stack_clips(clips), mesh)`` against each of this
    rank's round-robin clips generated alone: (the result's shape, its
    digest, the largest difference)."""
    import hashlib

    from jafpro_tpu_torch.infer import VideoGenerator, stack_clips
    from jafpro_tpu_torch.utils.meshproxy import uv_sphere

    with contextlib.ExitStack() as stack:
        if mesh.rank:  # rank 0's weights come by replicate
            stack.enter_context(mock.patch(
                "jafpro_tpu_torch.pipeline.init_params_", lambda *a: None))
        pipe = JAFProPipeline(Config(**GEN), flow_engine=SMPLFlowEngine(
            faces=uv_sphere(8, 10)[1], image_size=32), device="cpu")
    replicate(mesh, pipe)
    gen = VideoGenerator(pipe, frame_batch=GEN_T, flow_mode="batch")
    out = gen.generate_batch(stack_clips(clips), mesh)
    diff = 0.0
    for i in range(mesh.rank, len(clips), mesh.world):
        single = gen(clips[i])
        diff = max(diff, max(float((out[k][i] - single[k]).abs().max())
                             for k in single))
    h = hashlib.sha256()
    for k in sorted(out):
        h.update(out[k].contiguous().view(torch.uint8).numpy())
    return {"shape": tuple(out["final"].shape), "digest": h.hexdigest(),
            "diff": diff}


def rank_units(mesh, inputs):
    """Every small check of ``tests/test_torch_port_parallel.py`` on one
    set of ranks (one start-up for all of them)."""
    return {"basics": rank_mesh_basics(mesh),
            "linear": rank_linear_sync(mesh, *inputs["linear"]),
            "norm": batch_stats_norm_step(inputs["norm"], mesh),
            "bce": {"global": bce_step(inputs["bce"], mesh),
                    "per_rank_mean": bce_step(inputs["bce"], mesh,
                                              per_rank_mean=True)},
            "generate": rank_generate_batch(mesh, inputs["clips"])}
