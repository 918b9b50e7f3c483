"""The system under test, built as its entry points build it: the port's
``JAFProPipeline`` at the configuration's widths on the run's device, its
parameters filled from the run's seed on that device (``weights.fill``),
and the SMPL flow engine on the traffic's mesh.

The pipeline's own constructor draws every leaf from a host generator
(seconds at these widths); here the modules are made on the device and the
benchmark's seeded values replace the draw.
"""

from __future__ import annotations

import dataclasses
from unittest import mock

import torch

from benchmark import traffic, weights


def program_config(cfg: dict):
    """The port's ``Config`` with the configuration file's values."""
    from jafpro_tpu_torch.config import Config

    names = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in cfg.items() if k in names})


def build_pipeline(run):
    import jafpro_tpu_torch.pipeline as pipeline
    from jafpro_tpu_torch.geometry.flow import SMPLFlowEngine

    pcfg = program_config(run.cfg)
    _, faces = traffic.mesh(run.cfg)
    engine = SMPLFlowEngine.create(
        faces=faces, image_size=pcfg.image_size, near=pcfg.near,
        far=pcfg.far, viewing_angle=pcfg.viewing_angle)
    with torch.device(run.device), mock.patch.object(
            pipeline, "init_params_", lambda module, generator: module):
        pipe = pipeline.JAFProPipeline(pcfg, flow_engine=engine,
                                       device=run.device)
    weights.fill(pipe, run.seed)
    return pipe, pcfg


def reference_faces(run) -> torch.Tensor:
    return torch.as_tensor(traffic.mesh(run.cfg)[1], dtype=torch.long,
                           device=run.device)


def free_program(state: dict) -> None:
    """Drop the program's state (the driver's ``state`` holds all of it)
    and give its memory back before the reference runs."""
    import gc

    state.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
