"""The one general frame generator: it reads a traffic mix (a data file
under traffic/) and drives the program one frame at a time, as an
interactive viewer renders them.

A mix lists the steps of its frame, in order, with their parameters.
Each step is a module steps/<name>.py, found by its name, which drives
the program through its public entry points and contributes its part of
the comparison that decides `correct` (judge.py). A step module has
- run(drv, fr, st): the step of one frame. `fr` holds the frame's inputs
  and the outputs the check judges; `st` what later steps of the same
  frame take from it (the deformed triangles, the primary hits);
and may have
- inputs(mix, seed, index): the frame's own inputs drawn from the seed
  (a deform's time, an AO generator's seed), for the run and the check;
- prepare(drv): set-up before the session is made; it may set
  drv.tris (the triangles of the cold build) and drv.margin (the
  packet grid's bbox margin), and keep what run() needs in
  drv.state[<its name>];
- traces(drv): (rays, triangles) of each trace the step makes a frame;
- NUMBERS and check(ctx, fr): its numbers of the comparison (judge.py).
Every frame ends with the session's overflow poll at the frame boundary,
which regrows a budget that overflowed, and a synchronise.

The program is imported here and nowhere else in the harness: a step
reaches it through the driver (drv.session, drv.program(name)).
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import importlib.util
import pathlib

import torch

import frozen
import guard

STEPS = pathlib.Path(__file__).resolve().parent / "steps"


@functools.cache
def step(name: str):
    """The module of step `name` (steps/<name>.py)."""
    path = STEPS / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no step {name!r}: {path} is not there")
    spec = importlib.util.spec_from_file_location(
        f"bench_step_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def frame_inputs(mix: dict, seed: int, index: int) -> dict:
    """Frame `index`'s inputs drawn from the seed, by each step."""
    fr = {"index": index}
    for name in mix["steps"]:
        draw = getattr(step(name), "inputs", None)
        if draw is not None:
            fr.update(draw(mix, seed, index))
    return fr


class Driver:
    """The program set up for one cell: the session and the camera's
    rays, with what each step prepared; `frame(i)` runs frame i and
    returns what it produced."""

    def __init__(self, config: dict, mix: dict, inputs: dict, seed: int,
                 device):
        from hagrid_tpu_torch.core.camera import Camera, primary_rays
        from hagrid_tpu_torch.core.types import Triangles
        from hagrid_tpu_torch.ops import sweep_kernel, wavefront
        from hagrid_tpu_torch.render.session import RenderSession
        from hagrid_tpu_torch.utils.config import BuildParams

        self.mix, self.seed, self.dev = mix, seed, torch.device(device)
        self.steps = [(name, step(name)) for name in mix["steps"]]
        self.counters = (sweep_kernel.launches, wavefront.launches)
        self.wavefront = wavefront
        self.verts, self.faces = inputs["verts"], inputs["faces"]
        self.extent = self.verts.max(0) - self.verts.min(0)
        w, h = config["width"], config["height"]
        cam = inputs["camera"]
        self.rays = primary_rays(
            Camera(eye=cam["eye"], center=cam["center"], up=cam["up"],
                   fov_deg=cam["fov_deg"]), w, h, order="block",
            device=self.dev)
        self.n_rays, self.n_tris = w * h, len(self.faces)
        self.tris, self.margin, self.state = None, 0.0, {}
        for _, s in self.steps:
            if hasattr(s, "prepare"):
                s.prepare(self)
        if self.tris is None:
            self.tris = Triangles.from_mesh(self.verts, self.faces,
                                            device=self.dev)
        self.session = RenderSession.create(
            self.tris, BuildParams(**config["build_params"]),
            structure=config["structure"], verts=self.verts,
            bbox_margin=self.margin)
        self.grid_flags = [frozen.grid_overflow_flag(self.session)]

    @staticmethod
    def program(name: str):
        """The program's module `name` (e.g. "render.integrators")."""
        return importlib.import_module(f"{guard.PROGRAM}.{name}")

    def frame(self, index: int, span=None) -> dict:
        """Run frame `index`; span(name) wraps each step (the traced
        run's CUDA events and profiler ranges). Returns the frame's
        inputs and outputs and whether the program reported it
        incomplete."""
        span = span or (lambda name: contextlib.nullcontext())
        fr = frame_inputs(self.mix, self.seed, index)
        st = {}
        truncated = self.wavefront.trace_totals["truncated_rays"]
        for name, s in self.steps:
            with span(name):
                s.run(self, fr, st)
        with span("poll"):
            failed = self.session.poll_overflow()
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
        failed |= self.wavefront.trace_totals["truncated_rays"] > truncated
        fr["failed"] = bool(failed)
        return fr

    def traces(self) -> list:
        """(rays, triangles) of each trace a frame makes."""
        return [t for _, s in self.steps if hasattr(s, "traces")
                for t in s.traces(self)]

    def launches(self) -> dict:
        return {k: v for c in self.counters for k, v in c.items()}

    def grid_failed(self) -> list:
        """The grid's own overflow after each build, read once."""
        return torch.stack(self.grid_flags).tolist()

    def close(self):
        """Free the program's state (the session, its graphs and grids)."""
        self.session = self.rays = self.tris = None
        self.state, self.grid_flags = {}, []
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()
