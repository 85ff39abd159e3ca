"""PyTorch port, diffuse path tracing from given primary hits
(`render/integrators.py::path_bounces`) on the CPU at the Cornell box's
size, against the benchmark's plain reference (`benchmark/
reference_path.py`: brute-force bounces in plain PyTorch) fed the same
draws: the radiance is equal on every pixel. path_trace's own image
against the JAX package is tests/test_torch_reference_options.py's.
"""

import pathlib
import sys

import pytest
import torch

from hagrid_tpu_torch import scenes
from hagrid_tpu_torch.core.camera import primary_rays
from hagrid_tpu_torch.core.types import Triangles
from hagrid_tpu_torch.render import integrators
from hagrid_tpu_torch.render.session import RenderSession

BENCH = pathlib.Path(__file__).resolve().parent.parent / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import reference  # noqa: E402
import reference_path  # noqa: E402

SIZE = 32
SEED = 2**31 + 5


@pytest.fixture(scope="module")
def cornell():
    v, f = scenes.cornell_box()
    s = RenderSession.create(Triangles.from_mesh(v, f, device="cpu"),
                             verts=v)
    rays = primary_rays(scenes.cornell_camera(), SIZE, SIZE, order="block",
                        device="cpu")
    hits = s.trace(rays, coherent=True)
    tris = reference.triangles(torch.from_numpy(v), torch.from_numpy(f))
    return s, rays, hits, tris


@pytest.mark.parametrize("max_bounces,albedo", [(4, 0.7), (3, 0.5)])
def test_path_bounces_equal_the_plain_reference(cornell, max_bounces,
                                                albedo):
    """Every pixel's radiance equals the reference's, which bounces from
    the same primary hits with the same uniforms (one torch.rand((2, n))
    a wave from a generator seeded alike) and traces each wave against
    every triangle."""
    s, rays, hits, tris = cornell
    n = rays.count
    got = integrators.path_bounces(
        s, rays, hits, torch.Generator().manual_seed(SEED),
        max_bounces=max_bounces, sky=1.0, albedo=albedo)
    gen = torch.Generator().manual_seed(SEED)
    draws = [torch.rand((2, n), generator=gen) for _ in range(max_bounces)]
    want = reference_path.radiance(rays.org, rays.dir, hits.tri_id, hits.t,
                                   tris, draws, max_bounces, 1.0, albedo)
    assert not s.poll_overflow(recalibrate=False)
    assert torch.equal(got, want)
    # Paths that escape after a bounce, and paths still alive at the end.
    levels = set(got.unique().tolist())
    assert float(torch.tensor(albedo)) in levels and 0.0 in levels
    assert len(levels) >= 3


def test_path_bounces_of_one_wave_see_only_the_sky(cornell):
    """max_bounces=1: the sky on the primary misses, nothing on hits, and
    one draw taken (the next draw of the generator is its second)."""
    s, rays, hits, _ = cornell
    gen = torch.Generator().manual_seed(SEED)
    got = integrators.path_bounces(s, rays, hits, gen, max_bounces=1,
                                   sky=2.0)
    assert torch.equal(got, torch.where(hits.tri_id >= 0, 0.0, 2.0))
    ref_gen = torch.Generator().manual_seed(SEED)
    torch.rand((2, rays.count), generator=ref_gen)
    assert torch.equal(torch.rand(4, generator=gen),
                       torch.rand(4, generator=ref_gen))
