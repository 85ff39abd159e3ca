"""PyTorch port on the card: the CUDA sweep kernel against its plain
version, and a traced frame against the oracle, all on an NVIDIA GPU.

These tests skip without a GPU (the CUDA kernel has no CPU mode). The
module imports no JAX, so it also runs on a machine without it; there,
skip the suite's conftest (which sets JAX up):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from hagrid_tpu_torch import oracle, scenes
from hagrid_tpu_torch.core.camera import primary_rays
from hagrid_tpu_torch.core.types import Triangles
from hagrid_tpu_torch.grid.packet import build_packet, rays_to_x
from hagrid_tpu_torch.ops.sweep_kernel import sweep_blocks, sweep_blocks_plain
from hagrid_tpu_torch.render.session import RenderSession


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _stream(grid, device, nt=6, tile=512, seed=0):
    """Random rays through the scene box, 0-3 blocks per tile, unused
    blocks at the end, never-skip and random early-out thresholds."""
    rng = np.random.default_rng(seed)
    n = (nt + 1) * tile
    lo, hi = grid.bbox_lo.cpu().numpy(), grid.bbox_hi.cpu().numpy()
    org = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    xt = rays_to_x(t(org), t(d), t(np.zeros(n, np.float32)),
                   t(np.full(n, np.inf, np.float32))).t().contiguous()
    seed_t = np.where(rng.random(n) < 0.2, -3e38, 3e38).astype(np.float32)
    seed_t[nt * tile:] = -3e38
    xt[14] = t(seed_t)
    tile_of = np.concatenate([np.repeat(np.arange(nt), [2, 0, 3, 1, 1, 2]),
                              [nt] * 5]).astype(np.int32)
    nb = tile_of.size
    gidx = rng.integers(0, grid.cols.shape[0] // 4, nb * 32)
    thr = rng.uniform(0, 800, nb).astype(np.float32).view(np.int32)
    tminb = np.where(rng.random(nb) < 0.6, 0, thr)
    return (xt, grid.cols, t(gidx.astype(np.int32)), t(tile_of),
            t(tminb.astype(np.int32)), tile)


@pytest.mark.gpu
def test_sweep_kernel_matches_plain_on_card(cuda):
    v, f = scenes.cornell_box()
    grid = build_packet(Triangles.from_mesh(v, f, device=cuda),
                        dims=(6, 6, 6))
    args = _stream(grid, cuda)
    before = sweep_blocks.launches
    got = sweep_blocks(*args)
    torch.cuda.synchronize()
    assert sweep_blocks.launches == before + 1
    want = sweep_blocks_plain(*args)
    assert int((got[1] >= 0).sum()) > 50
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_session_trace_on_card_matches_oracle(cuda):
    v, f = scenes.cornell_box()
    tris = Triangles.from_mesh(v, f, device=cuda)
    s = RenderSession.create(tris, verts=v)
    rays = primary_rays(scenes.cornell_camera(), 64, 64, order="block",
                        device=cuda)
    before = sweep_blocks.launches
    hits = s.trace(rays, coherent=True)
    assert sweep_blocks.launches > before
    ref = oracle.closest_hit(rays, tris)
    # tests/test_sweep_trace.py::_check's thresholds.
    both = (hits.tri_id >= 0) & (ref.tri_id >= 0)
    assert ((hits.tri_id >= 0) == (ref.tri_id >= 0)).float().mean() > 0.999
    same = both & (hits.tri_id == ref.tri_id)
    assert same.sum() > 0.995 * both.sum()
    torch.testing.assert_close(hits.t[same], ref.t[same], rtol=1e-3,
                               atol=1e-5)
    assert not s.poll_overflow(recalibrate=False)
