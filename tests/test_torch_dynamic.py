"""PyTorch port, dynamic scenes: wave_deform, AnimatedScene, animate and
the session's reference signature, against hagrid_tpu.render.dynamic on
the same numpy meshes.

wave_deform agrees to atol 4e-6 (one ulp of y <= 15 plus sin's; the
compiled reference also folds its constant factors). So that an ulp cannot
move a triangle across a cell face, the build comparison feeds the
JAX-deformed vertices to both packages: integer tables must then be
equal, float tables close, and hits follow tests/test_sweep_trace.py's
_check against the reference oracle.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sweep_trace import _check as check_hits
from test_torch_packet import assert_grids_equal

from hagrid_tpu import oracle as j_oracle
from hagrid_tpu import scenes as j_scenes
from hagrid_tpu.core.camera import Camera as JCamera
from hagrid_tpu.core.camera import primary_rays as j_primary_rays
from hagrid_tpu.core.types import Triangles as JTris
from hagrid_tpu.render import dynamic as j_dynamic
from hagrid_tpu.render.session import RenderSession as JRenderSession
from hagrid_tpu.utils.config import BuildParams as JBuildParams
from hagrid_tpu_torch import interop
from hagrid_tpu_torch.core.types import Triangles
from hagrid_tpu_torch.render import dynamic
from hagrid_tpu_torch.render.session import RenderSession
from hagrid_tpu_torch.utils.config import BuildParams

CPU = "cpu"
# The unit-sized soup needs a smaller, faster wave than the default, which
# is sized for a 30 x 15 x 12 hall.
SOUP_WAVE = dict(amplitude=0.05, freq=6.0)


@pytest.mark.parametrize("mesh,kw", [
    ("sponza_4k", {}),
    ("soup", SOUP_WAVE),
    ("soup3", dict(amplitude=0.2, freq=0.3)),
])
def test_wave_deform_matches_reference(mesh, kw):
    v = {"sponza_4k": lambda: j_scenes.sponza_like(4096),
         "soup": lambda: j_scenes.random_soup(400, seed=1),
         "soup3": lambda: j_scenes.random_soup(300, seed=3)}[mesh]()[0]
    assert np.abs(v[:, 1]).max() <= 15
    for time in (0.0, 0.1, 0.73, 12.5):
        want = np.asarray(j_dynamic.wave_deform(
            jnp.asarray(v), jnp.float32(time), **kw))
        tv = torch.as_tensor(v)
        got = dynamic.wave_deform(tv, time, **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4e-6)
        # A 0-d tensor as time takes the same f32 arithmetic.
        got_t = dynamic.wave_deform(tv, torch.tensor(time), **kw)
        np.testing.assert_allclose(got_t.numpy(), got.numpy(), rtol=0,
                                   atol=4e-6)
        # x and z pass through, and the argument is left as it was.
        np.testing.assert_array_equal(got.numpy()[:, [0, 2]], v[:, [0, 2]])
        np.testing.assert_array_equal(tv.numpy(), v)
    assert np.abs(want[:, 1] - v[:, 1]).max() > 0.3 * kw.get("amplitude",
                                                             0.25)


def _soup_rays():
    cam = JCamera(eye=(0.5, 0.5, 3.0), center=(0.5, 0.5, 0.5), fov_deg=40)
    jr = j_primary_rays(cam, 32, 32, order="block")
    rays = interop.rays_from_numpy(jr.org, jr.dir, jr.tmin, jr.tmax,
                                   device=CPU)
    return jr, rays


def test_dynamic_frames_match_reference():
    """Three frames of a warm session with a motion margin: both packages
    rebuild on the JAX-deformed vertices."""
    v, f = j_scenes.random_soup(400, seed=1)
    j_deform = functools.partial(j_dynamic.wave_deform, **SOUP_WAVE)
    j_scene = j_dynamic.AnimatedScene(v, f, deform=j_deform)
    margin = float(0.06 / (v.max(0) - v.min(0)).min())
    js = JRenderSession.create(j_scene.frame(0.0), JBuildParams.dynamic(),
                               "packet", verts=v, bbox_margin=margin)
    first = np.array(j_deform(jnp.asarray(v), jnp.float32(0.0)))
    s = RenderSession.create(Triangles.from_mesh(first, f, device=CPU),
                             BuildParams.dynamic(), "packet", verts=v,
                             bbox_margin=margin)
    assert s.params == BuildParams.dynamic()
    assert s.params.levels == js.params.levels == 2
    assert_grids_equal(s.grid, js.grid)
    jr, rays = _soup_rays()
    n_hits = []
    for time in (0.1, 0.2, 0.3):
        jt = j_scene.frame(time)
        jv = np.array(j_deform(jnp.asarray(v), jnp.float32(time)))
        tris = Triangles.from_mesh(jv, f, device=CPU)
        np.testing.assert_array_equal(tris.v0.numpy(), np.asarray(jt.v0))
        assert int(js.rebuild(jt)) == int(s.rebuild(tris))
        assert_grids_equal(s.grid, js.grid)
        assert not bool(s.grid.overflowed)
        hits = s.trace(rays, coherent=True)
        check_hits(hits, j_oracle.closest_hit(jr, jt))
        n_hits.append(int((hits.tri_id >= 0).sum()))
    assert min(n_hits) > 100
    assert len(s._bmax_cal) == 1          # calibrated once, then warm
    assert not s.poll_overflow(recalibrate=False)


def test_animate_yields_reference_total_refs():
    """The port's own deformation through animate(): the same total_refs
    per frame as the reference's loop."""
    v, f = j_scenes.random_soup(400, seed=1)
    margin = float(0.06 / (v.max(0) - v.min(0)).min())
    deform = functools.partial(dynamic.wave_deform, **SOUP_WAVE)
    scene = interop.animated_scene_from_numpy(v, f, device=CPU)
    scene.deform = deform
    j_scene = j_dynamic.AnimatedScene(v, f, deform=functools.partial(
        j_dynamic.wave_deform, **SOUP_WAVE))
    s = RenderSession.create(scene.frame(0.0), verts=v, bbox_margin=margin)
    js = JRenderSession.create(j_scene.frame(0.0), verts=v,
                               bbox_margin=margin)
    times = [0.05 * k for k in range(1, 5)]
    got = [(t, int(n)) for t, n in dynamic.animate(s, scene, times)]
    want = [(t, int(n)) for t, n in j_dynamic.animate(js, j_scene, times)]
    assert got == want
    assert len({n for _, n in got}) > 1     # the geometry did move
    assert scene.base_vertices.dtype == torch.float32
    assert scene.faces.shape == (400, 3)


def test_create_takes_the_reference_signature():
    """create(tris, params, "packet"), as callers of the reference write
    it, in both packages."""
    v, f = j_scenes.cornell_box()
    jp, p = JBuildParams(), BuildParams()
    js = JRenderSession.create(JTris.from_mesh(v, f), jp, "packet")
    tris = Triangles.from_mesh(v, f, device=CPU)
    s = RenderSession.create(tris, p, "packet")
    assert s.params is p and js.params is jp
    assert s.structure == js.structure == "packet"
    assert_grids_equal(s.grid, js.grid)
    assert RenderSession.create(tris).params == BuildParams()
    for a, b in ((p, jp), (BuildParams.dynamic(), JBuildParams.dynamic())):
        assert {k: getattr(a, k) for k in a.__dataclass_fields__} == \
            {k: getattr(b, k) for k in b.__dataclass_fields__}
    with pytest.raises(ValueError):
        RenderSession.create(tris, p, "bvh")


def test_animated_scene_defaults_to_the_card():
    v, f = j_scenes.cornell_box()
    if torch.cuda.is_available():
        assert dynamic.AnimatedScene(v, f).base_vertices.is_cuda
    else:
        with pytest.raises(RuntimeError):
            dynamic.AnimatedScene(v, f)
    # A CPU tensor keeps its device.
    scene = dynamic.AnimatedScene(torch.as_tensor(v), f)
    assert scene.frame(0.25).v0.device.type == "cpu"
