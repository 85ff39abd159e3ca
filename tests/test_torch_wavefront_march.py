"""PyTorch port, the wavefront trace: `trace_plain` (the plain version of
csrc/wavefront.cu's march kernel: the reference's rounds of
`segment_plain`) against the JAX package's `trace`, `trace` on CPU
tensors, and the march kernel's safety cap.

Inputs are test_torch_wavefront_segment.py's: the reference's grids
(Cornell and random_soup(150, seed=0); the irregular grid in quad rows and
per row, the uniform grid) carried across with `interop`, and the same
rays in both packages. Against the compiled reference, tri ids, the round
count, the truncated rays (0) and the mean steps are equal, and t, u and v
agree to rtol 1e-5 and atol 1e-5: the compiled program contracts a
product and a sum into one FMA on the CPU, which moves best_u, a
cancelling sum over det, by up to 8.3e-7 absolute on these inputs and no
integer (test_torch_wavefront_segment.py holds `segment_plain` bit for bit
against the reference run op by op).
"""

import jax.numpy as jnp
import pytest
import torch
from test_torch_wavefront_segment import KINDS, SCENES, grids  # noqa: F401

from hagrid_tpu.ops import wavefront as j_wavefront
from hagrid_tpu_torch.ops import wavefront


def _j_trace(c, any_hit):
    h = j_wavefront.trace(c["jg"], c["jl"], c["jr"], any_hit=any_hit)
    return h, dict(j_wavefront.last_trace_stats)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("scene", SCENES)
def test_trace_plain_equals_reference_trace(grids, scene, kind,  # noqa: F811
                                            any_hit):
    c = grids[scene, kind]
    want, want_stats = _j_trace(c, any_hit)
    steps = torch.zeros(c["rays"].count, dtype=torch.int32)
    got = wavefront.trace_plain(c["g"], c["lk"], c["rays"], any_hit=any_hit,
                                steps=steps)
    stats = dict(wavefront.last_trace_stats)
    assert torch.equal(got.tri_id, torch.as_tensor(want.tri_id.__array__()))
    for k in ("t", "u", "v"):
        torch.testing.assert_close(
            getattr(got, k), torch.as_tensor(getattr(want, k).__array__()),
            rtol=1e-5, atol=1e-5, msg=k)
    assert stats["truncated_rays"] == want_stats["truncated_rays"] == 0
    assert stats["rounds"] == want_stats["rounds"]
    assert stats["mean_steps"] == want_stats["mean_steps"]
    assert float(steps.sum()) / c["rays"].count == stats["mean_steps"]


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("kind", KINDS)
def test_trace_on_cpu_is_trace_plain(grids, kind, any_hit):  # noqa: F811
    """On CPU tensors `trace` runs trace_plain with the reference's round
    arguments (coherent, the kernel's refill choice, changes nothing):
    the same bits, steps and stats, and no kernel launch."""
    c = grids["soup150", kind]
    before = dict(wavefront.launches)
    args = (c["g"], c["lk"], c["rays"], 2, any_hit, 16, 64)
    s1 = torch.zeros(c["rays"].count, dtype=torch.int32)
    got = wavefront.trace(*args, coherent=True, steps=s1)
    got_stats = dict(wavefront.last_trace_stats)
    s2 = torch.zeros_like(s1)
    want = wavefront.trace_plain(*args, steps=s2)
    assert got_stats == wavefront.last_trace_stats
    assert got_stats["rounds"] > 1
    assert torch.equal(got.tri_id, want.tri_id) and torch.equal(s1, s2)
    for k in ("t", "u", "v"):
        assert torch.equal(getattr(got, k).view(torch.int32),
                           getattr(want, k).view(torch.int32)), k
    assert wavefront.launches == before


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("scene", SCENES)
def test_device_hard_cap_equals_max_march_iters(grids, scene,  # noqa: F811
                                                kind):
    """The kernel computes hard_cap = cap_base + 8 * (max cell refs /
    max(refs_per_iter, 1)) from its argument block and the device scalar
    it points to (C's division truncates, as // floors on these
    non-negative counts): equal to max_march_iters for each
    refs_per_iter, and to the round loop's cap."""
    c = grids[scene, kind]
    g = c["g"]
    starts = g.cell_starts
    max_refs = int((starts[1:] - starts[:-1]).max())
    for rpi in (0, 1, 2, 3, 8):
        _, a, _, _, keep = wavefront.march_args(g, c["lk"], c["rays"], rpi)
        m = next(x for x in keep if x.data_ptr() == a.max_cell_refs)
        assert m.dtype == torch.int32 and m.dim() == 0
        assert int(m) == max_refs
        cap = a.cap_base + 8 * (int(m) // max(a.refs_per_iter, 1))
        assert cap == wavefront.max_march_iters(g.fine_dims, max_refs, rpi)
        assert cap == j_wavefront.max_march_iters(
            g.fine_dims, int(jnp.max(c["jg"].cell_starts[1:]
                                     - c["jg"].cell_starts[:-1])), rpi)


def test_march_args_check_types_shapes_devices(grids):  # noqa: F811
    """march_args raises, before any launch, on a lookup the kernel does
    not know, a device that is neither CUDA nor CPU, rays, tables, steps
    or work counters of the wrong type, shape or device, and a refill
    threshold outside 1..32."""
    c = grids["cornell", "quad"]
    g, lk, r = c["g"], c["lk"], c["rays"]
    Rays = type(r)
    before = dict(wavefront.launches)
    # (A packed grid answers its lookup from its tables, whatever the
    # lookup; a uniform grid needs uniform_lookup.)
    cases = [
        ((grids["cornell", "uniform"]["g"], lambda grid, vox: None, r), {},
         "no lookup"),
        ((g, lk, Rays(*(getattr(r, k).to("meta")
                        for k in ("org", "dir", "tmin", "tmax")))), {},
         "CUDA or CPU"),
        ((g, lk, Rays(r.org, r.dir.double(), r.tmin, r.tmax)), {},
         "rays.dir"),
        ((g, lk, Rays(r.org, r.dir, r.tmin[:-1], r.tmax)), {}, "rays.tmin"),
        ((g, lk, Rays(r.org[:, :2], r.dir, r.tmin, r.tmax)), {},
         "rays.org"),
        ((g.replace(erec=g.erec.long()), lk, r), {}, "grid table"),
        ((g, lk, r), dict(steps=torch.zeros(r.count, dtype=torch.int64)),
         "steps"),
        ((g, lk, r), dict(steps=torch.zeros(r.count + 1, dtype=torch.int32)),
         "steps"),
        ((g, lk, r), dict(work=torch.zeros(4, dtype=torch.int64)), "work"),
        ((g, lk, r), dict(refill=0), "refill"),
        ((g, lk, r), dict(refill=33), "refill"),
    ]
    for args, kw, match in cases:
        with pytest.raises(ValueError, match=match):
            wavefront.march_args(*args, 2, **kw)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        wavefront.trace(g, lk, cases[1][0][2])
    assert wavefront.launches == before
