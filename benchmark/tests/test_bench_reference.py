"""The plain reference on hand-built rays whose hits are known."""

import math

import torch

import reference as ref


def _tris():
    # Two unit right triangles in the planes z = 2 and z = 5, facing -z.
    v0 = torch.tensor([[0.0, 0.0, 2.0], [0.0, 0.0, 5.0]])
    e1 = torch.tensor([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    e2 = torch.tensor([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
    return {"v0": v0, "e1": e1, "e2": e2}


def _rays():
    org = torch.tensor([[0.2, 0.2, 0.0],    # hits both: the first at t=2
                        [0.9, 0.9, 0.0],    # outside both triangles
                        [0.2, 0.2, 3.0],    # starts between: t=2 to z=5
                        [0.2, 0.2, 6.0]])   # points away from both
    d = torch.tensor([[0.0, 0.0, 1.0]] * 4)
    return org, d


def test_closest_hit_takes_the_nearest_triangle():
    org, d = _rays()
    tri, t = ref.closest_hit(org, d, _tris())
    assert tri.tolist() == [0, -1, 1, -1]
    assert t[0].item() == 2.0 and t[2].item() == 2.0
    assert math.isinf(t[1].item()) and math.isinf(t[3].item())


def test_ties_go_to_the_smaller_id():
    tris = _tris()
    tris = {k: torch.cat([v[1:], v[:1], v[:1]]) for k, v in tris.items()}
    org, d = _rays()
    tri, t = ref.closest_hit(org[:1], d[:1], tris)
    assert tri.tolist() == [1] and t.item() == 2.0


def test_any_hit_respects_tmax():
    org, d = _rays()
    tmin = torch.zeros(4)
    assert ref.any_hit(org, d, tmin, torch.full((4,), 1.5),
                       _tris()).tolist() == [False] * 4
    assert ref.any_hit(org, d, tmin, torch.full((4,), 2.5),
                       _tris()).tolist() == [True, False, True, False]


def test_hit_gap_is_small_for_true_hits_and_large_for_wrong_ones():
    org, d = _rays()
    tri = torch.tensor([0, -1, 1, -1], dtype=torch.int32)
    t = torch.tensor([2.0, math.inf, 2.0, math.inf])
    assert ref.hit_gap(org, d, tri, t, _tris()).max().item() < 1e-12
    wrong = ref.hit_gap(org, d, torch.tensor([1, -1, 1, -1]), t, _tris())
    assert wrong[0].item() > 1.0          # off the named triangle's plane
    off = ref.hit_gap(org[1:2], d[1:2], torch.tensor([0]),
                      torch.tensor([2.0]), _tris())
    assert off.item() > 0.5               # outside the triangle


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11,
                      -(1.0 + 2.0**-12), 3.0])
    assert ref.QUANT["tf32"](x).tolist() == [1.0 + 2.0**-10, 1.0,
                                             1.0 + 2.0**-9, -1.0, 3.0]


def test_block_order_covers_every_pixel_once():
    x, y = ref.block_pixels(64, 96, "cpu")
    assert sorted((y * 64 + x).tolist()) == list(range(64 * 96))
    assert (x[:4].tolist(), y[:4].tolist()) == ([0, 1, 0, 1], [0, 0, 1, 1])
