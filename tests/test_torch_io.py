"""PyTorch port, scene IO: the native OBJ parser against the Python parser,
load_scene on .obj paths against the JAX package's, and the image writers'
bytes against the JAX package's. Arrays and bytes are held exactly equal.
"""

import numpy as np
import pytest

from hagrid_tpu import scenes as j_scenes
from hagrid_tpu.io import image as j_image
from hagrid_tpu.io.obj import save_obj as j_save_obj
from hagrid_tpu_torch import scenes
from hagrid_tpu_torch.io import image, obj
from hagrid_tpu_torch.native import objloader_native

# Records the two parsers must read alike: comments, vt/vn records,
# v/vt/vn, v//vn and v/vt faces, negative (relative) indices, a quad and a
# pentagon (fan triangulation), exponents, CRLF line ends, a blank line.
HAND_OBJ = """# hand-written fixture
o thing
v 0 0 0
v 1.5 0 0
v 1.5 2.25e-1 0
v 0 1 -3.5E+2
vt 0.5 0.5
vn 0 0 1
f 1/1/1 2/1/1 3/1/1
f 1//1 3//1 4//1\r
usemtl none

v -1e-7 4 5\r
v 2 2 2
f -1 -2 -3 1
f 1/1 2/1 3/1 4/1 5/1
s off
f -6 -5 -4
"""


def test_native_parser_equals_python_parser_hand_written(tmp_path):
    p = str(tmp_path / "hand.obj")
    with open(p, "w", newline="") as fh:
        fh.write(HAND_OBJ)
    v, f = obj.load_obj(p)
    pv, pf = obj.load_obj_python(p)
    np.testing.assert_array_equal(v, pv)
    np.testing.assert_array_equal(f, pf)
    assert v.dtype == np.float32 and f.dtype == np.int32
    assert v.shape == (6, 3)
    # 1 + 1 + 2 (quad with negative indices) + 3 (pentagon) + 1 faces.
    assert f.shape == (8, 3)
    np.testing.assert_array_equal(f[2], [5, 4, 3])
    np.testing.assert_array_equal(f[4:7], [[0, 1, 2], [0, 2, 3], [0, 3, 4]])


@pytest.mark.parametrize("scale", [1.0, 1e-6, 3.7e5])
def test_native_parser_round_trips_save_obj(tmp_path, scale):
    """A float32 written by save_obj (its shortest repr) parses to the same
    float32 in C++ (strtof) and in Python (f64, then f32)."""
    rng = np.random.default_rng(int(scale * 7) % 97)
    v = (rng.normal(size=(4000, 3)) * scale).astype(np.float32)
    v[::50] = -0.0
    f = rng.integers(0, len(v), (3000, 3)).astype(np.int32)
    p = str(tmp_path / "soup.obj")
    obj.save_obj(p, v, f)
    nv, nf = obj.load_obj(p)
    pv, pf = obj.load_obj_python(p)
    np.testing.assert_array_equal(nv, v)
    np.testing.assert_array_equal(nf, f)
    np.testing.assert_array_equal(pv, v)
    np.testing.assert_array_equal(pf, f)


def test_native_parser_errors_are_raised(tmp_path, monkeypatch):
    """A missing file raises; a failed build raises with the compiler's
    output (no fallback to the Python parser)."""
    with pytest.raises(OSError):
        obj.load_obj(str(tmp_path / "missing.obj"))
    monkeypatch.setattr(objloader_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(objloader_native, "CXX_FLAGS",
                        ["-O3", "-shared", "-fPIC", "-fno-such-option"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        objloader_native.build()


def test_load_scene_obj_equals_reference(tmp_path):
    """load_scene(path) on an OBJ the JAX package wrote: the same arrays
    and the same camera as the reference's load_scene."""
    v, f = j_scenes.sponza_like(3000)
    p = str(tmp_path / "sponza.obj")
    j_save_obj(p, v, f)
    jv, jf, jcam = j_scenes.load_scene(p)
    pv, pf, cam = scenes.load_scene(p)
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pf, jf)
    assert (cam.eye, cam.center, cam.up, cam.fov_deg) == \
        (jcam.eye, jcam.center, jcam.up, jcam.fov_deg)
    with pytest.raises(ValueError):
        scenes.load_scene("no_such_scene")


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_image_writers_bytes_equal_reference(tmp_path, dtype):
    rng = np.random.default_rng(1)
    img = rng.random((9, 17, 3)).astype(np.float32)
    if dtype == np.uint8:
        img = (img * 255).astype(np.uint8)
    for name, port_fn, ref_fn in (("x.ppm", image.write_ppm,
                                   j_image.write_ppm),
                                  ("x.png", image.write_png,
                                   j_image.write_png)):
        port_fn(str(tmp_path / ("p" + name)), img)
        ref_fn(str(tmp_path / ("r" + name)), img)
        assert (tmp_path / ("p" + name)).read_bytes() == \
            (tmp_path / ("r" + name)).read_bytes()
    head = (tmp_path / "px.ppm").read_bytes()
    assert head.startswith(b"P6\n17 9\n255\n") and len(head) == 12 + 9 * 17 * 3
