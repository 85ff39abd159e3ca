"""PyTorch port, the CLI (`python -m hagrid_tpu_torch.cli`) on the CPU:
`stats` prints the JAX package CLI's line for each structure, `render`
writes an image whose pixels are the eye-light shading of the reference
oracle's hits, `bench` prints the reference's JSON keys.
"""

import json
import os
import pathlib
import subprocess
import sys
import zlib

import numpy as np
import pytest

from hagrid_tpu import cli as j_cli
from hagrid_tpu import oracle as j_oracle
from hagrid_tpu import scenes as j_scenes
from hagrid_tpu.core.camera import primary_rays as j_primary_rays
from hagrid_tpu.core.types import Triangles as JTris
from hagrid_tpu_torch import cli
from hagrid_tpu_torch.io.image import shade_eyelight, to_u8

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _port_cli(*args, cwd=None):
    out = subprocess.run(
        [sys.executable, "-m", "hagrid_tpu_torch.cli", *args,
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        cwd=cwd or ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.mark.parametrize("structure", ["packet", "irregular", "uniform"])
def test_stats_line_equals_reference(structure, capsys):
    j_cli.main(["stats", "--scene", "cornell", "--structure", structure,
                "--platform", "cpu"])
    want = capsys.readouterr().out.strip().splitlines()[-1]
    got = _port_cli("stats", "--scene", "cornell", "--structure",
                    structure).strip().splitlines()[-1]
    assert got == want


def _read_png(path):
    """RGB8 pixels of a PNG written by io.image.write_png (filter 0)."""
    data = pathlib.Path(path).read_bytes()
    w, h = np.frombuffer(data[16:24], ">u4")
    idat, pos = b"", 8
    while pos < len(data):
        n = int(np.frombuffer(data[pos:pos + 4], ">u4")[0])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def test_render_equals_reference_oracle(tmp_path, capsys):
    """64x64 block-order render (reassembled to scanlines), packet
    structure, as a subprocess (PNG) and in process (PPM): every pixel
    equals the eye-light shading of the reference oracle's closest
    hits."""
    png, ppm = str(tmp_path / "c.png"), str(tmp_path / "c.ppm")
    out = _port_cli("render", "--scene", "cornell", "--size", "64x64",
                    "--out", png)
    assert "hit fraction" in out
    cli.main(["render", "--scene", "cornell", "--size", "64x64", "--out",
              ppm, "--device", "cpu"])
    assert "hit fraction" in capsys.readouterr().out
    v, f = j_scenes.cornell_box()
    jt = JTris.from_mesh(v, f)
    jr = j_primary_rays(j_scenes.cornell_camera(), 64, 64)
    ref = j_oracle.closest_hit(jr, jt)
    want = to_u8(shade_eyelight(np.asarray(ref.tri_id), np.asarray(ref.t),
                                np.asarray(jt.n), np.asarray(jr.dir), 64, 64))
    got = _read_png(png)
    np.testing.assert_array_equal(got, want)
    body = pathlib.Path(ppm).read_bytes()
    assert body.startswith(b"P6\n64 64\n255\n")
    np.testing.assert_array_equal(
        np.frombuffer(body[13:], np.uint8).reshape(64, 64, 3), want)


def test_bench_prints_reference_keys(capsys):
    cli.main(["bench", "--scene", "cornell", "--size", "64x64", "--iters",
              "1", "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"scene", "tris", "rays", "build_ms", "mrays_per_s", "structure",
            "grid", "device"} <= set(rec)
    assert rec["rays"] == 4096 and rec["tris"] == 32
    assert rec["device"] == "cpu" and rec["build_ms"] > 0
    assert rec["mrays_per_s"] >= 0   # rounded to 0.01: a slow host reads 0
