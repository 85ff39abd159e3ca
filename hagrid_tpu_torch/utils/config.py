"""Grid-dimension heuristic (port of
hagrid_tpu/utils/config.py::density_dims)."""

from __future__ import annotations


def density_dims(extent, n_prims: int, density: float):
    """The irregular-grids paper's heuristic: dims_a = e_a * cbrt(d*N/V).

    extent: 3-sequence of floats. Returns a tuple of 3 ints >= 1, computed
    on the host (array capacities derive from it)."""
    ex, ey, ez = (max(float(e), 1e-9) for e in extent)
    vol = ex * ey * ez
    k = (density * max(n_prims, 1) / vol) ** (1.0 / 3.0)
    return (max(1, int(ex * k)), max(1, int(ey * k)), max(1, int(ez * k)))
