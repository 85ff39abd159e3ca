"""Build parameters and the grid-dimension heuristic (port of
hagrid_tpu/utils/config.py)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BuildParams:
    """The irregular grid's build knobs, with the reference's names and
    defaults. The uniform build reads snd_density; the packet build
    reads none of them (its dims come from build_packet's own
    densities)."""

    top_density: float = 0.12
    snd_density: float = 2.4
    alpha: float = 0.995
    expansion_passes: int = 3
    merge_passes: int = 1
    # Cheap empty-buddy coalescing passes (no ref-array work) before SAH.
    buddy_passes: int = 3
    # Max air-octree coalescing depth over top cells (aligned 2^k cubes).
    air_levels: int = 5
    # Max second-level resolution per top cell (power of two): fine grid =
    # top dims << levels.
    levels: int = 3
    # A cell may refine only while its projected refs stay <= ref_growth *
    # its tri count.
    ref_growth: float = 4.0
    # Compact dead (merged-away) cell rows after optimization.
    compact: bool = True
    # Grow cell bboxes into non-empty neighbors whose ref list is a subset
    # of the cell's own; empty-neighbor growth always runs.
    subset_expansion: bool = True
    # Capacity head-room multiplier for the static ref buffers.
    ref_slack: float = 1.5

    @staticmethod
    def dynamic() -> "BuildParams":
        """Preset for per-frame rebuilds: levels=2 shrinks the entry
        tables 8x, for a faster rebuild at some trace cost."""
        return BuildParams(levels=2)


def density_dims(extent, n_prims: int, density: float):
    """The irregular-grids paper's heuristic: dims_a = e_a * cbrt(d*N/V).

    extent: 3-sequence of floats. Returns a tuple of 3 ints >= 1, computed
    on the host (array capacities derive from it)."""
    ex, ey, ez = (max(float(e), 1e-9) for e in extent)
    vol = ex * ey * ez
    k = (density * max(n_prims, 1) / vol) ** (1.0 / 3.0)
    return (max(1, int(ex * k)), max(1, int(ey * k)), max(1, int(ez * k)))
