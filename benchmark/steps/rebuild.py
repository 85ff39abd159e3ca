"""rebuild: RenderSession.rebuild on the frame's deformed triangles (the
warm rebuild), and the grid's own overflow flag after it, read with the
window's other flags once the window has closed.

It has no numbers of its own: the primary hits after it are judged on
the frame's deformed geometry, which a stale or broken grid fails."""

from __future__ import annotations

import frozen


def run(drv, fr, st):
    drv.session.rebuild(st["tris"])
    drv.grid_flags.append(frozen.grid_overflow_flag(drv.session))
