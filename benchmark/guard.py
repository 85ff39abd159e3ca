"""Import guards: the benchmark measures the PyTorch port alone.

`loaded_forbidden()` names each loaded module whose top-level name (the
part before the first dot), compared whole, is JAX's, jaxlib's, flax's or
the JAX package's: the port's package name begins with the JAX
package's, so a prefix test would catch the port too.
`imports_of(path)` lists the top-level names a source file imports, for
the check that the reference imports nothing of the program.
"""

from __future__ import annotations

import ast
import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "hagrid_tpu"})
PROGRAM = "hagrid_tpu_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None) -> list:
    """Sorted names of loaded modules whose top-level name is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted(n for n in list(modules) if top_level(n) in FORBIDDEN)


def imports_of(path) -> set:
    """Top-level names of every module a Python source imports (absolute
    imports; relative ones are the benchmark's own files)."""
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(top_level(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(top_level(node.module))
    return names
