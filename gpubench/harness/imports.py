"""The modules a run may not hold: JAX, its relatives and the JAX package.

Names are compared by their top-level part, the part before the first dot,
whole: ``matrix_inversion_tpu_torch`` is the program under test and does
not match ``matrix_inversion_tpu``.
"""

from __future__ import annotations

import ast
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "matrix_inversion_tpu")


def top(name):
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None):
    """The forbidden top-level names among ``modules`` (default: the
    process's ``sys.modules``), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({top(m) for m in names if top(m) in FORBIDDEN})


def imported_names(path):
    """Every module a Python file imports by absolute name, at any depth of
    its code."""
    tree = ast.parse(open(path).read(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names
