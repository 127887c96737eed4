"""Tests of the benchmark harness.  Most run on the CPU at tiny sizes; those
marked ``card`` need a CUDA card and skip without one (decided in the
``card`` fixture, never at import).  Run from the checkout's root:

    python -m pytest gpubench/tests -q

A cell's tiny CPU sizes and the keys its configuration must hold are worked
out from the cell's own files, so a cell added as files and
``BENCHMARK.json`` entries runs in every test with no line here.
"""

import ast
import os
import sys
from pathlib import Path

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: where a CPU run's traffic starts, by the driver and the form of the
#: answers it hands the check; a value of the cell's traffic file that is
#: smaller stays
TINY = {
    ("device_loop", "packed"): dict(batch=64, pool=3, warm_calls=2, keep_outputs=3),
    ("device_loop", "digits"): dict(batch=48, pool=2, warm_calls=1, keep_outputs=2),
    ("stream", "floats"): dict(batch=96, pool=2, warm_batches=2, keep_outputs=3,
                               marshal_repeats=2),
}
#: On the CPU every lowering runs the op-by-op circuit ("auto" and the JAX
#: lowerings send CPU tensors there, and "fused" runs K1's plain version,
#: which is that circuit).  Its eager calls grow with n, not with a tiny
#: batch: ~0.04 s a call at n = 4, 0.2 s at n = 7, 0.6 s at n = 10 and 1.6 s
#: at n = 13 on two CPU threads.  So from n = 7 a run takes a handful of
#: matrices, two pool batches, two answers and one warm-up.
LEAN_FROM_N = 7
LEAN = dict(batch=6, pool=2, keep_outputs=2)
TRACE_SECONDS = 0.2

#: what every configuration states: its format, sampler, control and source
CONFIG_KEYS = ("n", "qfloat_len", "qfloat_ints", "qfloat_base", "true_division", "sampler",
               "control", "source")


def tiny_traffic(name, root=ROOT):
    """The traffic of the cell ``name`` of the checkout at ``root`` for a
    CPU run: :data:`TINY` for its driver and answers, lean from
    :data:`LEAN_FROM_N`, each value no larger than its traffic file's."""
    from gpubench.harness import manifest
    from gpubench.harness.runner import _module

    cell = manifest.cell(name, root)
    tr = cell.traffic
    driver = _module("drivers", tr["driver"], Path(root))
    key = (tr["driver"], driver.answers(tr))
    if key not in TINY:
        raise KeyError(f"no tiny CPU sizes for the driver and answers {key}: add them to TINY")
    out = dict(TINY[key], trace_seconds=TRACE_SECONDS)
    if cell.config["n"] >= LEAN_FROM_N:
        out.update(LEAN, **{k: 1 for k in out if k.startswith("warm_")})
    return {k: min(v, tr.get(k, v)) for k, v in out.items()}


def config_keys_read(metric, root=ROOT):
    """The configuration keys that the reader of ``metric`` reads as
    ``<cell>.config["<key>"]``."""
    path = Path(root) / "gpubench" / "metrics" / f"{metric}.py"
    return {node.slice.value for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Attribute)
            and node.value.attr == "config" and isinstance(node.slice, ast.Constant)}


def required_config_keys(cell, root=ROOT):
    """:data:`CONFIG_KEYS` and every key that a per-layer metric of ``cell``
    reads from its configuration."""
    keys = set(CONFIG_KEYS)
    for m in cell.per_layer:
        keys |= config_keys_read(m["name"], root)
    return sorted(keys)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: run on the card")
    return torch.device("cuda", 0)


@pytest.fixture
def small():
    """``small(name, root=ROOT)``: the tiny CPU traffic of a cell."""
    return tiny_traffic


@pytest.fixture
def required_keys():
    """``required_keys(cell, root=ROOT)``: the keys its configuration must hold."""
    return required_config_keys
