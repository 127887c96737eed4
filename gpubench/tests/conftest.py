"""Tests of the benchmark harness.  Most run on the CPU at tiny sizes; those
marked ``card`` need a CUDA card and skip without one (decided in the
``card`` fixture, never at import).  Run from the checkout's root:

    python -m pytest gpubench/tests -q
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


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
    """Tiny traffic for CPU runs of each cell."""
    return {
        "high_n4.device": dict(batch=64, pool=3, warm_calls=2, keep_outputs=3,
                               trace_seconds=0.2),
        "high_n10.device": dict(batch=6, pool=2, warm_calls=1, keep_outputs=2, trace_seconds=0.2),
        "high_n4.digits": dict(batch=48, pool=2, warm_calls=1, keep_outputs=2, trace_seconds=0.2),
        "high_n4.stream": dict(batch=96, pool=2, warm_batches=2, keep_outputs=3,
                               trace_seconds=0.2, marshal_repeats=2),
    }
