"""Matrix samplers used by benchmarks and tests (reference main.py:119-120).

Port of ``matrix_inversion_tpu/utils/samplers.py``.  Each sampler returns a
callable producing (batched) float matrices as numpy arrays; ``rng`` is a
``numpy.random.Generator`` or ``RandomState`` (default: numpy's global
state), so the same seed gives the JAX package's matrices.
"""

from __future__ import annotations

import numpy as np


def normal_sampler(n, scale=100.0, rng=None):
    rng = rng or np.random
    return lambda batch=(): rng.standard_normal(tuple(batch) + (n, n)) * scale


def uniform_sampler(n, low=0.0, high=100.0, rng=None):
    rng = rng or np.random
    return lambda batch=(): rng.uniform(low, high, tuple(batch) + (n, n))


SAMPLERS = {"Normal": normal_sampler, "Uniform": uniform_sampler}
