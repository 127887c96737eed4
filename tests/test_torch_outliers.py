"""The recorded outlier matrices of the High precision sweep, on the port.

``benchmarks/results/outliers.json`` holds the eight HIGH matrices of the
seeded 10,000-inversion sweep whose mean error against ``np.linalg.inv``
passed the big-error threshold (n = 2: 4, n = 5: 3, n = 10: 1), each with
the JAX package's error and overflow flag (tests/test_outlier_parity.py
holds JAX to the live reference on them).  Each goes through the port's
digit path on the packed backend and on the limb backend (base 2), and
through the tracked packed path.  The digits must equal JAX's
``qfloat_matrix_inverse`` at the lowering tests/test_outlier_parity.py
uses (``unroll`` at n = 2, ``scan`` above) digit for digit, the flag the
recorded ``overflow_flagged``, and the mean error of the dequantized inverse
the recorded ``our_error`` (the same float64 operations on the same bits:
tolerance 0).
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrix_inversion_tpu.models.inverse import qfloat_matrix_inverse as jax_qfloat_matrix_inverse
from matrix_inversion_tpu.models.marshal import (
    float_matrix_to_qfloat_arrays as jax_float_matrix_to_qfloat_arrays,
)

import matrix_inversion_tpu_torch as mt
from matrix_inversion_tpu_torch.models.marshal import (
    float_matrix_to_mags_and_signs,
    float_matrix_to_qfloat_arrays,
    mags_and_signs_to_float_matrix,
)

torch.set_num_threads(2)

OUTLIERS = Path(__file__).resolve().parent.parent / "benchmarks" / "results" / "outliers.json"


def _cases():
    data = json.loads(OUTLIERS.read_text())
    for key, entry in sorted(data.items()):
        n = int(key.split("n=")[1])
        for i, o in enumerate(entry["outliers"]):
            yield pytest.param(n, np.asarray(o["matrix"]), o, id=f"{key}#{i}")


CASES = list(_cases())


def test_the_record_holds_eight_matrices():
    assert sorted(c.values[0] for c in CASES) == [2, 2, 2, 2, 5, 5, 5, 10]


@functools.lru_cache(maxsize=None)
def _jax_inverse(n):
    p = mt.HIGH.replace(n=n)
    lowering = "unroll" if n == 2 else "scan"
    return jax.jit(lambda d, s: jax_qfloat_matrix_inverse(
        d, s, n, p.qfloat_len, p.qfloat_ints, p.qfloat_base, p.true_division,
        backend="packed", lowering=lowering))


@pytest.mark.parametrize("n,M,meta", CASES)
def test_outlier_matches_jax_and_its_record(n, M, meta):
    p = mt.HIGH.replace(n=n)
    fmt = (p.qfloat_len, p.qfloat_ints, p.qfloat_base)
    args = (n, *fmt, p.true_division)
    jd, js = jax_float_matrix_to_qfloat_arrays(M[None], *fmt)
    want = np.asarray(_jax_inverse(n)(jnp.asarray(jd), jnp.asarray(js)))
    d, s = float_matrix_to_qfloat_arrays(M[None], *fmt)
    np.testing.assert_array_equal(d, np.asarray(jd))
    d, s = torch.from_numpy(d), torch.from_numpy(s)
    for backend in ("packed", "limb"):
        got = mt.qfloat_matrix_inverse(d, s, *args, backend=backend)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{backend} backend")
    mags, signs = map(torch.from_numpy, float_matrix_to_mags_and_signs(M[None], *fmt))
    om, os_, flag = mt.qfloat_matrix_inverse_with_overflow(mags, signs, *args)
    assert bool(flag[0]) == meta["overflow_flagged"]
    inv = mags_and_signs_to_float_matrix(om.numpy(), os_.numpy(), *fmt)
    assert float(np.mean(np.abs(inv - np.linalg.inv(M[None])))) == meta["our_error"]
