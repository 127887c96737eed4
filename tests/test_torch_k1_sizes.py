"""K1 at the sizes past n = 5 that ``lowering="auto"`` sends to it: HIGH
n = 6..12, untracked and tracked, and LOW n = 10 (the CLI's default size).

``csrc/fused_inverse.cu`` with each size's emitted body compiles as host C++
(as in tests/test_torch_emit.py), all builds at once.  A ragged batch of 37
seeded x100 matrices, one of them singular and, for the tracked variant,
one near-singular and one all-zero, goes through its ``(B, n*n)`` entry
(the staging of the card's kernel, run as loops).  It must equal, with
tolerance 0 on magnitudes, signs and flags, the JAX package's
``qfloat_matrix_inverse_packed_io`` / ``qfloat_matrix_inverse_with_overflow``
at ``lowering="scan"`` and the port's op-by-op plain version on the same
inputs.
"""

import concurrent.futures
import ctypes
import functools
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import matrix_inversion_tpu as mi
from matrix_inversion_tpu.models import inverse as jax_inverse

import matrix_inversion_tpu_torch as mt
from matrix_inversion_tpu_torch.models.marshal import float_matrix_to_mags_and_signs
from matrix_inversion_tpu_torch.ops.emit import emit_body
from matrix_inversion_tpu_torch.ops.fused_inverse import CSRC, fused_matrix_inverse_reference

torch.set_num_threads(2)

B = 37  # ragged: no block of the card's kernel is full
BUILDS_AT_ONCE = 6  # about 0.6 GB of g++ each at n = 12
# (label, preset, n, tracked)
SIZES = ([(f"high{n}", "high", n, False) for n in range(6, 13)]
         + [(f"high{n}_tracked", "high", n, True) for n in range(6, 13)]
         + [("low10", "low", 10, False)])


def _config(preset, n):
    p = mt.PRESETS[preset].replace(n=n)
    return (n, p.qfloat_len, p.qfloat_ints, p.qfloat_base, p.true_division)


def _build(root, label, config, track):
    d = root / label
    d.mkdir()
    (d / "fused_body.inc").write_text(emit_body(*config, track=track))
    cmd = ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-x", "c++",
           "-I", str(CSRC), "-I", str(d), "-o", str(d / "lib.so"), str(CSRC / "fused_inverse.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, f"g++ failed for {label}:\n{proc.stderr}"
    lib = ctypes.CDLL(str(d / "lib.so"))
    fn = getattr(lib, "fused_inverse_tracked_host" if track else "fused_inverse_host")
    fn.argtypes = [ctypes.c_void_p] * (5 if track else 4) + [ctypes.c_int64]
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """``{label: host entry}``, one g++ build each,
    ``BUILDS_AT_ONCE`` at a time, the largest first."""
    root = tmp_path_factory.mktemp("k1_sizes")
    order = sorted(SIZES, key=lambda s: (-s[2], not s[3]))
    with concurrent.futures.ThreadPoolExecutor(BUILDS_AT_ONCE) as pool:
        futures = {label: pool.submit(_build, root, label, _config(preset, n), track)
                   for label, preset, n, track in order}
        return {label: f.result() for label, f in futures.items()}


def _inputs(config, track, seed):
    """37 random x100 matrices: matrix 5 singular (a row the sum of two
    others); tracked, matrix 0 near-singular and matrix 1 all zero, whose
    inverses overflow."""
    n, length, ints, base, _ = config
    M = np.random.RandomState(seed).randn(B, n, n) * 100
    M[5, 2] = M[5, 0] + M[5, 1]
    if track:
        M[0, 1] = M[0, 0] * (1 + 1e-12)
        M[1] = 0.0
    return float_matrix_to_mags_and_signs(M, length, ints, base)


def _run_host(fn, mags, signs, track):
    """The host entry on (B, n*n) arrays: its outputs."""
    om, os_ = np.empty_like(mags), np.empty_like(signs)
    flags = np.full(B, -1, np.int32)
    ptrs = [mags.ctypes.data, signs.ctypes.data, om.ctypes.data, os_.ctypes.data]
    if track:
        ptrs.append(flags.ctypes.data)
    assert fn(*ptrs, B) == 0
    return (om, os_, flags) if track else (om, os_)


@functools.lru_cache(maxsize=None)
def _jax_scan(config, track):
    body = (jax_inverse.qfloat_matrix_inverse_with_overflow if track
            else jax_inverse.qfloat_matrix_inverse_packed_io)
    return jax.jit(functools.partial(body, n=config[0], qfloat_len=config[1],
                                     qfloat_ints=config[2], qfloat_base=config[3],
                                     true_division=config[4], lowering="scan"))


@pytest.mark.parametrize("label,preset,n,track", SIZES, ids=[s[0] for s in SIZES])
def test_k1_host_build_matches_jax_scan_and_the_plain_version(host_kernels, label, preset, n,
                                                              track):
    config = _config(preset, n)
    assert jax_inverse._resolve_lowering("scan", n, packed_ok=True) == "scan"
    assert mi.PRESETS[preset].qfloat_len == config[1]
    mags, signs = _inputs(config, track, seed=100 * n + track)
    want = [np.asarray(x) for x in _jax_scan(config, track)(jnp.asarray(mags), jnp.asarray(signs))]
    plain = fused_matrix_inverse_reference(torch.from_numpy(mags), torch.from_numpy(signs),
                                           *config, track=track)
    for w, p in zip(want, plain):
        np.testing.assert_array_equal(p.numpy(), w)
    for g, w in zip(_run_host(host_kernels[label], mags, signs, track), want):
        np.testing.assert_array_equal(g, w)
    if track:
        flags = want[2]
        assert flags.dtype == np.int32 and flags[0] == 1 and flags[1] == 1 and not flags.all()
