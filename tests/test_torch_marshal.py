"""Port vs JAX package: presets, parameters and packed-I/O marshalling.

The same numpy inputs go through ``matrix_inversion_tpu`` and
``matrix_inversion_tpu_torch``; results must agree exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import matrix_inversion_tpu as mi
from matrix_inversion_tpu.models import marshal as jax_marshal
from matrix_inversion_tpu.runtime import native as jax_native

import matrix_inversion_tpu_torch as mt
from matrix_inversion_tpu_torch.config import from_jax_params
from matrix_inversion_tpu_torch.models import marshal

torch.set_num_threads(2)

PRESET_NAMES = ["low", "medium", "medium+", "high"]


@pytest.mark.parametrize("name", PRESET_NAMES)
def test_presets_match_jax_field_by_field(name):
    port, ref = mt.PRESETS[name], mi.PRESETS[name]
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert from_jax_params(ref) == port
    assert from_jax_params(ref.replace(n=5, lowering="fused")) == port.replace(
        n=5, lowering="fused"
    )
    assert port.frac == ref.frac
    assert port.digit_bits() == ref.digit_bits()
    assert port.packed_ok() == ref.packed_ok()
    assert getattr(mt, name.upper().replace("+", "_PLUS")) == port


@pytest.mark.parametrize("lowering", ["vec", "scan"])
def test_unported_lowerings_name_roadmap(lowering):
    """JAX's "vec" and "scan" lowerings carry across: both run the port's
    op-by-op path (the name dates from when they raised)."""
    assert mt.QFloatParams(lowering=lowering).lowering == lowering
    ref = mi.HIGH.replace(n=16, lowering=lowering)
    assert from_jax_params(ref) == mt.HIGH.replace(n=16, lowering=lowering)
    with pytest.raises(ValueError, match="lowering must be"):
        mt.QFloatParams(lowering=lowering + "x")


def _inputs(p, B, seed):
    """(B, 4, 4) floats with zeros, negatives and integer parts that
    overflow ``ints`` digits."""
    rng = np.random.RandomState(seed)
    M = rng.randn(B, 4, 4) * 100
    flat = M.reshape(B, 16)
    top = float(p.qfloat_base ** p.qfloat_ints)
    flat[0, :8] = [0.0, -0.0, -1.5, 0.25, top + 0.375, -(3 * top + 0.5), top - 1e-9, -top]
    return M


def _overflows(M, p):
    return np.abs(np.trunc(M)) >= p.qfloat_base ** p.qfloat_ints


@pytest.mark.parametrize("name", PRESET_NAMES)
@pytest.mark.parametrize("B", [16, 300])  # 256 cells: radix route; 4800: large
def test_quantize_matches_jax(name, B):
    p = mt.PRESETS[name]
    M = _inputs(p, B, seed=B)
    got_m, got_s = marshal.float_matrix_to_mags_and_signs(
        M, p.qfloat_len, p.qfloat_ints, p.qfloat_base
    )
    ref_m, ref_s = jax_marshal.float_matrix_to_mags_and_signs(
        M, p.qfloat_len, p.qfloat_ints, p.qfloat_base
    )
    ref_m, ref_s = np.asarray(ref_m), np.asarray(ref_s)
    assert got_m.dtype == np.int64 and got_s.dtype == np.int64
    np.testing.assert_array_equal(got_s, ref_s)
    ovf = _overflows(M, p).reshape(B, 16)
    assert ovf.any() and (~ovf).any()
    np.testing.assert_array_equal(got_m[~ovf], ref_m[~ovf])
    # An integer part wider than `ints` keeps its low digits.  The JAX
    # radix route (small batches, or no native build) leaves the wider
    # magnitude untidy instead (ROADMAP queue 3); masked, all routes agree.
    mask = (1 << (p.digit_bits() * p.qfloat_len)) - 1
    np.testing.assert_array_equal(got_m, ref_m & mask)
    if jax_native.available():
        nat_m, nat_s = jax_native.quantize_packed(
            M.reshape(B, 16), p.qfloat_len, p.qfloat_ints, p.qfloat_base
        )
        np.testing.assert_array_equal(got_m, nat_m)
        np.testing.assert_array_equal(got_s, nat_s)


def test_quantize_rejects_non_power_of_two_base():
    with pytest.raises(ValueError, match="power-of-two"):
        marshal.float_matrix_to_mags_and_signs(np.zeros((1, 2, 2)), 10, 5, 3)


@pytest.mark.parametrize("name", PRESET_NAMES)
@pytest.mark.parametrize("B", [16, 300])
def test_dequantize_matches_jax(name, B):
    p = mt.PRESETS[name]
    rng = np.random.RandomState(B)
    mags = rng.randint(0, 1 << (p.qfloat_len - 1), size=(B, 16)).astype(np.int64)
    signs = rng.choice([-1, 1], size=(B, 16)).astype(np.int64)
    got = marshal.mags_and_signs_to_float_matrix(
        mags, signs, p.qfloat_len, p.qfloat_ints, p.qfloat_base
    )
    ref = jax_marshal.mags_and_signs_to_float_matrix(
        mags, signs, p.qfloat_len, p.qfloat_ints, p.qfloat_base
    )
    assert got.shape == (B, 4, 4)
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("base,length,ints", [(3, 20, 8), (10, 12, 5)])
def test_dequantize_any_base_matches_jax(base, length, ints):
    """Dequantize takes any base, as the reference does (quantize keeps its
    power-of-two check); 16 x 16 = 256 cells, below the 4,096 where JAX
    would take its native form."""
    rng = np.random.RandomState(base)
    mags = rng.randint(0, base ** length, size=(16, 16)).astype(np.int64)
    mags[0, :3] = [0, 1, base ** length - 1]
    signs = rng.choice([-1, 0, 1], size=(16, 16)).astype(np.int64)
    got = marshal.mags_and_signs_to_float_matrix(mags, signs, length, ints, base)
    ref = jax_marshal.mags_and_signs_to_float_matrix(mags, signs, length, ints, base)
    assert got.shape == (16, 4, 4)
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_cell_matrix_round_trip():
    p = mt.HIGH
    rng = np.random.RandomState(3)
    mags = torch.from_numpy(rng.randint(0, 1 << 39, size=(5, 9)).astype(np.int64))
    signs = torch.from_numpy(rng.choice([-1, 1], size=(5, 9)).astype(np.int64))
    M = marshal.mags_and_signs_to_qfloat_matrix(mags, signs, 40, 20, 2)
    assert len(M) == 3 and all(len(row) == 3 for row in M)
    M[0][1] = mt.SignedBinary(-1)
    M[2][2] = mt.Zero()
    out_m, out_s = marshal.qfloat_matrix_to_mags_and_signs(M, 40, 20, 2)
    exp_m, exp_s = mags.clone(), signs.clone()
    exp_m[:, 1], exp_s[:, 1] = 1 << (p.frac), -1
    exp_m[:, 8], exp_s[:, 8] = 0, 0
    assert torch.equal(out_m, exp_m) and torch.equal(out_s, exp_s)
