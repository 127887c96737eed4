"""The limb backend's circuits and entry points against the JAX package's,
on the CPU.

``qfloat_matrix_inverse(backend="limb")`` (the default), the partial
circuits ``qfloat_pivot``/``qfloat_lu_L``/``qfloat_lu_U`` on limb cells and
the API on the limb backend (``EncryptedMatrixInversion``,
``BatchedMatrixInversion(io="digits")``) are held with tolerance 0 (int32
arrays, digits and signs) to the JAX package on the same numpy inputs;
the JAX circuits are jitted, as its API runs them.  At base 2 the limb
output is also held to the port's packed output (itself held to JAX in
``tests/test_torch_digits_io.py``) at MEDIUM+ n=3.  ``resolve_backend``
and the errors of a lowering or an I/O that needs the packed backend are
held to JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import matrix_inversion_tpu as mi
from matrix_inversion_tpu.models import inverse as jax_inverse
from matrix_inversion_tpu.runtime.api import BatchedMatrixInversion as JaxBatched
from matrix_inversion_tpu.runtime.api import EncryptedMatrixInversion as JaxEncrypted

import matrix_inversion_tpu_torch as mt
from matrix_inversion_tpu_torch.config import from_jax_params
from matrix_inversion_tpu_torch.core.qfloat import QFloatBase
from matrix_inversion_tpu_torch.models import inverse, marshal
from matrix_inversion_tpu_torch.utils import debug

torch.set_num_threads(2)

# a base-3 encoding of about Low's precision: 3**6 > 2**9, 3**-9 ~ 2**-14
BASE3 = dict(qfloat_base=3, qfloat_len=15, qfloat_ints=6)
# and a base-10 one: 10**3 > 2**9, 10**-4 ~ 2**-13
BASE10 = dict(qfloat_base=10, qfloat_len=7, qfloat_ints=3)


def digits_of(p, M):
    d, s = marshal.float_matrix_to_qfloat_arrays(M, p.qfloat_len, p.qfloat_ints, p.qfloat_base)
    return torch.from_numpy(d), torch.from_numpy(s)


@functools.lru_cache(maxsize=None)
def jax_circuit(n, qfloat_len, qfloat_ints, qfloat_base, true_division, tensorize):
    return jax.jit(functools.partial(
        jax_inverse.qfloat_matrix_inverse, n=n, qfloat_len=qfloat_len, qfloat_ints=qfloat_ints,
        qfloat_base=qfloat_base, true_division=true_division, tensorize=tensorize,
        backend="limb"))


def matrices(seed, B, n):
    M = np.random.RandomState(seed).randn(B, n, n) * 10
    M[0] = 0.0  # division by zero saturates
    M[1, 1] = M[1, 0]  # a singular one
    return M


@pytest.mark.parametrize("p,tensorize", [
    (mt.LOW.replace(n=2), False),
    (mt.LOW.replace(n=2), True),
    (mt.LOW.replace(n=2, **BASE3), True),
    (mt.LOW.replace(n=2, **BASE10), False),
    (mt.LOW.replace(n=3), False),
], ids=["low-n2-base2", "low-n2-base2-tensorize", "low-n2-base3-tensorize", "low-n2-base10",
        "low-n3-base2"])
def test_qfloat_matrix_inverse_limb_matches_jax(p, tensorize):
    M = matrices(p.n + p.qfloat_base, 6, p.n)
    d, s = digits_of(p, M)
    args = (p.n, p.qfloat_len, p.qfloat_ints, p.qfloat_base, p.true_division)
    QFloatBase.reset_stats()
    got = mt.qfloat_matrix_inverse(d, s, *args, tensorize)  # backend="limb" by default
    counts = (QFloatBase.ADDITIONS, QFloatBase.MULTIPLICATION, QFloatBase.DIVISION)
    jc = mi.core.qfloat.QFloatBase
    jc.reset_stats()  # the jit traces once, here: its counts are one circuit's
    ref = np.asarray(jax_circuit(*args, tensorize)(jnp.asarray(d.numpy()), jnp.asarray(s.numpy())))
    assert counts == (jc.ADDITIONS, jc.MULTIPLICATION, jc.DIVISION)
    assert got.dtype == torch.int32 and got.shape == (6, p.n * p.n, p.qfloat_len + 1)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the other tensorize gives the same bits
    other = mt.qfloat_matrix_inverse(d, s, *args, not tensorize, backend="limb", lowering="unroll")
    assert torch.equal(other, got)
    # "auto" is the limb backend in the functional entry point, as in JAX
    assert torch.equal(mt.qfloat_matrix_inverse(d, s, *args, tensorize, backend="auto"), got)


def test_limb_matches_packed_medium_plus_n3():
    p = mt.MEDIUM_PLUS.replace(n=3)
    M = matrices(3, 16, 3) * 10
    d, s = digits_of(p, M)
    args = (3, p.qfloat_len, p.qfloat_ints, p.qfloat_base, p.true_division)
    limb = mt.qfloat_matrix_inverse(d, s, *args, backend="limb")
    for tensorize in (False, True):
        assert torch.equal(mt.qfloat_matrix_inverse(d, s, *args, tensorize, backend="packed"), limb)
    assert torch.equal(mt.qfloat_matrix_inverse(d[0], s[0], *args), limb[0])  # one matrix


@pytest.mark.parametrize("p", [mt.LOW.replace(n=3), mt.LOW.replace(n=2, **BASE3)],
                         ids=["low-n3-base2", "low-n2-base3"])
def test_partial_circuits_limb_match_jax(p):
    M = matrices(30 + p.qfloat_base, 5, p.n) * 10
    d, s = digits_of(p, M)
    jd, js = jnp.asarray(d.numpy()), jnp.asarray(s.numpy())
    jp = mi.QFloatParams(**{k: getattr(p, k) for k in ("n", "qfloat_len", "qfloat_ints",
                                                         "qfloat_base", "true_division")})
    pivot = mt.qfloat_pivot(d, s, p.as_list())  # backend="limb" by default
    np.testing.assert_array_equal(pivot.numpy(), np.asarray(
        jax_inverse.qfloat_pivot(jd, js, jp.as_list(), "limb")))
    ref_l, ref_u = jax.jit(lambda a, b: (jax_inverse.qfloat_lu_L(a, b, jp.as_list(), "limb"),
                                         jax_inverse.qfloat_lu_U(a, b, jp.as_list(), "limb")))(jd, js)
    for fn, ref in ((mt.qfloat_lu_L, ref_l), (mt.qfloat_lu_U, ref_u)):
        got = fn(d, s, p.as_list(), "limb")
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        if p.qfloat_base == 2:
            assert torch.equal(fn(d, s, p.as_list(), "packed"), got)


def test_resolve_backend_matches_jax():
    for kw in (dict(qfloat_base=3), dict(qfloat_base=10), dict(qfloat_base=2, qfloat_len=31),
               dict(qfloat_base=2, qfloat_len=20), dict(qfloat_base=16, qfloat_len=8, qfloat_ints=4),
               dict(qfloat_base=16, qfloat_len=12, qfloat_ints=4)):
        for backend in ("auto", "limb", "packed"):
            jp = mi.QFloatParams(backend=backend, **kw)
            p = from_jax_params(jp)
            assert p == mt.QFloatParams(backend=backend, **kw)
            try:
                want = jp.resolve_backend()
            except ValueError as e:
                with pytest.raises(ValueError, match="packed backend cannot represent"):
                    p.resolve_backend()
                assert "cannot represent" in str(e)
                continue
            assert p.resolve_backend() == want
    assert mt.QFloatParams(qfloat_base=10).resolve_backend() == "limb"
    p = mt.QFloatParams(qfloat_base=3, tensorize=True)
    assert p.as_list() == mi.QFloatParams(qfloat_base=3, tensorize=True).as_list()
    assert p.as_list()[5] is True
    with pytest.raises(ValueError, match="auto\\|packed\\|limb"):
        mt.QFloatParams(backend="limbs")


def test_packed_only_options_raise_as_in_jax():
    p = mt.LOW.replace(n=2, **BASE3)
    d, s = digits_of(p, matrices(4, 2, 2))
    args = (2, p.qfloat_len, p.qfloat_ints, 3, False)
    for lowering in ("scan", "vec", "fused"):
        with pytest.raises(ValueError, match=f"lowering='{lowering}' requires the packed"):
            mt.qfloat_matrix_inverse(d, s, *args, lowering=lowering)
        with pytest.raises(ValueError, match="requires the packed"):
            jax_inverse.qfloat_matrix_inverse(jnp.asarray(d.numpy()), jnp.asarray(s.numpy()),
                                              *args, lowering=lowering)
        with pytest.raises(ValueError, match="requires the packed"):
            mt.BatchedMatrixInversion(p.replace(lowering=lowering), 2, device="cpu")
    jp = mi.LOW.replace(n=2, **BASE3)
    kw = dict(qfloat_base=3, qfloat_len=15, qfloat_ints=6)
    for make, jmake in (
        (lambda **a: mt.BatchedMatrixInversion(p, 2, device="cpu", **a),
         lambda **a: JaxBatched(jp, 2, **a)),
        (lambda **a: mt.EncryptedMatrixInversion(2, device="cpu", **kw, **a),
         lambda **a: JaxEncrypted(2, **kw, **a)),
    ):
        for a in (dict(io="packed"), dict(io="packed", track_overflow=True)):
            with pytest.raises(ValueError, match="packed io requires the packed backend"):
                make(**a)
            with pytest.raises(ValueError, match="packed io requires the packed backend"):
                jmake(**a)
        for a in (dict(track_overflow=True), dict(io="digits", track_overflow=True)):
            with pytest.raises(ValueError, match="track_overflow requires io='packed'"):
                make(**a)
            with pytest.raises(ValueError, match="track_overflow requires io='packed'"):
                jmake(**a)
    with pytest.raises(ValueError, match="cannot represent"):
        mt.EncryptedMatrixInversion(2, backend="packed", device="cpu", **kw)


def test_api_on_limb_matches_jax():
    """EncryptedMatrixInversion and BatchedMatrixInversion(io="digits") on
    the limb backend ("auto" at base 3), against JAX's API on the same
    matrices: run, run(simulate=True), the lifecycle steps, the batch."""
    kw = dict(qfloat_base=3, qfloat_len=15, qfloat_ints=6)
    sampler = lambda: np.random.RandomState(9).randn(2, 2)
    inv = mt.EncryptedMatrixInversion(2, sampler, tensorize=True, device="cpu", **kw)
    jinv = JaxEncrypted(2, sampler, tensorize=True, **kw)
    assert inv.backend == jinv.backend == "limb"
    rng = np.random.RandomState(10)
    for A in [rng.randn(2, 2) * 10 for _ in range(3)] + [np.zeros((2, 2))]:
        want = jinv.run(A)
        np.testing.assert_array_equal(inv.run(A), want)
        np.testing.assert_array_equal(inv.run(A, simulate=True), want)
        q = inv.quantize(A)
        out = inv.decrypt(inv.evaluate(inv.encrypt(*q)))
        assert out.dtype == np.int32 and out.shape == (4, 16)
        np.testing.assert_array_equal(out, np.asarray(jinv.evaluate(jinv.encrypt(*jinv.quantize(A)))))
    p = mt.QFloatParams(n=2, **kw)
    M = matrices(11, 5, 2)
    batched = mt.BatchedMatrixInversion(p, 5, device="cpu")
    jbatched = JaxBatched(mi.QFloatParams(n=2, **kw), 5)
    assert batched.backend == jbatched.backend == "limb" and batched.io == "digits"
    np.testing.assert_array_equal(batched.run(M), jbatched.run(M))
    d, s = batched.quantize(M)
    assert batched.run_raw(d, s).dtype == torch.int32


def test_debug_tools_resolve_to_limb():
    """``run_qfloat_inverse`` and ``compare_plu`` with ``backend=None`` take
    ``params.resolve_backend()``, the limb backend at base 3, as JAX's do:
    the inverse is the limb circuit's (held to JAX's here), and the QFloat
    L and U are those of ``qfloat_lu_L``/``qfloat_lu_U`` on limb cells."""
    M = np.random.RandomState(12).randn(2, 2) * 10
    p = mt.QFloatParams(n=2, **BASE3)
    d, s = digits_of(p, M)
    args = (2, p.qfloat_len, p.qfloat_ints, 3, False)
    ref = np.asarray(jax_circuit(*args, False)(jnp.asarray(d.numpy()), jnp.asarray(s.numpy())))
    want = marshal.qfloat_and_signs_arrays_to_float_matrix(ref, p.qfloat_ints, 3)
    np.testing.assert_array_equal(debug.run_qfloat_inverse(M, p, device="cpu"), want)
    got = debug.compare_plu(M, p, verbose=False, device="cpu")
    for key, fn in (("L", mt.qfloat_lu_L), ("U", mt.qfloat_lu_U)):
        cells = fn(d, s, p.as_list()).numpy()
        np.testing.assert_array_equal(
            np.asarray(got[key][0], float).reshape(-1),
            marshal.qfloat_and_signs_arrays_to_float_matrix(cells, p.qfloat_ints, 3).reshape(-1))
