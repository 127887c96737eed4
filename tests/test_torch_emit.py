"""The emitted kernel body and the hand-written primitives, on the CPU.

``csrc/fused_inverse.cu`` compiles as host C++ when ``__CUDACC__`` is not
defined: the same primitives (``csrc/qfloat_cell.cuh``), skeleton and
emitted body, with a loop over the batch in place of the launch.  Built
here with g++ into a ctypes library, its output must equal the plain
version of the kernel (itself held to the JAX package in
tests/test_torch_fused.py) bit for bit.  Single QFloat ops, emitted the
same way, are held to ``PackedQFloat`` across formats the inversion
circuits do not reach.
"""

import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import matrix_inversion_tpu_torch as mt
from matrix_inversion_tpu_torch.core.qfloat import SignedBinary, qf_from_mul
from matrix_inversion_tpu_torch.models.marshal import float_matrix_to_mags_and_signs
from matrix_inversion_tpu_torch.ops.emit import EmitQFloat, Emitter, Sym, emit_body
from matrix_inversion_tpu_torch.ops.packed import PackedQFloat
from matrix_inversion_tpu_torch.ops.fused_inverse import CSRC, fused_matrix_inverse_reference

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _config(name, n, **fmt):
    p = mt.PRESETS[name].replace(n=n, **fmt)
    return (n, p.qfloat_len, p.qfloat_ints, p.qfloat_base, p.true_division)


CONFIGS = {
    "high2": _config("high", 2),
    "high3": _config("high", 3),
    "high4": _config("high", 4),
    "high5": _config("high", 5),
    "low4": _config("low", 4),
    "medium3": _config("medium", 3),
    "medium_plus4": _config("medium+", 4),
    "low3": _config("low", 3),
    "low3_base4": _config("low", 3, qfloat_base=4, qfloat_len=11, qfloat_ints=4),
}


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """One g++ build of fused_inverse.cu per configuration, in parallel."""
    root = tmp_path_factory.mktemp("fused_host")
    procs = {}
    for key, config in CONFIGS.items():
        d = root / key
        d.mkdir()
        (d / "fused_body.inc").write_text(emit_body(*config))
        cmd = [
            "g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-x", "c++",
            "-I", str(CSRC), "-I", str(d), "-o", str(d / "lib.so"),
            str(CSRC / "fused_inverse.cu"),
        ]
        procs[key] = subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)
    libs = {}
    for key, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"g++ failed for {key}:\n{err}"
        fn = ctypes.CDLL(str(root / key / "lib.so")).fused_inverse_host
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64]
        fn.restype = ctypes.c_int
        libs[key] = fn
    return libs


def run_host(fn, mags, signs):
    """(B, n*n) int64 arrays through the host kernel (cell-major inside)."""
    cm = np.ascontiguousarray(mags.T)
    cs = np.ascontiguousarray(signs.T)
    om, os_ = np.empty_like(cm), np.empty_like(cs)
    assert fn(cm.ctypes.data, cs.ctypes.data, om.ctypes.data, os_.ctypes.data, cm.shape[1]) == 0
    return om.T, os_.T


def inputs(config, B, seed, singular=False):
    n, length, ints, base, _ = config
    rng = np.random.RandomState(seed)
    M = rng.randn(B, n, n) * (1 if singular else 100)
    if singular:
        M[:, 2, :] = M[:, 0, :] + M[:, 1, :]
    return float_matrix_to_mags_and_signs(M, length, ints, base)


@pytest.mark.parametrize("key", list(CONFIGS))
def test_host_kernel_matches_plain_version(host_kernels, key):
    config = CONFIGS[key]
    mags, signs = inputs(config, 37, seed=len(key))  # ragged, odd batch
    got_m, got_s = run_host(host_kernels[key], mags, signs)
    ref_m, ref_s = fused_matrix_inverse_reference(
        torch.from_numpy(mags), torch.from_numpy(signs), *config
    )
    np.testing.assert_array_equal(got_m, ref_m.numpy())
    np.testing.assert_array_equal(got_s, ref_s.numpy())


def test_host_kernel_singular(host_kernels):
    config = CONFIGS["low3"]
    mags, signs = inputs(config, 48, seed=3, singular=True)
    got_m, got_s = run_host(host_kernels["low3"], mags, signs)
    ref_m, ref_s = fused_matrix_inverse_reference(
        torch.from_numpy(mags), torch.from_numpy(signs), *config
    )
    np.testing.assert_array_equal(got_m, ref_m.numpy())
    np.testing.assert_array_equal(got_s, ref_s.numpy())


def test_emitted_source_is_deterministic():
    config = CONFIGS["high4"]
    src = emit_body(*config)
    assert src == emit_body(*config)
    code = (
        "import hashlib; from matrix_inversion_tpu_torch.ops.emit import emit_body; "
        f"print(hashlib.sha256(emit_body(*{config!r}).encode()).hexdigest())"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True
    )
    assert out.stdout.strip() == hashlib.sha256(src.encode()).hexdigest()
    assert "#define FUSED_N2 16" in src
    for primitive in ("sadd<1, 40>(", "mul<1, 40, 20, 40, 20, 40, 20>(", "divide<1, 40, 20>(", "gt(", "blend("):
        assert primitive in src, primitive
    # HIGH uses true division: no reciprocal is emitted; LOW's LU uses one
    assert "invert<" not in src
    assert "invert<1, 23, 9, 23, 0>(" in emit_body(*CONFIGS["low4"])


# ---- single ops: emitted primitives vs PackedQFloat --------------------


def _op_cases():
    """(name, (len, ints) of a, (len, ints) of b, base, op).  ``op(a, b, v)``
    runs on PackedQFloat cells with a tensor ``v`` and on EmitQFloat cells
    with a symbol ``v`` in {-1, 0, 1}."""
    rng = np.random.RandomState(0)
    cases = []
    for base, (length, ints) in ((2, (40, 20)), (2, (23, 9)), (4, (14, 5)), (16, (9, 4))):
        f = (length, ints)
        cases += [
            (f"add{base}_{length}", f, f, base, lambda a, b, v: a + b),
            (f"sub{base}_{length}", f, f, base, lambda a, b, v: a - b),
            (f"sb_sub{base}_{length}", f, f, base, lambda a, b, v: SignedBinary(v) - a),
            (f"sb_add_static{base}_{length}", f, f, base, lambda a, b, v: a + SignedBinary(-1)),
            (f"gt{base}_{length}", f, f, base, lambda a, b, v: abs(a) > b),
            (f"blend{base}_{length}", f, f, base, lambda a, b, v: a.copy().blend_from(b, v)),
            (f"mul{base}_{length}", f, f, base, lambda a, b, v: a * b),
            (f"sb_mul{base}_{length}", f, f, base, lambda a, b, v: SignedBinary(v) * -a),
            (f"div{base}_{length}", f, f, base, lambda a, b, v: a / b),
            (f"sb_div{base}_{length}", f, f, base, lambda a, b, v: a / SignedBinary(v)),
            (f"sb_div_zero{base}_{length}", f, f, base, lambda a, b, v: a / SignedBinary(0)),
            (f"rdiv{base}_{length}", f, f, base, lambda a, b, v: SignedBinary(-1) / a),
        ]
    maxlen = {2: 40, 4: 20, 16: 10}
    for base, count in ((2, 24), (4, 8), (16, 8)):
        bits = base.bit_length() - 1
        for k in range(count):
            al, bl, nl = rng.randint(2, maxlen[base] + 1, size=3)
            fa, fb = (al, rng.randint(0, al + 1)), (bl, rng.randint(0, bl + 1))
            ni = rng.randint(0, nl + 1)
            cases.append((f"from_mul{base}_{k}", fa, fb, base,
                          lambda a, b, v, nl=nl, ni=ni: qf_from_mul(a, b, nl, ni)))
            cases.append((f"sb_from_mul{base}_{k}", fa, fb, base,
                          lambda a, b, v, nl=nl, ni=ni: qf_from_mul(SignedBinary(v), a, nl, ni)))
            if bits * (1 + (al - fa[1]) + (nl - ni)) <= 62:
                cases.append((f"invert{base}_{k}", fa, fb, base,
                              lambda a, b, v, nl=nl, ni=ni: a.invert(SignedBinary(v), nl, ni)))
    # the formats of the circuits, including the 2x2 widened products
    for k, (fa, fb, (nl, ni)) in enumerate([
        ((40, 20), (40, 20), (43, 40)),
        ((43, 40), (43, 40), (40, 0)),
        ((40, 20), (40, 0), (40, 20)),
        ((23, 9), (23, 0), (23, 9)),
        ((18, 18), (25, 0), (18, 1)),
    ]):
        cases.append((f"circuit_mul_{k}", fa, fb, 2,
                      lambda a, b, v, nl=nl, ni=ni: qf_from_mul(a, b, nl, ni)))
    cases.append(("invert_2x2", (43, 40), (43, 40), 2, lambda a, b, v: a.invert(1, 40, 0)))
    return cases


OP_CASES = _op_cases()


def _emit_op(name, fa, fb, base, op):
    em = Emitter()
    a = EmitQFloat(em, "(uint64_t)am[i]", *fa, base, Sym(em, "(int)as[i]"))
    b = EmitQFloat(em, "(uint64_t)bm[i]", *fb, base, Sym(em, "(int)bs[i]"))
    out = op(a, b, Sym(em, "(int)v[i]"))
    if isinstance(out, EmitQFloat):
        tail = f"om[i] = (int64_t){out.mag}; os[i] = {out.sign.name if isinstance(out.sign, Sym) else out.sign};"
    else:
        tail = f"om[i] = 0; os[i] = {out.name};"
    body = "".join(f"    {line}\n" for line in em.lines)
    return (
        f'extern "C" void {name}(const int64_t* am, const int64_t* as, const int64_t* bm,\n'
        "    const int64_t* bs, const int64_t* v, int64_t* om, int64_t* os, int64_t n) {\n"
        "  using namespace qcell;\n"
        f"  for (int64_t i = 0; i < n; ++i) {{\n{body}    {tail}\n  }}\n}}\n"
    )


@pytest.fixture(scope="module")
def host_ops(tmp_path_factory):
    """Every single-op case in one g++ build."""
    d = tmp_path_factory.mktemp("ops_host")
    src = '#include "qfloat_cell.cuh"\n' + "".join(_emit_op(*c) for c in OP_CASES)
    (d / "ops.cc").write_text(src)
    subprocess.run(
        ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC),
         "-o", str(d / "ops.so"), str(d / "ops.cc")],
        check=True, capture_output=True, text=True, timeout=300,
    )
    return ctypes.CDLL(str(d / "ops.so"))


def _rand_cell(rng, B, fmt, base):
    bits = base.bit_length() - 1
    mags = rng.randint(0, 1 << 62, size=B, dtype=np.int64) & ((1 << (bits * fmt[0])) - 1)
    mags[:3] = [0, 0, (1 << (bits * fmt[0])) - 1]  # zero divisors, all-ones
    signs = rng.choice([-1, 0, 1], size=B).astype(np.int64)
    return mags, signs


@pytest.mark.parametrize("case", OP_CASES, ids=[c[0] for c in OP_CASES])
def test_emitted_op_matches_packed(host_ops, case):
    name, fa, fb, base, op = case
    rng = np.random.RandomState(len(name))
    B = 257
    am, as_ = _rand_cell(rng, B, fa, base)
    bm, bs = _rand_cell(rng, B, fb, base)
    # a + b = -base**len: the tidy drops the carry to magnitude 0, sign +1
    am[3], as_[3], bm[3], bs[3] = (1 << ((base.bit_length() - 1) * fa[0])) - 1, -1, 1, -1
    v = rng.choice([-1, 0, 1], size=B).astype(np.int64)
    om, os_ = np.empty(B, np.int64), np.empty(B, np.int64)
    fn = getattr(host_ops, name)
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64]
    fn(*(x.ctypes.data for x in (am, as_, bm, bs, v, om, os_)), B)

    t = torch.from_numpy
    ref = op(
        PackedQFloat(t(am), *fa, base, t(as_)),
        PackedQFloat(t(bm), *fb, base, t(bs)),
        t(v),
    )
    if isinstance(ref, PackedQFloat):
        np.testing.assert_array_equal(om, ref.mag.numpy())
        np.testing.assert_array_equal(os_, np.broadcast_to(np.asarray(ref.sign), B))
    else:
        np.testing.assert_array_equal(os_, ref.numpy())
