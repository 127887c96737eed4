"""The emitted kernel body and the hand-written primitives, on the CPU.

``csrc/fused_inverse.cu`` compiles as host C++ when ``__CUDACC__`` is not
defined: the same primitives (``csrc/qfloat_cell.cuh``), skeleton and
emitted body, with a loop over the batch in place of the launch.  Built
here with g++ into a ctypes library, its output must equal the plain
version of the kernel (itself held to the JAX package in
tests/test_torch_fused.py) bit for bit.  Single QFloat ops, emitted the
same way, are held to ``PackedQFloat`` across formats the inversion
circuits do not reach.  The tracked variant (a body emitted under
tracking) is held the same way to the tracked plain version, flags
included, and the tracked primitives to ``PackedQFloat`` inside
``track_overflow()``.  The kernel's one entry takes row-major ``(B, n*n)``
arrays and runs the kernel's staging (its index arithmetic, padding and
bounds) as loops over a block's threads; the windowed multiply is held to
``PackedQFloat`` in every form the build switches of
``csrc/qfloat_cell.cuh`` give it.
"""

import ctypes
import hashlib
import subprocess
import sys
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import pytest
import torch

import matrix_inversion_tpu_torch as mt
from matrix_inversion_tpu_torch.core.qfloat import SignedBinary, qf_from_mul
from matrix_inversion_tpu_torch.models.marshal import float_matrix_to_mags_and_signs
from matrix_inversion_tpu_torch.ops.emit import EmitQFloat, Emitter, Sym, emit_body
from matrix_inversion_tpu_torch.ops.packed import PackedQFloat, track_overflow
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

# the circuit configurations of the tracked variant
TRACKED = ["high2", "high3", "high4", "high5", "low3", "low4", "medium3", "medium_plus4"]


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """One g++ build of fused_inverse.cu per configuration, untracked and
    tracked (key ``t_<name>``), all in parallel."""
    root = tmp_path_factory.mktemp("fused_host")
    builds = {key: (config, False) for key, config in CONFIGS.items()}
    builds.update({f"t_{key}": (CONFIGS[key], True) for key in TRACKED})
    procs = {}
    for key, (config, track) in builds.items():
        d = root / key
        d.mkdir()
        (d / "fused_body.inc").write_text(emit_body(*config, track=track))
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
        lib = ctypes.CDLL(str(root / key / "lib.so"))
        track = builds[key][1]
        fn = lib.fused_inverse_tracked_host if track else lib.fused_inverse_host
        fn.argtypes = [ctypes.c_void_p] * (5 if track else 4) + [ctypes.c_int64]
        fn.restype = ctypes.c_int
        libs[key] = fn
    return libs


CANARY = 0x5A5A5A5A5A5A5A5A


def _placed(a, misaligned):
    """``(copy, buffer)``: a copy of ``a`` whose storage starts on a 16-byte
    boundary, or 8 bytes past one, inside a buffer of canary words."""
    buf = np.full(a.size + 4, CANARY, a.dtype)
    off = 2 - ((buf.ctypes.data // 8) + (1 if misaligned else 0)) % 2
    out = buf[off:off + a.size].reshape(a.shape)
    out[...] = a
    assert out.ctypes.data % 16 == (8 if misaligned else 0)
    return out, buf


def run_host(fn, mags, signs, track=False, misaligned=False):
    """(B, n*n) int64 arrays through the host entry as they lie, on
    16-byte-aligned storage or 8 bytes off it; the tracked kernel also
    returns the (B,) int32 flags.  Fails if the entry wrote a word outside
    its output arrays."""
    (m, _), (s, _) = _placed(mags, misaligned), _placed(signs, misaligned)
    (om, om_buf), (os_, os_buf) = (_placed(np.zeros_like(x), misaligned) for x in (m, s))
    ptrs = [m.ctypes.data, s.ctypes.data, om.ctypes.data, os_.ctypes.data]
    flags = np.zeros(m.shape[0], np.int32)
    if track:
        ptrs.append(flags.ctypes.data)
    assert fn(*ptrs, m.shape[0]) == 0
    for out, buf in ((om, om_buf), (os_, os_buf)):
        off = (out.ctypes.data - buf.ctypes.data) // 8
        assert (buf[:off] == CANARY).all() and (buf[off + out.size:] == CANARY).all(), \
            "the entry wrote outside its output array"
    return (om, os_, flags) if track else (om, os_)


def inputs(config, B, seed, singular=False):
    n, length, ints, base, _ = config
    rng = np.random.RandomState(seed)
    M = rng.randn(B, n, n) * (1 if singular else 100)
    if singular:
        M[:, 2, :] = M[:, 0, :] + M[:, 1, :]
    return float_matrix_to_mags_and_signs(M, length, ints, base)


def overflowy_inputs(config, B, seed):
    """Random x100 matrices with one near-singular and one all-zero matrix
    (tests/test_overflow.py::_overflowy_batch)."""
    n, length, ints, base, _ = config
    M = np.random.RandomState(seed).randn(B, n, n) * 100
    M[0, 1] = M[0, 0] * (1 + 1e-12)
    M[1] = 0.0
    return float_matrix_to_mags_and_signs(M, length, ints, base)


def test_host_kernel_singular(host_kernels):
    config = CONFIGS["low3"]
    mags, signs = inputs(config, 48, seed=3, singular=True)
    got_m, got_s = run_host(host_kernels["low3"], mags, signs)
    ref_m, ref_s = fused_matrix_inverse_reference(
        torch.from_numpy(mags), torch.from_numpy(signs), *config
    )
    np.testing.assert_array_equal(got_m, ref_m.numpy())
    np.testing.assert_array_equal(got_s, ref_s.numpy())


@pytest.mark.parametrize("key", TRACKED)
def test_tracked_and_untracked_bodies_agree(host_kernels, key):
    """The windowed and truncated multiplies are digit-exact, so both
    variants give the same magnitudes and signs."""
    mags, signs = overflowy_inputs(CONFIGS[key], 53, seed=2 * len(key))
    tracked = run_host(host_kernels[f"t_{key}"], mags, signs, track=True)
    untracked = run_host(host_kernels[key], mags, signs)
    np.testing.assert_array_equal(tracked[0], untracked[0])
    np.testing.assert_array_equal(tracked[1], untracked[1])


# one matrix; a ragged, odd batch inside one block; exactly one block;
# three blocks, the last with an odd count of matrices
ROWS_BATCHES = [1, 37, 128, 261]


def _check_rows_entry(fn, mags, signs, ref, track):
    """The entry == the plain version ``ref``, on aligned arrays and on
    arrays 8 bytes off."""
    for misaligned in (False, True):
        got = run_host(fn, mags, signs, track, misaligned)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r.numpy(), err_msg=f"misaligned {misaligned}")


@pytest.mark.parametrize("B", ROWS_BATCHES)
@pytest.mark.parametrize("key", list(CONFIGS))
def test_host_rows_entry_matches_cell_major_and_plain(host_kernels, key, B):
    """The entry == the plain version (the name dates from when a
    cell-major entry stood beside it)."""
    config = CONFIGS[key]
    mags, signs = inputs(config, B, seed=B + len(key))
    ref = fused_matrix_inverse_reference(torch.from_numpy(mags), torch.from_numpy(signs), *config)
    _check_rows_entry(host_kernels[key], mags, signs, ref, False)


@pytest.mark.parametrize("B", ROWS_BATCHES)
@pytest.mark.parametrize("key", TRACKED)
def test_tracked_host_rows_entry_matches_cell_major_and_plain(host_kernels, key, B):
    """The tracked entry == the tracked plain version, flags included (the
    name dates from when a cell-major entry stood beside it)."""
    config = CONFIGS[key]
    mags, signs = overflowy_inputs(config, max(B, 2), seed=B + len(key))
    mags, signs = mags[-B:], signs[-B:]  # B = 1: the all-zero matrix, flagged
    ref = fused_matrix_inverse_reference(
        torch.from_numpy(mags), torch.from_numpy(signs), *config, track=True)
    flags = ref[2].numpy()
    assert flags[0] == 1 and (B == 1 or (flags[1] == 1 and not flags.all()))
    _check_rows_entry(host_kernels[f"t_{key}"], mags, signs, ref, True)


def test_tracked_body_records_what_the_plain_version_records():
    """Emitted under tracking, the body ORs one flag per op that records
    one in the eager tracked circuit, and uses only the windowed multiply."""
    for key in ("high4", "low4"):
        config = CONFIGS[key]
        src = emit_body(*config, track=True)
        mags, signs = overflowy_inputs(config, 4, seed=1)
        with track_overflow() as tracker:
            fused_matrix_inverse_reference(torch.from_numpy(mags), torch.from_numpy(signs), *config)
        assert src.count("ovf |= ") == len(tracker.flags)
        assert "#define FUSED_TRACK 1" in src and "mul<" not in src
        assert "FUSED_TRACK" not in emit_body(*config)


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
    # tracked ("t_"): every case again, emitted and run under tracking, and
    # the widest window, whose partial sums can pass 2**64
    cases += [(f"t_{name}", *rest) for name, *rest in cases]
    cases.append(("t_mul_wide62", (62, 62), (62, 62), 2,
                  lambda a, b, v: qf_from_mul(a, b, 62, 62)))
    return cases


OP_CASES = _op_cases()


def _emit_op(name, fa, fb, base, op):
    track = name.startswith("t_")
    em = Emitter(track)
    a = EmitQFloat(em, "(uint64_t)am[i]", *fa, base, Sym(em, "(int)as[i]"))
    b = EmitQFloat(em, "(uint64_t)bm[i]", *fb, base, Sym(em, "(int)bs[i]"))
    out = op(a, b, Sym(em, "(int)v[i]"))
    if isinstance(out, EmitQFloat):
        tail = f"om[i] = (int64_t){out.mag}; os[i] = {out.sign.name if isinstance(out.sign, Sym) else out.sign};"
    else:
        tail = f"om[i] = 0; os[i] = {out.name};"
    if track:
        em.lines.insert(0, "int ovf = 0;")
        tail += " of[i] = ovf;"
    body = "".join(f"    {line}\n" for line in em.lines)
    return (
        f'extern "C" void {name}(const int64_t* am, const int64_t* as, const int64_t* bm,\n'
        "    const int64_t* bs, const int64_t* v, int64_t* om, int64_t* os, int64_t* of,\n"
        "    int64_t n) {\n"
        "  using namespace qcell;\n"
        f"  for (int64_t i = 0; i < n; ++i) {{\n{body}    {tail}\n  }}\n}}\n"
    )


def _build_ops(d, cases, defines=()):
    """One g++ build of the single-op ``cases`` with the build switches
    ``defines`` (``NAME=value``)."""
    src = '#include "qfloat_cell.cuh"\n' + "".join(_emit_op(*c) for c in cases)
    (d / "ops.cc").write_text(src)
    subprocess.run(
        ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC),
         *(f"-D{define}" for define in defines), "-o", str(d / "ops.so"), str(d / "ops.cc")],
        check=True, capture_output=True, text=True, timeout=300,
    )
    return ctypes.CDLL(str(d / "ops.so"))


@pytest.fixture(scope="module")
def host_ops(tmp_path_factory):
    """Every single-op case in one g++ build, with the build's own
    switches: both multiplies compiled once per format and called."""
    return _build_ops(tmp_path_factory.mktemp("ops_host"), OP_CASES)


# The other forms of the windowed multiply (csrc/qfloat_cell.cuh): inlined
# as first ported, and split sums, with accumulator counts that do and do
# not divide the row count, with and without the net shift.
MUL_WINDOW_FORMS = {
    "inlined": ("QCELL_MUL_WINDOW_INLINE=1",),
    "two_accumulators": ("QCELL_MUL_WINDOW_ACCS=2",),
    "four_accumulators_net": ("QCELL_MUL_WINDOW_ACCS=4", "QCELL_MUL_WINDOW_NET=1"),
    "three_accumulators_net_inlined": ("QCELL_MUL_WINDOW_INLINE=1", "QCELL_MUL_WINDOW_ACCS=3",
                                       "QCELL_MUL_WINDOW_NET=1"),
}
TRACKED_MUL_CASES = [c for c in OP_CASES if c[0].startswith("t_") and "mul" in c[0]
                     and not c[0].startswith("t_sb_")]


@pytest.fixture(scope="module")
def host_ops_forms(tmp_path_factory):
    """The tracked multiplies once per form of ``MUL_WINDOW_FORMS``."""
    return {form: _build_ops(tmp_path_factory.mktemp(f"ops_{form}"), TRACKED_MUL_CASES, defines)
            for form, defines in MUL_WINDOW_FORMS.items()}


def _rand_cell(rng, B, fmt, base):
    bits = base.bit_length() - 1
    mags = rng.randint(0, 1 << 62, size=B, dtype=np.int64) & ((1 << (bits * fmt[0])) - 1)
    mags[:3] = [0, 0, (1 << (bits * fmt[0])) - 1]  # zero divisors, all-ones
    signs = rng.choice([-1, 0, 1], size=B).astype(np.int64)
    return mags, signs


def run_op(host_ops, case, am, as_, bm, bs, v):
    """One emitted op over the batch and the same op on PackedQFloat cells
    (under ``track_overflow()`` for a tracked case); returns both outputs,
    the flags from the combined tracker or 0."""
    name, fa, fb, base, op = case
    B = len(am)
    om, os_, of = (np.empty(B, np.int64) for _ in range(3))
    fn = getattr(host_ops, name)
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64]
    fn(*(x.ctypes.data for x in (am, as_, bm, bs, v, om, os_, of)), B)
    t = torch.from_numpy
    track = name.startswith("t_")
    with track_overflow() if track else nullcontext() as tracker:
        ref = op(
            PackedQFloat(t(am), *fa, base, t(as_)),
            PackedQFloat(t(bm), *fb, base, t(bs)),
            t(v),
        )
    ref_flags = tracker.combined((B,)).numpy() if track else 0
    return (om, os_, of if track else 0), (ref, ref_flags)


@pytest.mark.parametrize("case", OP_CASES, ids=[c[0] for c in OP_CASES])
def test_emitted_op_matches_packed(host_ops, case):
    name, fa, fb, base, _ = case
    rng = np.random.RandomState(len(name))
    B = 257
    am, as_ = _rand_cell(rng, B, fa, base)
    bm, bs = _rand_cell(rng, B, fb, base)
    # a + b = -base**len: the tidy drops the carry to magnitude 0, sign +1
    am[3], as_[3], bm[3], bs[3] = (1 << ((base.bit_length() - 1) * fa[0])) - 1, -1, 1, -1
    v = rng.choice([-1, 0, 1], size=B).astype(np.int64)
    (om, os_, of), (ref, ref_flags) = run_op(host_ops, case, am, as_, bm, bs, v)
    np.testing.assert_array_equal(of, ref_flags)
    if isinstance(ref, PackedQFloat):
        np.testing.assert_array_equal(om, ref.mag.numpy())
        np.testing.assert_array_equal(os_, np.broadcast_to(np.asarray(ref.sign), B))
    else:
        np.testing.assert_array_equal(os_, ref.numpy())


@pytest.mark.parametrize("form", list(MUL_WINDOW_FORMS))
@pytest.mark.parametrize("case", TRACKED_MUL_CASES, ids=[c[0] for c in TRACKED_MUL_CASES])
def test_mul_window_forms_match_packed(host_ops_forms, case, form):
    """Every form of the windowed multiply gives ``PackedQFloat``'s tracked
    product, value and flag."""
    name, fa, fb, base, _ = case
    rng = np.random.RandomState(len(name) + len(form))
    B = 129
    am, as_ = _rand_cell(rng, B, fa, base)
    bm, bs = _rand_cell(rng, B, fb, base)
    v = np.ones(B, np.int64)
    (om, os_, of), (ref, ref_flags) = run_op(host_ops_forms[form], case, am, as_, bm, bs, v)
    np.testing.assert_array_equal(of, ref_flags)
    np.testing.assert_array_equal(om, ref.mag.numpy())
    np.testing.assert_array_equal(os_, np.broadcast_to(np.asarray(ref.sign), B))


@pytest.mark.parametrize("form", list(MUL_WINDOW_FORMS))
def test_mul_window_forms_wrap_at_2_64(host_ops_forms, form):
    """Split over accumulators or not, the sum wraps at 2**64 (see
    ``test_emitted_mul_window_wraps_at_2_64``)."""
    case = next(c for c in OP_CASES if c[0] == "t_mul_wide62")
    am = np.array([31, 15, 1, 0], np.int64)
    bm = np.full(4, (1 << 62) - 1, np.int64)
    ones = np.ones(4, np.int64)
    (om, _, of), (ref, ref_flags) = run_op(host_ops_forms[form], case, am, ones, bm, ones, ones)
    np.testing.assert_array_equal(of, [0, 1, 0, 0])
    np.testing.assert_array_equal(ref_flags, of)
    np.testing.assert_array_equal(om, ref.mag.numpy())


def test_emitted_mul_window_wraps_at_2_64(host_ops):
    """``mul_window_t`` sums in uint64_t: a = 31 times b = 2**62 - 1 at
    (62, 62) has five cropped partial products whose sum passes 2**64 and
    leaves no bit above the window, so it is not flagged (a = 15, four
    products below 2**64, is)."""
    case = next(c for c in OP_CASES if c[0] == "t_mul_wide62")
    am = np.array([31, 15, 1, 0], np.int64)
    bm = np.full(4, (1 << 62) - 1, np.int64)
    ones = np.ones(4, np.int64)
    (om, _, of), (ref, ref_flags) = run_op(host_ops, case, am, ones, bm, ones, ones)
    np.testing.assert_array_equal(of, [0, 1, 0, 0])
    np.testing.assert_array_equal(ref_flags, of)
    np.testing.assert_array_equal(om, ref.mag.numpy())
