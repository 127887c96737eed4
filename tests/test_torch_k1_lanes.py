"""K1's lanes design (``csrc/fused_inverse_lanes.cu``), which serves n >=
``LANES_MIN_N`` on the card, and ``lowering="fused"`` at any n.

The kernel compiles as host C++ when ``__CUDACC__`` is not defined: every
step of the card's kernel runs as a loop over a block's threads, the
tiles in a heap buffer.  Built here with g++ (several at once) at HIGH n =
3..16, untracked and tracked, LOW n = 10 (the reciprocal path) and 13, and
the Medium formats (31 digits, 16 before the dot; MEDIUM with reciprocals,
MEDIUM_PLUS with true division) at n = 7 and 12, untracked and tracked,
from the same ``-D`` macros as the port's builds, it takes a ragged batch
of 37 seeded matrices: a singular one, a near-singular one, an all-zero
one, a pivot column with ties, magnitudes above the mask, cells of sign 0
and, for the tracked variant, overflowing ones.  Its ``(B, n*n)`` entry
must equal, with tolerance 0 on magnitudes, signs and flags, the port's
plain version and the JAX package's
``lowering="scan"`` (jitted; its CPU compile takes 3-12 s a size up to n =
16).  LOW n = 33, past a warp (one block a matrix), is held to the plain
version on 3 matrices.  A group is n lanes and a warp floor(32/n) groups,
so batches that end part-way through a warp's groups (HIGH n = 9 and 10 at
40 matrices, 12 a block; tracked HIGH n = 6 at 23, 20 a block) are held to
the plain version and JAX too.

The host build counts its calls of each primitive: equal to the emitted
straight-line body's tally (``Emitter.ops``) less what the design provably
removes, n*n*(n-2) ``sadd`` of the permutation's one-hot chains (a gather
and one ``sadd`` a cell, shown equal to the chain below) and n duplicate
reciprocals.  The repair: ``BatchedMatrixInversion(lowering="fused")`` at
LOW n = 13 equals JAX's scan lowering and at HIGH n = 16 (tracked) the
op-by-op path, where both raised before.
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
from matrix_inversion_tpu_torch.models import inverse as port_inverse
from matrix_inversion_tpu_torch.models.marshal import (
    float_matrix_to_mags_and_signs,
    mags_and_signs_to_qfloat_matrix,
)
from matrix_inversion_tpu_torch.models.qfloat_lu import (
    qfloat_list_matrix_multiply,
    qfloat_pivot_binary,
)
from matrix_inversion_tpu_torch.ops import fused_inverse
from matrix_inversion_tpu_torch.ops.emit import emit_circuit
from matrix_inversion_tpu_torch.ops.fused_inverse import CSRC, fused_matrix_inverse_reference
from matrix_inversion_tpu_torch.ops.packed import PackedQFloat, track_overflow

torch.set_num_threads(2)

B = 37  # ragged: no block of the card's kernel is full
BUILDS_AT_ONCE = 6
# (label, preset, n, tracked)
SIZES = ([(f"high{n}", "high", n, False) for n in range(3, 17)]
         + [(f"high{n}_tracked", "high", n, True) for n in range(3, 17)]
         + [(f"low{n}{suffix}", "low", n, track) for n in (10, 13)
            for suffix, track in (("", False), ("_tracked", True))]
         + [(f"{label}{n}", preset, n, False) for n in (7, 12)
            for label, preset in (("medium", "medium"), ("medium_plus", "medium+"))]
         + [(f"{label}{n}_tracked", preset, n, True) for n in (7, 12)
            for label, preset in (("medium", "medium"), ("medium_plus", "medium+"))])
WIDE = ("low33", "low", 33, False)  # past a warp: one block a matrix
WIDE_BATCH = 3
# (label, batch): batches whose last block's last warp holds only some of
# its groups, built as the SIZES of the same label
PART_WARP = [("high9", 40), ("high10", 40), ("high6_tracked", 23)]
# the host build's counters, in the order of fused_inverse_lanes_counts
PRIMS = ("sadd", "mul", "divide", "invert", "gt", "blend")
TRACKED_PRIMS = {"sadd": "sadd_t", "mul": "mul_window_t", "divide": "divide_t",
                 "invert": "invert_t"}


def _config(preset, n):
    p = mt.PRESETS[preset].replace(n=n)
    return (n, p.qfloat_len, p.qfloat_ints, p.qfloat_base, p.true_division)


def _build(root, label, config, track):
    d = root / label
    d.mkdir()
    defines = fused_inverse.lanes_defines(fused_inverse._key(config + (track,)))
    cmd = ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-x", "c++",
           *(f"-D{x}" for x in defines), "-I", str(CSRC), "-o", str(d / "lib.so"),
           str(CSRC / "fused_inverse_lanes.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, f"g++ failed for {label}:\n{proc.stderr}"
    lib = ctypes.CDLL(str(d / "lib.so"))
    fn = getattr(lib, "fused_inverse_lanes_tracked_host" if track else "fused_inverse_lanes_host")
    fn.argtypes = [ctypes.c_void_p] * (5 if track else 4) + [ctypes.c_int64]
    fn.restype = ctypes.c_int
    lib.fused_inverse_lanes_counts.argtypes = [ctypes.c_void_p]
    return lib, fn


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """``{label: (library, host entry)}``, one g++
    build each, ``BUILDS_AT_ONCE`` at a time, the largest first."""
    root = tmp_path_factory.mktemp("k1_lanes")
    order = sorted(SIZES + [WIDE], key=lambda s: -s[2])
    with concurrent.futures.ThreadPoolExecutor(BUILDS_AT_ONCE) as pool:
        futures = {label: pool.submit(_build, root, label, _config(preset, n), track)
                   for label, preset, n, track in order}
        return {label: f.result() for label, f in futures.items()}


def _inputs(config, track, seed, batch=B):
    """Random x100 matrices: 5 singular (a row the sum of two others), 6
    near-singular, 7 all zero, 8 a first column of equal magnitudes (ties
    in the first scan), 9 ties in its second column below the diagonal, 10
    magnitudes with bits above the mask; about 5% of the cells of sign 0
    (none in matrices 0 and 1).
    Tracked, 0 near-singular and 1 all zero, whose inverses overflow."""
    n, length, ints, base, _ = config
    rng = np.random.RandomState(seed)
    M = rng.randn(batch, n, n) * 100
    if batch > 10:
        M[5, 2] = M[5, 0] + M[5, 1]
        M[6, 1] = M[6, 0] * (1 + 1e-9)
        M[7] = 0.0
        M[8, :, 0] = M[8, 0, 0] * np.where(np.arange(n) % 2, -1, 1)
        M[9, 1:, 1] = M[9, 1, 1]
    if track:
        M[0, 1] = M[0, 0] * (1 + 1e-12)
        M[1] = 0.0
    mags, signs = float_matrix_to_mags_and_signs(M, length, ints, base)
    if batch > 10:
        mask_bits = length * (base.bit_length() - 1)
        mags[10, ::3] |= 1 << mask_bits
        mags[10, 1::5] += 5 << (mask_bits + 2)
    sign0 = rng.rand(*signs.shape) < 0.05
    sign0[:2] = False  # the overflowing matrices keep their rows
    signs[sign0] = 0
    return mags, signs


def _run_host(entries, mags, signs, track):
    """The host entry on (B, n*n) arrays: its outputs."""
    _, fn = entries
    batch = mags.shape[0]
    om, os_ = np.empty_like(mags), np.empty_like(signs)
    flags = np.full(batch, -1, np.int32)
    ptrs = [mags.ctypes.data, signs.ctypes.data, om.ctypes.data, os_.ctypes.data]
    if track:
        ptrs.append(flags.ctypes.data)
    assert fn(*ptrs, batch) == 0
    return (om, os_, flags) if track else (om, os_)


@functools.lru_cache(maxsize=None)
def _jax_scan(config, track):
    body = (jax_inverse.qfloat_matrix_inverse_with_overflow if track
            else jax_inverse.qfloat_matrix_inverse_packed_io)
    return jax.jit(functools.partial(body, n=config[0], qfloat_len=config[1],
                                     qfloat_ints=config[2], qfloat_base=config[3],
                                     true_division=config[4], lowering="scan"))


@functools.lru_cache(maxsize=None)
def _case(preset, n, track, batch=B):
    """The inputs of one size and their plain version's outputs, shared by
    the tests that take them."""
    config = _config(preset, n)
    mags, signs = _inputs(config, track, seed=300 + 2 * n + track, batch=batch)
    plain = fused_matrix_inverse_reference(torch.from_numpy(mags), torch.from_numpy(signs),
                                           *config, track=track)
    return mags, signs, plain


@pytest.mark.parametrize("label,preset,n,track", SIZES, ids=[s[0] for s in SIZES])
def test_lanes_host_build_matches_jax_scan_and_the_plain_version(host_kernels, label, preset, n,
                                                                 track):
    config = _config(preset, n)
    assert mi.PRESETS[preset].qfloat_len == config[1]
    mags, signs, plain = _case(preset, n, track)
    want = [np.asarray(x) for x in _jax_scan(config, track)(jnp.asarray(mags), jnp.asarray(signs))]
    for w, p in zip(want, plain):
        np.testing.assert_array_equal(p.numpy(), w)
    for g, w in zip(_run_host(host_kernels[label], mags, signs, track), want):
        np.testing.assert_array_equal(g, w)
    if track:
        flags = want[2]
        assert flags.dtype == np.int32 and flags[0] == 1 and flags[1] == 1
        # at LOW n = 13 every x100 matrix's LU overflows LOW's 9 integer digits
        assert flags.all() if preset == "low" and n == 13 else not flags.all()


@pytest.mark.parametrize("label,batch", PART_WARP, ids=[f"{s[0]}_b{s[1]}" for s in PART_WARP])
def test_lanes_batch_ending_inside_a_warp_matches_jax_and_the_plain_version(host_kernels, label,
                                                                            batch):
    """The last block's last warp holds only some of its floor(32/n)
    groups: those past the batch run on zeros, and the lanes after the
    warp's last group belong to none."""
    _, preset, n, track = next(s for s in SIZES if s[0] == label)
    lib, _ = host_kernels[label]
    per_warp = 32 // n
    assert lib.fused_inverse_lanes_mats_per_block() == 4 * per_warp
    assert batch % (4 * per_warp) % per_warp != 0
    config = _config(preset, n)
    mags, signs, plain = _case(preset, n, track, batch)
    want = [np.asarray(x) for x in _jax_scan(config, track)(jnp.asarray(mags), jnp.asarray(signs))]
    got = _run_host(host_kernels[label], mags, signs, track)
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(p.numpy(), w)
        np.testing.assert_array_equal(g, w)
    if track:
        assert want[2][0] == 1 and want[2][1] == 1 and not want[2].all()


def test_lanes_past_a_warp_matches_the_plain_version(host_kernels):
    """LOW n = 33: one block of 64 threads a matrix, block barriers."""
    label, preset, n, track = WIDE
    config = _config(preset, n)
    mags, signs = _inputs(config, track, seed=33, batch=WIDE_BATCH)
    plain = fused_matrix_inverse_reference(torch.from_numpy(mags), torch.from_numpy(signs),
                                           *config)
    for g, p in zip(_run_host(host_kernels[label], mags, signs, track), plain):
        np.testing.assert_array_equal(g, p.numpy())


COUNTED = ["high3", "high6_tracked", "high16", "low10", "low10_tracked", "low13"]


@pytest.mark.parametrize("label", COUNTED)
def test_primitive_counts_are_the_circuits_less_what_the_design_removes(host_kernels, label):
    """Per matrix: the emitted body's tally of each primitive, but n*n*(n-2)
    sadds fewer (P.M: one sadd a cell where the one-hot chain makes n-1)
    and, with reciprocals (LOW), n inverts fewer (the LU's and the
    substitution's reciprocals of U's diagonal are the same values).  The
    emitter's ``int`` statements (signs, the one-hot pivot) and ``flag_or``
    are not calls of primitives; the kernel's own are plain C++."""
    _, preset, n, track = next(s for s in SIZES if s[0] == label)
    config = _config(preset, n)
    lib, fn = host_kernels[label]
    counts = (ctypes.c_int64 * len(PRIMS))()
    lib.fused_inverse_lanes_counts(counts)  # from 0
    mags, signs = _inputs(config, track, seed=5)
    om, os_ = np.empty_like(mags), np.empty_like(signs)
    flags = np.zeros(B, np.int32)
    ptrs = [mags.ctypes.data, signs.ctypes.data, om.ctypes.data, os_.ctypes.data]
    assert fn(*ptrs + ([flags.ctypes.data] if track else []), B) == 0
    lib.fused_inverse_lanes_counts(counts)
    # a block's kMats groups all run, those past the batch on zeros: n
    # lanes a group, as many whole groups a warp as fit
    per_block = lib.fused_inverse_lanes_mats_per_block()
    per_warp = per_block // (lib.fused_inverse_lanes_block_threads() // 32)
    assert per_warp * n <= 32 < (per_warp + 1) * n
    matrices = -(-B // per_block) * per_block
    got = {}
    for prim, count in zip(PRIMS, counts):
        assert count % matrices == 0, (prim, count, matrices)
        if count:
            got[TRACKED_PRIMS.get(prim, prim) if track else prim] = count // matrices
    emitted = dict(emit_circuit(*config, track=track).ops)
    removed = {"sadd": n * n * (n - 2), "invert": 0 if config[4] else n}
    want = {}
    for prim, count in emitted.items():
        if prim in ("int", "flag_or"):
            continue
        base = next((k for k, v in TRACKED_PRIMS.items() if v == prim), prim)
        want[prim] = count - removed.get(base, 0)
    assert got == want
    assert emitted["flag_or" if track else "int"] > 0
    if track:  # every tracked primitive of the body ORs its flag once
        assert emitted["flag_or"] == sum(v for k, v in emitted.items()
                                         if k in TRACKED_PRIMS.values())


@pytest.mark.parametrize("track", [False, True], ids=["untracked", "tracked"])
def test_permutation_gather_equals_the_one_hot_chain(track):
    """P.M as the circuit computes it (each cell a chain of n sign-masked
    sadds along P's one-hot row) equals the kernel's gather: the selected
    cell of M and one sadd with a zero, on cells of sign 0, magnitudes with
    bits above the mask and pivot columns with ties; flags too, tracked."""
    n, length, ints, base, _ = config = _config("low", 6)
    rng = np.random.RandomState(11)
    M = rng.randn(64, n, n) * 100
    M[:16, :, 0] = np.round(M[:16, :, 0] / 150) * 150  # many ties in the first scan
    M[16:32, :, 1] = M[16:32, :1, 1]  # every row of column 1 equal
    mags, signs = float_matrix_to_mags_and_signs(M, length, ints, base)
    mags[::3, ::4] |= 3 << length  # bits above the mask
    signs[rng.rand(*signs.shape) < 0.15] = 0
    assert (signs == 0).any() and (mags >> length).any()
    tm, ts = torch.from_numpy(mags), torch.from_numpy(signs)
    with track_overflow() if track else _no_tracker() as tracker:
        cells = mags_and_signs_to_qfloat_matrix(tm, ts, length, ints, base)
        P = qfloat_pivot_binary(cells)
        chain = qfloat_list_matrix_multiply(P, cells)
    chain_flags = tracker.combined((64,)) if track else None
    perm = [sum(P[i][k].value * k for k in range(n)) for i in range(n)]
    zero = PackedQFloat(torch.zeros(64, dtype=torch.int64), length, ints, base,
                        torch.zeros(64, dtype=torch.int64))
    with track_overflow() if track else _no_tracker() as tracker:
        gathered = []
        for i in range(n):
            rows_m = tm.view(64, n, n)[torch.arange(64), perm[i]]
            rows_s = ts.view(64, n, n)[torch.arange(64), perm[i]]
            row = []
            for j in range(n):
                cell = PackedQFloat(rows_m[:, j], length, ints, base, rows_s[:, j])
                cell += zero
                row.append(cell)
            gathered.append(row)
    assert len(set(perm[0].tolist())) > 1  # the batch takes several rows
    for i in range(n):
        for j in range(n):
            assert torch.equal(chain[i][j].mag, gathered[i][j].mag)
            assert torch.equal(chain[i][j].sign, gathered[i][j].sign)
    if track:
        assert torch.equal(chain_flags, tracker.combined((64,)))
        assert chain_flags.any()


class _no_tracker:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def test_lowering_fused_at_low13_matches_jax_scan():
    """The repair: ``lowering="fused"`` past ``FUSED_MAX_N`` runs (on the
    CPU, the kernel's plain version) and gives JAX's scan lowering bit for
    bit; JAX's own fused kernel takes any n too."""
    p = mt.LOW.replace(n=13, lowering="fused")
    config = _config("low", 13)
    mags, signs, _ = _case("low", 13, False)
    inv = mt.BatchedMatrixInversion(p, B, io="packed", device="cpu")
    got = inv.run_raw(torch.from_numpy(mags), torch.from_numpy(signs))
    want = _jax_scan(config, False)(jnp.asarray(mags), jnp.asarray(signs))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_lowering_fused_at_high16_tracked_matches_the_op_by_op_path():
    """Against the op-by-op circuit's result on the same inputs (its plain
    form, which is what ``lowering="unroll"`` runs on the CPU)."""
    p = mt.HIGH.replace(n=16, lowering="fused")
    mags, signs, want = _case("high", 16, True)
    got = mt.BatchedMatrixInversion(p, B, io="packed", device="cpu", track_overflow=True).run_raw(
        torch.from_numpy(mags), torch.from_numpy(signs))
    assert len(got) == 3 and got[2].tolist()[:2] == [1, 1]
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_auto_routes_as_before_and_fused_takes_any_n():
    cuda = torch.device("cuda")  # a device object only: nothing runs on it
    for n in (2, 5, 6, 12):
        assert port_inverse._resolve_lowering("auto", n, cuda) == "fused"
        assert port_inverse._resolve_lowering("auto", n, torch.device("cpu")) == "op_by_op"
    for n in (13, 16, 40):
        assert port_inverse._resolve_lowering("auto", n, cuda) == "op_by_op"
        assert port_inverse._resolve_lowering("fused", n, cuda) == "fused"
    assert fused_inverse.FUSED_MAX_N == jax_inverse.FUSED_MAX_N == 12


@pytest.mark.parametrize("track", [False, True], ids=["untracked", "tracked"])
def test_designs_and_their_names(track):
    """The straight-line design below ``LANES_MIN_N`` (tracked:
    ``LANES_MIN_N_TRACKED``; n = 2's closed form among it), the lanes design
    from it; the lanes design has no n = 2."""
    first = fused_inverse.LANES_MIN_N_TRACKED if track else fused_inverse.LANES_MIN_N
    assert 3 <= first <= fused_inverse.STRAIGHT_LINE_MAX_N
    for n in range(2, 20):
        want = "lanes" if n >= first else "straight_line"
        assert fused_inverse.design_of(n, track) == want
        key = fused_inverse._key(_config("high", n) + (track,))
        assert fused_inverse._design(key, None) == want
    with pytest.raises(ValueError, match="n >= 3"):
        fused_inverse._design(fused_inverse._key(_config("high", 2)), "lanes")
    with pytest.raises(ValueError, match="unknown design"):
        fused_inverse._design(fused_inverse._key(_config("high", 6)), "unrolled")
    assert fused_inverse.lanes_defines(fused_inverse._key(_config("low", 10) + (True,))) == (
        "LANES_N=10", "LANES_BITS=1", "LANES_LEN=23", "LANES_INTS=9", "LANES_TRUE_DIV=0",
        "LANES_TRACK=1")


def test_drivers_time_both_designs_where_both_exist():
    """``fused(designs=...)`` adds each design's variants where it exists
    (straight-line up to ``STRAIGHT_LINE_MAX_N``, lanes from n = 3) and
    names the design that served ``fused``; ``rooflines`` reads either; the
    ``lowering`` driver takes n past ``FUSED_MAX_N`` with "fused".  On the
    CPU each runs the plain version."""
    from matrix_inversion_tpu_torch.utils import run_benchmarks

    got = run_benchmarks.fused(sizes=(3, 13), batch=2, reps=1, repeats=1, tracked=True,
                               unroll_sizes=(), designs=fused_inverse.DESIGNS, device="cpu")
    assert set(got) == {"high/n=3/fused", "high/n=3/fused_tracked",
                        "high/n=3/fused_straight_line", "high/n=3/fused_straight_line_tracked",
                        "high/n=3/fused_lanes", "high/n=3/fused_lanes_tracked",
                        "high/n=13/fused", "high/n=13/fused_tracked",
                        "high/n=13/fused_lanes", "high/n=13/fused_lanes_tracked"}
    assert got["high/n=3/fused"]["design"] == fused_inverse.design_of(3) == "straight_line"
    assert got["high/n=13/fused"]["design"] == "lanes"
    assert got["high/n=3/fused_straight_line_tracked"]["design"] == "straight_line"
    table = run_benchmarks.rooflines(got, design="lanes", track=True)
    assert list(table) == ["n=3", "n=13"]
    lowered = run_benchmarks.lowering(sizes=(13,), batch=2, reps=1, repeats=1, device="cpu")
    assert lowered["n=13/fused"]["design"] == "lanes" and "design" not in lowered["n=13/unroll"]
