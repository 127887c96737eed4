"""The design steps of the fused kernel, on the CPU.

``utils/fused_steps.py`` builds ``csrc/fused_inverse.cu`` under other build
switches than the port's, for timing on the card.  Here every such build is
made with g++ as host C++ and must give the port's own build's outputs bit
for bit, magnitudes, signs and flags, through both layouts: the switches
change how the kernel computes, never what.  The wrapper's handling of the
layouts is held on the CPU route, where ``fused_matrix_inverse`` runs the
plain version.
"""

import ctypes
import re
import subprocess

import numpy as np
import pytest
import torch

import matrix_inversion_tpu_torch as mt
from matrix_inversion_tpu_torch.models.marshal import float_matrix_to_mags_and_signs
from matrix_inversion_tpu_torch.ops import fused_inverse
from matrix_inversion_tpu_torch.ops.emit import emit_body
from matrix_inversion_tpu_torch.ops.fused_inverse import CSRC
from matrix_inversion_tpu_torch.utils import fused_steps

torch.set_num_threads(2)

BUILDS = sorted({(track, defines) for _, track, defines, _ in fused_steps.STEPS})
BATCH = 203  # two blocks of 128 or four of 64, the last ragged and odd


def _id(build):
    return ("tracked " if build[0] else "untracked ") + (" ".join(build[1]) or "no define")


@pytest.fixture(scope="module")
def step_libraries(tmp_path_factory):
    """One g++ build per distinct (track, defines) of the steps, all at once."""
    root = tmp_path_factory.mktemp("fused_steps_host")
    procs = {}
    for i, (track, defines) in enumerate(BUILDS):
        d = root / str(i)
        d.mkdir()
        (d / "fused_body.inc").write_text(emit_body(*fused_steps.CONFIG, track=track))
        cmd = ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-x", "c++", "-I", str(CSRC),
               "-I", str(d), *(f"-D{define}" for define in defines), "-o", str(d / "lib.so"),
               str(CSRC / "fused_inverse.cu")]
        procs[(track, defines)] = (d, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True))
    libs = {}
    for build, (d, proc) in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"g++ failed for {_id(build)}:\n{err}"
        libs[build] = ctypes.CDLL(str(d / "lib.so"))
    return libs


def _run(lib, track, mags, signs, cell_major):
    """The host entry of one layout on (B, n*n) arrays; outputs as (B, n*n)."""
    m, s = (np.ascontiguousarray(x.T if cell_major else x) for x in (mags, signs))
    om, os_ = np.empty_like(m), np.empty_like(s)
    flags = np.zeros(mags.shape[0], np.int32)
    ptrs = [m.ctypes.data, s.ctypes.data, om.ctypes.data, os_.ctypes.data]
    if track:
        ptrs.append(flags.ctypes.data)
    stem = "fused_inverse_tracked" if track else "fused_inverse"
    fn = getattr(lib, stem + ("_host" if cell_major else "_rows_host"))
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int64] + ([] if cell_major else [ctypes.c_int])
    fn.restype = ctypes.c_int
    assert fn(*ptrs, mags.shape[0], *(() if cell_major else (-1,))) == 0
    return (om.T, os_.T, flags) if cell_major else (om, os_, flags)


def _inputs(batch, seed):
    n, length, ints, base, _ = fused_steps.CONFIG
    M = np.random.RandomState(seed).randn(batch, n, n) * 100
    M[0, 1] = M[0, 0] * (1 + 1e-12)  # near-singular: overflows
    M[1] = 0.0  # divisions by zero saturate
    return float_matrix_to_mags_and_signs(M, length, ints, base)


@pytest.mark.parametrize("build", BUILDS, ids=_id)
def test_step_build_equals_the_ports_build(step_libraries, build):
    track, defines = build
    mags, signs = _inputs(BATCH, seed=len(defines))
    expected = _run(step_libraries[(track, ())], track, mags, signs, cell_major=False)
    assert not track or (expected[2][0] == 1 and expected[2][1] == 1 and not expected[2].all())
    for cell_major in (False, True):
        got = _run(step_libraries[build], track, mags, signs, cell_major)
        for g, e in zip(got, expected):
            np.testing.assert_array_equal(g, e)


@pytest.mark.parametrize("track", [False, True])
def test_the_ports_build_equals_the_plain_version(step_libraries, track):
    mags, signs = _inputs(BATCH, seed=7)
    got = _run(step_libraries[(track, ())], track, mags, signs, cell_major=False)
    ref = fused_inverse.fused_matrix_inverse_reference(
        torch.from_numpy(mags), torch.from_numpy(signs), *fused_steps.CONFIG, track=track)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r.numpy())


def test_every_define_is_a_switch_of_the_sources():
    """A step's ``NAME=value`` must name a macro that the sources test with
    ``#ifndef``/``#ifdef``: a misspelt one would build the port's own kernel
    under another label."""
    sources = (CSRC / "fused_inverse.cu").read_text() + (CSRC / "qfloat_cell.cuh").read_text()
    switches = set(re.findall(r"#\s*if(?:n?def)?\s+(?:!\s*defined\s*\(\s*)?([A-Z_0-9]+)", sources))
    for label, _, defines, mode in fused_steps.STEPS + fused_steps.SIZE_STEPS:
        assert mode in (fused_steps.CELL_MAJOR, fused_steps.ROWS_STAGED, fused_steps.ROWS_DIRECT)
        for define in defines:
            name, _, value = define.partition("=")
            assert name in switches and value.isdigit(), f"{label}: {define}"
    for steps in (fused_steps.STEPS, fused_steps.SIZE_STEPS):
        labels = [label for label, *_ in steps]
        assert len(labels) == len(set(labels))
    # the port's own kernel is among the steps, in the layout run_raw gives it
    assert any(defines == () and mode == fused_steps.ROWS_STAGED and not track
               for _, track, defines, mode in fused_steps.STEPS)
    assert any(defines == () and mode == fused_steps.ROWS_STAGED and track
               for _, track, defines, mode in fused_steps.STEPS)


def test_steps_take_cuda_tensors_only():
    mags, signs = (torch.from_numpy(x) for x in _inputs(4, seed=1))
    out = [torch.empty_like(mags), torch.empty_like(signs)]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fused_steps.run_step(False, (), fused_steps.ROWS_STAGED, mags, signs, out)
    assert fused_steps.main([]) == 1  # no card here: no result


@pytest.mark.parametrize("track", [False, True])
def test_wrapper_takes_any_view_on_the_cpu_route(track):
    """``fused_matrix_inverse`` on CPU tensors (the plain version): leading
    batch axes, one matrix, and a view that is not contiguous give the rows
    of the flat contiguous call."""
    config = fused_steps.CONFIG
    mags, signs = (torch.from_numpy(x) for x in _inputs(12, seed=3))
    ref = fused_inverse.fused_matrix_inverse(mags, signs, *config, track=track)
    got = fused_inverse.fused_matrix_inverse(
        mags.reshape(3, 4, 16), signs.reshape(3, 4, 16), *config, track=track)
    for g, r in zip(got, ref):
        assert torch.equal(g.reshape(r.shape), r)
    wide_m, wide_s = torch.cat([mags, mags], 1), torch.cat([signs, signs], 1)
    got = fused_inverse.fused_matrix_inverse(wide_m[:, :16], wide_s[:, :16], *config, track=track)
    one = fused_inverse.fused_matrix_inverse(mags[5:6], signs[5:6], *config, track=track)
    for g, o, r in zip(got, one, ref):
        assert torch.equal(g, r) and torch.equal(o, r[5:6])
    if track:
        assert ref[2].dtype == torch.int32 and ref[2].shape == (12,)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """On a tensor that is not on the CPU the wrapper launches or raises: a
    meta tensor is refused, never sent to the plain version."""
    config = fused_steps.CONFIG
    meta = torch.zeros(4, 16, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        fused_inverse.fused_matrix_inverse(meta, meta, *config)
    with pytest.raises(ValueError, match="CUDA device"):
        fused_inverse.fused_inverse_cell_major(meta.t(), meta.t(), *config)
    p = mt.HIGH.replace(n=4)
    assert config == (p.n, p.qfloat_len, p.qfloat_ints, p.qfloat_base, p.true_division)


def test_run_raw_times_needs_a_card():
    """The end-to-end timing script measures the card: without one it
    prints no result."""
    from matrix_inversion_tpu_torch.utils import run_raw_times

    assert run_raw_times.main([]) == 1
    assert [shape[0] for shape in run_raw_times.SHAPES] == [
        "HIGH n=4", "HIGH n=4 tracked", "HIGH n=16"]
