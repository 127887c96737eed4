"""The fused kernel's one layout and its wrapper, on the CPU.

``csrc/fused_inverse.cu`` built with g++ as host C++, untracked and
tracked, must give the plain version's outputs bit for bit, magnitudes,
signs and flags, through its one entry, which takes the callers' ``(B,
n*n)`` arrays.  K1's sources take no build switch but their configuration.
The wrapper's handling of views is held on the CPU route, where
``fused_matrix_inverse`` runs the plain version.
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

torch.set_num_threads(2)

CONFIG = (4, 40, 20, 2, True)  # HIGH n=4
BATCH = 203  # two blocks of 128, the last ragged and odd
K1_SOURCES = ("fused_inverse.cu", "fused_inverse_lanes.cu", "qfloat_cell.cuh")
# what K1's sources may test: the compiler, and the configuration that
# ops/fused_inverse.py and ops/emit.py give them; the windowed multiply's
# forms, which tests/test_torch_emit.py holds to the same bits
CONFIG_MACRO = re.compile(r"__CUDACC__|FUSED_TRACK|FUSED_N2|LANES_\w+|QCELL_MUL_WINDOW_\w+")


@pytest.fixture(scope="module")
def port_libraries(tmp_path_factory):
    """The port's build of each variant, with g++, both at once."""
    root = tmp_path_factory.mktemp("k1_host")
    procs = {}
    for track in (False, True):
        d = root / str(int(track))
        d.mkdir()
        (d / "fused_body.inc").write_text(emit_body(*CONFIG, track=track))
        cmd = ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-x", "c++", "-I", str(CSRC),
               "-I", str(d), "-o", str(d / "lib.so"), str(CSRC / "fused_inverse.cu")]
        procs[track] = (d, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True))
    libs = {}
    for track, (d, proc) in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"g++ failed for track={track}:\n{err}"
        libs[track] = ctypes.CDLL(str(d / "lib.so"))
    return libs


def _run(lib, track, mags, signs):
    """The host entry on (B, n*n) arrays."""
    om, os_ = np.empty_like(mags), np.empty_like(signs)
    flags = np.zeros(mags.shape[0], np.int32)
    ptrs = [mags.ctypes.data, signs.ctypes.data, om.ctypes.data, os_.ctypes.data]
    if track:
        ptrs.append(flags.ctypes.data)
    fn = getattr(lib, "fused_inverse_tracked_host" if track else "fused_inverse_host")
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int64]
    fn.restype = ctypes.c_int
    assert fn(*ptrs, mags.shape[0]) == 0
    return om, os_, flags


def _inputs(batch, seed):
    n, length, ints, base, _ = CONFIG
    M = np.random.RandomState(seed).randn(batch, n, n) * 100
    M[0, 1] = M[0, 0] * (1 + 1e-12)  # near-singular: overflows
    M[1] = 0.0  # divisions by zero saturate
    return float_matrix_to_mags_and_signs(M, length, ints, base)


@pytest.mark.parametrize("track", [False, True])
def test_the_ports_build_equals_the_plain_version(port_libraries, track):
    mags, signs = _inputs(BATCH, seed=7)
    got = _run(port_libraries[track], track, mags, signs)
    ref = fused_inverse.fused_matrix_inverse_reference(
        torch.from_numpy(mags), torch.from_numpy(signs), *CONFIG, track=track)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r.numpy())
    if track:
        assert got[2][0] == 1 and got[2][1] == 1 and not got[2].all()


def test_every_define_is_a_switch_of_the_sources():
    """Every macro that K1's sources test is the compiler's or part of the
    configuration: a build switch would be a second kernel that the port
    never launches."""
    for name in K1_SOURCES:
        for line in (CSRC / name).read_text().splitlines():
            m = re.match(r"\s*#\s*(?:if|ifdef|ifndef|elif)\b(.*)", line)
            if not m:
                continue
            for macro in set(re.findall(r"[A-Za-z_]\w*", m.group(1))) - {"defined"}:
                assert CONFIG_MACRO.fullmatch(macro), f"{name}: {line.strip()}"


@pytest.mark.parametrize("track", [False, True])
def test_wrapper_takes_any_view_on_the_cpu_route(track):
    """``fused_matrix_inverse`` on CPU tensors (the plain version): leading
    batch axes, one matrix, and a view that is not contiguous give the rows
    of the flat contiguous call."""
    mags, signs = (torch.from_numpy(x) for x in _inputs(12, seed=3))
    ref = fused_inverse.fused_matrix_inverse(mags, signs, *CONFIG, track=track)
    got = fused_inverse.fused_matrix_inverse(
        mags.reshape(3, 4, 16), signs.reshape(3, 4, 16), *CONFIG, track=track)
    for g, r in zip(got, ref):
        assert torch.equal(g.reshape(r.shape), r)
    wide_m, wide_s = torch.cat([mags, mags], 1), torch.cat([signs, signs], 1)
    got = fused_inverse.fused_matrix_inverse(wide_m[:, :16], wide_s[:, :16], *CONFIG, track=track)
    one = fused_inverse.fused_matrix_inverse(mags[5:6], signs[5:6], *CONFIG, track=track)
    for g, o, r in zip(got, one, ref):
        assert torch.equal(g, r) and torch.equal(o, r[5:6])
    if track:
        assert ref[2].dtype == torch.int32 and ref[2].shape == (12,)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """On a tensor that is not on the CPU the wrapper launches or raises: a
    meta tensor is refused, never sent to the plain version."""
    meta = torch.zeros(4, 16, dtype=torch.int64, device="meta")
    for track in (False, True):
        with pytest.raises(ValueError, match="CUDA device"):
            fused_inverse.fused_matrix_inverse(meta, meta, *CONFIG, track=track)
    p = mt.HIGH.replace(n=4)
    assert CONFIG == (p.n, p.qfloat_len, p.qfloat_ints, p.qfloat_base, p.true_division)
