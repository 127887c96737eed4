"""Issue-rate probes (K5): op-mix chains timed on the card.

Replaces ``benchmarks/ubench_vpu.py`` (``_make_kernel``/``_build``, the
Pallas probes).  Measures nominal ops/s per primitive mix inside a
straight-line CUDA kernel (``csrc/ubench.cu``): the calibration source of
the measured-rate roofline (``utils/roofline.py::kernel_roofline``).
Methodology, as in the JAX module:

* every iteration is a mutual recurrence ``x = op(x, y); y = op(y, x)``
  (Fibonacci-style data flow); an algebraically foldable chain like
  ``x = x + y`` repeated K times would collapse and measure nothing;
* two K values are timed and differenced, cancelling the launch and the
  load and store of inputs and outputs;
* C independent chains per element separate throughput from dependency
  latency.

The nine uint32/float32 mixes of the JAX module keep their names, their
arithmetic and their constants.  Four further mixes chain the cell
primitives of ``csrc/qfloat_cell.cuh`` at the High format (base 2, 40
digits, 20 integer) on int64 words below 2**40, because the fused kernel's
body on the card is calls to those primitives: ``cell_mul`` (two truncated
multiplies), ``cell_sadd`` (a signed subtract and a signed add, the signs
carried with the magnitudes), ``cell_mul_window_t`` (two tracked windowed
multiplies, the OR of their flags put at bit 40 of the output) and
``cell_divide`` (two true divisions).  ``cell_divide`` ORs 2**39 into each
dividend and 1 into each divisor: the card's 64-bit division has a short
path for operands that fit 32 bits, and the chains' values would otherwise
shrink into it; with the top bit set every shifted dividend is 60 bits
wide, as in a High true division.

Rates are *nominal*: every op of the JAX mix counts 1 (converts included)
and every cell primitive counts 1, whatever instructions ``nvcc`` makes of
them (:func:`sass_loop_instructions` counts those).

:func:`ubench_chain` launches the kernel on CUDA tensors and raises on
anything else: there is no fallback.  :func:`ubench_reference` is the plain
PyTorch version of the same recurrences, for the tests and the check on the
card.

    python -m matrix_inversion_tpu_torch.utils.ubench [--out PATH] [mix ...]

prints one JSON line per mix and a summary line (to ``PATH`` as well, if
given).
"""

from __future__ import annotations

import ctypes
import datetime
import functools
import json
import re
import sys

import numpy as np
import torch

from ..ops import packed
from ..ops.cuda_build import CSRC, NVCC_FLAGS, build_library
from ..ops.packed import PackedQFloat
from . import profiling, sass
from .timing import card_name_and_limit, synchronize, timed_chain

U32 = torch.uint32
_M32 = 0xFFFFFFFF
_CELL = (40, 20)  # (len, ints) of the cell mixes, base 2
_CELL_MASK = (1 << 40) - 1
_CELL_TOP = 1 << 39

# name -> (index in csrc/ubench.cu's enum Mix, dtype, nominal ops per iteration)
MIXES = {
    "u32_add": (0, U32, 2),
    "u32_mul": (1, U32, 2),
    "u32_muladd": (2, U32, 2),
    "u32_shr_xor_add": (3, U32, 3),
    "u32_cmp_sel_add": (4, U32, 4),
    "f32_mul": (5, torch.float32, 2),
    "u32_maskand": (6, U32, 3),
    "u32_convert_add": (7, U32, 4),
    "u32_kernelmix": (8, U32, 22),
    "cell_mul": (9, torch.int64, 2),
    "cell_sadd": (10, torch.int64, 2),
    "cell_mul_window_t": (11, torch.int64, 2),
    "cell_divide": (12, torch.int64, 2),
}

_MIX_OF_INDEX = {index: name for name, (index, _, _) in MIXES.items()}

CHAIN_COUNTS = (1, 8)  # the C values csrc/ubench.cu instantiates for the card
HOST_CHAIN_COUNTS = (1, 2, 8)  # those of its host build, and of the plain version
UNROLL = {U32: 8, torch.float32: 8, torch.int64: 1}  # of the K loop, by dtype


def _build():
    return build_library(
        "ubench.cu", "libubench.so",
        ((CSRC / "qfloat_cell.cuh").read_text(), (CSRC / "ubench.cu").read_text(),
         " ".join(NVCC_FLAGS)),
    )


def build_dir():
    """The build directory: the library and ``nvcc.log`` with ptxas's
    registers and spills.  Builds first if needed."""
    return _build().parent


@functools.lru_cache(maxsize=None)
def _library():
    with profiling.library("libubench.so"):
        fn = ctypes.CDLL(str(_build())).ubench_chain_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def build():
    """Build the library (one nvcc) and load it."""
    _library()


def _check_args(name, x, y, K, C, chain_counts):
    if name not in MIXES:
        raise ValueError(f"unknown mix {name!r}: expected one of {list(MIXES)}")
    dtype = MIXES[name][1]
    if C not in chain_counts:
        raise ValueError(f"C must be one of {chain_counts}, got {C}")
    if K < 0:
        raise ValueError(f"K must not be negative, got {K}")
    if x.dtype != dtype or y.dtype != dtype:
        raise TypeError(f"{name} takes {dtype} tensors, got {x.dtype} and {y.dtype}")
    if x.shape != y.shape or x.device != y.device:
        raise ValueError("x and y must have one shape and lie on one device")


def ubench_chain(name, x, y, K, C):
    """One launch of the probe kernel: ``C`` chains of ``K`` iterations of
    mix ``name`` per element of the CUDA tensors ``x`` and ``y`` (uint32,
    float32, or int64 words below 2**40 for a cell mix; any shape); returns
    the XOR (float32: the sum) of the chains' ``x``; counted under
    ``launch.ubench.<name>``.  A tensor that is not on a CUDA device
    raises."""
    _check_args(name, x, y, K, C, CHAIN_COUNTS)
    if x.device.type != "cuda":
        raise ValueError(
            f"ubench_chain measures the card and takes CUDA tensors only, got {x.device}; "
            "the plain version is ubench_reference"
        )
    x, y = x.contiguous(), y.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library()(MIXES[name][0], C, x.data_ptr(), y.data_ptr(), out.data_ptr(),
                         x.numel(), K, stream)
    if err != 0:
        raise RuntimeError(f"ubench kernel launch failed for {name}: cudaError {err}")
    profiling.count("launch.ubench." + name)
    return out


def _u32_step(name, x, y):
    """One iteration of a uint32 mix on int64 tensors holding uint32 values
    (masked after every op, so shifts are logical and compares unsigned)."""
    if name in ("u32_add", "u32_convert_add"):  # the converts change no bit
        x = (x + y) & _M32
    elif name in ("u32_mul", "u32_muladd"):
        x = (x * y) & _M32
        if name == "u32_mul":
            return x, (y * x) & _M32
    elif name == "u32_shr_xor_add":
        x = (x >> 7) ^ y
    elif name == "u32_cmp_sel_add":
        x = torch.where(x > y, x ^ y, y)
    elif name == "u32_maskand":
        x = (x + y) & 0x3FFFFFFF
    elif name == "u32_kernelmix":
        a = x & 0xFFFF
        b = (y >> 16) & 0x7FFF
        c = (a * b) & 0x3FFFFFFF
        d = ((x - y) + (c - b)) & _M32
        e = ((c << 3) | (d >> 5)) & _M32
        f = (e - 7) & _M32
        g = torch.where(x < y, f, e)
        x = ((g + a) ^ (g << 1)) & 0x7FFFFFFF
    else:
        raise ValueError(name)
    return x, (y + x) & _M32


def _cell_chain(name, x, y, K):
    """One chain of a cell mix through the plain functions of
    ``ops/packed.py``; returns the chain's output word."""
    fmt = (*_CELL, 2)
    if name == "cell_sadd":
        one = torch.ones_like(x)
        a, b = PackedQFloat(x, *fmt, sign=one), PackedQFloat(y, *fmt, sign=one)
        for _ in range(K):
            a += -b
            b += a
        return a.mag
    flag = torch.zeros_like(x, dtype=torch.bool)
    for _ in range(K):
        if name == "cell_mul":
            x = packed.mul_trunc_packed(x, *_CELL, y, *_CELL, *_CELL, 1)
            y = packed.mul_trunc_packed(y, *_CELL, x, *_CELL, *_CELL, 1)
        elif name == "cell_mul_window_t":
            x, fx = packed.mul_window_packed(x, *_CELL, y, *_CELL, *_CELL, 1)
            y, fy = packed.mul_window_packed(y, *_CELL, x, *_CELL, *_CELL, 1)
            flag = flag | fx | fy
        elif name == "cell_divide":
            frac = _CELL[0] - _CELL[1]
            n_bits = _CELL[0] + frac
            x = packed.packed_long_division_reference(
                (x | _CELL_TOP) << frac, y | 1, n_bits) & _CELL_MASK
            y = packed.packed_long_division_reference(
                (y | _CELL_TOP) << frac, x | 1, n_bits) & _CELL_MASK
        else:
            raise ValueError(name)
    return x ^ (flag.to(torch.int64) << 40)


def ubench_reference(name, x, y, K, C):
    """Plain PyTorch version of :func:`ubench_chain`, on any device: the
    same recurrences with torch ops (uint32 as int64 masked after every op,
    the cell mixes through ``ops/packed.py``).  For the tests and the check
    on the card; nothing else calls it."""
    _check_args(name, x, y, K, C, HOST_CHAIN_COUNTS)
    dtype = MIXES[name][1]
    if dtype == torch.float32:
        acc = None
        for c in range(C):
            xc, yc = x + float(c + 1), y + float(c + 1)
            for _ in range(K):
                xc = xc * yc
                yc = yc * xc
            acc = xc if acc is None else acc + xc
        return acc
    if dtype == U32:
        x = x.view(torch.int32).to(torch.int64) & _M32
        y = y.view(torch.int32).to(torch.int64) & _M32
    acc = torch.zeros_like(x)
    for c in range(C):
        if dtype == U32:
            xc, yc = (x + (c + 1)) & _M32, (y + (c + 1)) & _M32
            for _ in range(K):
                xc, yc = _u32_step(name, xc, yc)
        else:
            xc = _cell_chain(name, (x + (c + 1)) & _CELL_MASK, (y + (c + 1)) & _CELL_MASK, K)
        acc = acc ^ xc
    if dtype == U32:
        return acc.to(torch.int32).view(U32)
    return acc


def make_inputs(name, rows, device, seed=0):
    """The ``(rows, 128)`` inputs of :func:`measure` for one mix, made with
    numpy from ``seed``: uint32 below 2**31 (y odd), float32 just above 1,
    or 40-bit int64 words for a cell mix."""
    dtype = MIXES[name][1]
    rng = np.random.RandomState(seed)
    shape = (rows, 128)
    if dtype == U32:
        x = rng.randint(0, 2 ** 31, shape).astype(np.uint32)
        y = (rng.randint(1, 2 ** 31, shape) | 1).astype(np.uint32)
    elif dtype == torch.float32:
        x = (rng.rand(*shape) * 0.1 + 1.0).astype(np.float32)
        y = (rng.rand(*shape) * 1e-4 + 1.0).astype(np.float32)
    else:
        x = rng.randint(0, 1 << 40, shape, dtype=np.int64)
        y = rng.randint(0, 1 << 40, shape, dtype=np.int64)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def chain_seconds(name, K, rows=8192, C=8, reps=20, repeats=3, device="cuda"):
    """Median seconds (CUDA events, ``repeats`` passes) of ``reps``
    data-chained launches of mix ``name`` at ``K`` iterations, after a
    warm-up launch."""
    x, y = make_inputs(name, rows, device)

    def step(s):
        out = ubench_chain(name, s, y, K, C)
        # a cell_mul_window_t output carries its flag at bit 40
        return out & _CELL_MASK if out.dtype == torch.int64 else out

    step(x)
    synchronize(x.device)
    return timed_chain(step, lambda s: None, x, reps, repeats)[0]


def measure(name, rows=8192, C=8, reps=20, K1=256, K2=2048):
    """Nominal ops/s of mix ``name`` on the whole card: the work added
    between ``K1`` and ``K2`` iterations over the time it adds."""
    nops = MIXES[name][2]
    t1 = chain_seconds(name, K1, rows, C, reps)
    t2 = chain_seconds(name, K2, rows, C, reps)
    dops = (K2 - K1) * C * rows * 128 * nops * reps
    return dops / (t2 - t1)


def _kernel_of(entry):
    """``(mix name, C)`` of a mangled ``chain_kernel<mix, C>`` name, else None."""
    m = re.search(r"chain_kernelILi(\d+)ELi(\d+)E", entry)
    return (_MIX_OF_INDEX[int(m.group(1))], int(m.group(2))) if m else None


def ptxas_registers():
    """``{(mix name, C): registers per thread}`` from ptxas's lines in the
    library's ``nvcc.log``."""
    log = (build_dir() / "nvcc.log").read_text()
    return {_kernel_of(entry): regs for entry, regs in sass.ptxas_registers(log).items()
            if _kernel_of(entry)}


def ptxas_spill_lines():
    """ptxas's lines of the library's ``nvcc.log`` that report a spill."""
    return sass.ptxas_spill_lines((build_dir() / "nvcc.log").read_text())


def resident_warps(registers, threads=256):
    """Warps resident on one SM for a kernel of ``registers`` per thread in
    blocks of ``threads``: 65,536 registers, allotted per warp in units of
    256 (8 per thread), at most 64 warps."""
    per_warp = -(-registers * 32 // 256) * 256
    blocks = min(65536 // (per_warp * (threads // 32)), 64 // (threads // 32))
    return blocks * (threads // 32)


def sass_loop_instructions():
    """``{(mix name, C): (instructions, calls)}``: the SASS instructions in
    the largest loop of each kernel of the built library (the K loop's main
    body: ``UNROLL`` iterations of ``C`` chains) and how many of them are
    calls (the 64-bit division is a subroutine, whose instructions are not
    in the count).  Read with ``cuobjdump -sass``."""
    return {_kernel_of(name): sass.largest_loop(instrs)
            for name, instrs in sass.functions(sass.dump(_build())).items() if _kernel_of(name)}


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    out_path = None
    if "--out" in args:
        i = args.index("--out")
        out_path = args[i + 1]
        del args[i:i + 2]
    names = args or list(MIXES)
    if not torch.cuda.is_available():
        print("ubench: no CUDA device", file=sys.stderr)
        return 1
    out = {
        "platform": "gpu",
        "device_kind": torch.cuda.get_device_name(0),
        "card": card_name_and_limit(),
        "date": datetime.date.today().isoformat(),
    }
    lines = []
    for name in names:
        if MIXES[name][1] == torch.int64:
            # a cell primitive is hundreds of instructions: 16x shorter
            # chains take about the time of a uint32 mix's
            rate = measure(name, K1=16, K2=128)
        else:
            rate = measure(name)
        out[name] = round(rate / 1e9, 1)  # G nominal ops/s
        lines.append(json.dumps({name: out[name]}))
        print(lines[-1], flush=True)
    lines.append(json.dumps(out))
    print(lines[-1])
    if out_path:
        with open(out_path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
