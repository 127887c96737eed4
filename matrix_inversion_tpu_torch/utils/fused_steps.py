"""The steps of the fused kernel's design, timed side by side.

``csrc/fused_inverse.cu`` and ``csrc/qfloat_cell.cuh`` take build switches
(``-D`` macros).  Built with none they are the kernel the port launches;
the other settings give what that kernel replaced or what was tried beside
it: the windowed multiply of the tracked body inlined at each of its uses
(the tracked kernel as first ported), its sum split over accumulators, a
row of it as one net shift and one mask; the truncated multiply of the
untracked body inlined too; a kernel that takes the cell-major layout only;
other block sizes and register limits.  The kernel's
fetch modes (``qcell::Mode``) are run-time arguments of a build: the
callers' ``(B, n*n)`` layout staged through shared memory, each thread
loading its own row, and cell-major.

:func:`measure` builds every step (one nvcc each, all at once), holds each
step's outputs to the port's own build on the timed inputs (tolerance 0),
and times them in turns within one process at HIGH n=4.  Nothing of the
port's paths calls this module.

    python -m matrix_inversion_tpu_torch.utils.fused_steps [--out PATH] [--n N]

prints one JSON line per step (to ``PATH`` as well, if given).  With
``--n N`` the steps are ``SIZE_STEPS`` at HIGH n=N: the choices that depend
on the size of the body (multiplies called or inlined, blocks an SM).
"""

from __future__ import annotations

import functools
import json
import statistics
import sys
import time

import torch

from ..config import HIGH
from ..ops import fused_inverse
from ..ops.cuda_build import run_parallel
from . import sass
from .timing import card_name_and_limit

CELL_MAJOR, ROWS_STAGED, ROWS_DIRECT = 0, 1, 2  # qcell::Mode

# The kernels as first ported: cell-major only, every multiply inlined at
# each use, two blocks of 255 registers an SM.
FIRST = ("FUSED_CELL_MAJOR_ONLY=1", "FUSED_MIN_BLOCKS=1", "QCELL_MUL_INLINE=1")
FIRST_TRACKED = FIRST + ("QCELL_MUL_WINDOW_INLINE=1",)
TWO_BLOCKS = ("FUSED_MIN_BLOCKS=1",)  # 255 registers allowed, as first ported
SPLIT_SUM = ("QCELL_MUL_WINDOW_ACCS=4",)
SPLIT_NET = SPLIT_SUM + ("QCELL_MUL_WINDOW_NET=1",)

# (label, track, defines, mode): each step beside the one before it.  The
# port's own build is the one with no define, in mode ROWS_STAGED.
STEPS = [
    ("untracked as first ported (mul inlined, cell-major only)", False, FIRST, CELL_MAJOR),
    ("untracked: one kernel for all layouts, mul inlined, cell-major", False,
     TWO_BLOCKS + ("QCELL_MUL_INLINE=1",), CELL_MAJOR),
    ("untracked: and (B, n*n) staged", False, TWO_BLOCKS + ("QCELL_MUL_INLINE=1",), ROWS_STAGED),
    ("untracked: and mul compiled once and called", False, TWO_BLOCKS, ROWS_STAGED),
    ("untracked: and 3 blocks an SM", False, ("FUSED_MIN_BLOCKS=3",), ROWS_STAGED),
    ("untracked: and 4 blocks an SM = the port's kernel", False, (), ROWS_STAGED),
    ("untracked: 5 blocks an SM", False, ("FUSED_MIN_BLOCKS=5",), ROWS_STAGED),
    ("untracked: 4 blocks an SM, mul inlined", False, ("QCELL_MUL_INLINE=1",), ROWS_STAGED),
    ("untracked: the port's kernel, cell-major (n*n, B)", False, (), CELL_MAJOR),
    ("untracked: the port's kernel, (B, n*n), each thread its own row", False, (), ROWS_DIRECT),
    ("tracked as first ported (mul_window_t inlined, cell-major only)", True, FIRST_TRACKED,
     CELL_MAJOR),
    ("tracked: one kernel for all layouts, (B, n*n) staged", True,
     TWO_BLOCKS + ("QCELL_MUL_WINDOW_INLINE=1",), ROWS_STAGED),
    ("tracked step 1: mul_window_t compiled once and called", True, TWO_BLOCKS, ROWS_STAGED),
    ("tracked step 2: and 4 accumulators", True, TWO_BLOCKS + SPLIT_SUM, ROWS_STAGED),
    ("tracked step 3: and a row as one net shift and one mask", True, TWO_BLOCKS + SPLIT_NET,
     ROWS_STAGED),
    ("tracked step 4 (on step 1): 3 blocks an SM", True, ("FUSED_MIN_BLOCKS=3",), ROWS_STAGED),
    ("tracked step 4: 4 blocks an SM = the port's kernel", True, (), ROWS_STAGED),
    ("tracked step 4: 5 blocks an SM", True, ("FUSED_MIN_BLOCKS=5",), ROWS_STAGED),
    ("tracked step 4: 64 threads a block, 8 blocks an SM", True,
     ("FUSED_THREADS=64", "FUSED_MIN_BLOCKS=8"), ROWS_STAGED),
    ("tracked: the port's kernel with steps 2 and 3", True, SPLIT_NET, ROWS_STAGED),
    ("tracked: the port's kernel, cell-major (n*n, B)", True, (), CELL_MAJOR),
    ("tracked: the port's kernel, (B, n*n), each thread its own row", True, (), ROWS_DIRECT),
]

# The choices that depend on the size of the body, for any n, untracked and
# tracked: each against the port's own build.
INLINED = ("QCELL_MUL_INLINE=1", "QCELL_MUL_WINDOW_INLINE=1")
SIZE_STEPS = [
    (f"{variant}: {label}", track, defines, mode)
    for track, variant in ((False, "untracked"), (True, "tracked"))
    for label, defines, mode in (
        [("the port's kernel", (), ROWS_STAGED),
         ("the port's kernel, cell-major (n*n, B)", (), CELL_MAJOR),
         ("multiplies inlined", INLINED, ROWS_STAGED),
         ("multiplies inlined, 255 registers allowed", INLINED + TWO_BLOCKS, ROWS_STAGED)]
        + [(f"{blocks} block(s) an SM", (f"FUSED_MIN_BLOCKS={blocks}",), ROWS_STAGED)
           for blocks in (1, 2, 3, 4, 5)])
]


def high_config(n):
    return (n, HIGH.qfloat_len, HIGH.qfloat_ints, HIGH.qfloat_base, HIGH.true_division)


CONFIG = high_config(4)  # the main path's configuration


def _key(track, config=CONFIG):
    return fused_inverse._key(config + (track,))


def build(steps=STEPS, config=CONFIG):
    """Build the libraries of ``steps`` (one nvcc each, all at once) and
    load them."""
    builds = sorted({(track, defines) for _, track, defines, _ in steps})
    run_parallel([functools.partial(fused_inverse._build_one, _key(track, config), defines)
                  for track, defines in builds])
    for track, defines in builds:
        fused_inverse._library(_key(track, config), defines)


def build_info(track, defines, config=CONFIG):
    """``{"registers", "spills", "sass_instructions", "sass_calls"}`` of one
    built step: ptxas's registers of the kernel and its spill lines (the
    called functions' too), and the static SASS instructions of the whole
    library (a function that is called counted once)."""
    directory = fused_inverse.build_dir(config + (track,), defines, "straight_line")
    log = (directory / "nvcc.log").read_text()
    registers = [r for name, r in sass.ptxas_registers(log).items()
                 if "fused_inverse_kernel" in name]
    instrs = [i for fn in sass.functions(sass.dump(directory / "libfused_inverse.so")).values()
              for i in fn]
    return {"registers": registers[0], "spills": sass.ptxas_spill_lines(log),
            "sass_instructions": len(instrs), "sass_calls": sass.calls(instrs)}


def run_step(track, defines, mode, mags, signs, out, config=CONFIG):
    """One launch of a step's kernel on CUDA tensors into the preallocated
    ``out`` (magnitudes, signs and, tracked, int32 flags); every mode takes
    its own layout: ``(n*n, B)`` for ``CELL_MAJOR``, else ``(B, n*n)``."""
    if mags.device.type != "cuda":
        raise ValueError(f"the steps run on the card and take CUDA tensors only, got {mags.device}")
    cell_major, rows = fused_inverse._library(_key(track, config), tuple(defines))
    batch = mags.shape[1] if mode == CELL_MAJOR else mags.shape[0]
    ptrs = [mags.data_ptr(), signs.data_ptr()] + [o.data_ptr() for o in out]
    with torch.cuda.device(mags.device):
        stream = torch.cuda.current_stream().cuda_stream
        if mode == CELL_MAJOR:
            err = cell_major(*ptrs, batch, stream)
        else:
            err = rows(*ptrs, batch, mode, stream)
    if err != 0:
        raise RuntimeError(f"fused step {defines} mode {mode} failed to launch: error {err}")
    return out


def _event_ms(fn, launches):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def random_cells(batch, device, n=4, seed=29):
    """``(B, n*n)`` magnitudes and signs of random x100 matrices at HIGH,
    quantized on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    M = torch.randn(batch, n * n, device=device, generator=g, dtype=torch.float64) * 100
    mags = (M.abs() * (1 << (HIGH.qfloat_len - HIGH.qfloat_ints))).to(torch.int64)
    return mags, torch.where(M < 0, -1, 1)


def measure(device="cuda", batch=1_048_576, rounds=9, launches=5, warm_up_s=1.0, steps=STEPS,
            check=4096, config=CONFIG):
    """Rows ``{"step", "n", "track", "defines", "mode", "ms", "registers",
    "spills", "sass_instructions", "sass_calls"}`` for every step: the
    median of ``rounds`` CUDA-event timings of ``launches`` launches, taken
    in turns (every step once, ``rounds`` times over) after ``warm_up_s``
    seconds of launches.  Raises if a step's outputs differ anywhere from
    those of the port's own build (no define, ``(B, n*n)`` staged), or if
    that build differs from the plain version on the first ``check``
    matrices."""
    device = torch.device(device)
    build(steps, config)
    mags, signs = random_cells(batch, device, config[0])
    layouts = {False: (mags, signs), True: (mags.t().contiguous(), signs.t().contiguous())}

    def outputs(track, cell_major):
        shape = layouts[cell_major][0].shape
        out = [torch.empty(shape, dtype=torch.int64, device=device) for _ in range(2)]
        return out + ([torch.empty(batch, dtype=torch.int32, device=device)] if track else [])

    runs = {}
    for track in (False, True):
        ref = run_step(track, (), ROWS_STAGED, mags, signs, outputs(track, False), config)
        plain = fused_inverse.fused_matrix_inverse_reference(
            mags[:check], signs[:check], *config, track=track)
        assert all(torch.equal(r[:check], p) for r, p in zip(ref, plain)), \
            "the port's own build differs from the plain version"
        for label, step_track, defines, mode in steps:
            if step_track != track:
                continue
            cell_major = mode == CELL_MAJOR
            out = outputs(track, cell_major)
            runs[label] = functools.partial(run_step, track, defines, mode,
                                            *layouts[cell_major], out, config)
            got = [o.t() if cell_major and o.dim() == 2 else o for o in runs[label]()]
            assert all(torch.equal(g, r) for g, r in zip(got, ref)), \
                f"{label}: differs from the port's own build"
        torch.cuda.synchronize(device)
    samples = {label: [] for label in runs}
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warm_up_s:
        for fn in runs.values():
            fn()
        torch.cuda.synchronize(device)
    for _ in range(rounds):
        for label, fn in runs.items():
            samples[label].append(_event_ms(fn, launches))
    builds = sorted({(track, defines) for _, track, defines, _ in steps})
    infos = dict(zip(builds, run_parallel(
        [functools.partial(build_info, *b, config) for b in builds])))
    rows = []
    for label, track, defines, mode in steps:
        rows.append({"step": label, "n": config[0], "track": track, "defines": list(defines),
                     "mode": mode, "batch": batch, "ms": statistics.median(samples[label]),
                     **infos[(track, defines)]})
    return rows


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    out_path = args[args.index("--out") + 1] if "--out" in args else None
    n = int(args[args.index("--n") + 1]) if "--n" in args else None
    if not torch.cuda.is_available():
        print("fused_steps: no CUDA device", file=sys.stderr)
        return 1
    card = card_name_and_limit()
    rows = measure() if n is None else measure(steps=SIZE_STEPS, config=high_config(n))
    lines = [json.dumps({**row, "card": card}) for row in rows]
    print("\n".join(lines))
    if out_path:
        with open(out_path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
