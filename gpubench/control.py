"""The control of a cell's comparison: the reference in the program's place,
computed in the configuration's ``control`` format (the next precision
below the one it states), must come out not correct.

    python3 gpubench/control.py --workload <cell> --seeds 1,2,3

For each seed this makes the cell's float pool, as a run does, hands the
reference's own answers for as many pool batches as a run samples
(``keep_outputs``, at the cell's batch) to the run's comparison, then does
the same with the control's answers, written exactly in the configuration's
format, and prints one JSON line a seed with the ``mismatched_cells`` of
both (and in a tracked configuration their ``mismatched_flags``), on the
machine's first card.  The benchmark's own runs never run it.
"""

import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

from gpubench import reference  # noqa: E402
from gpubench.harness import device as cards, inputs, manifest, runner  # noqa: E402


def readings(name, seed, device, root=manifest.ROOT, traffic=None):
    """``{"sound": n, "control": n, "cells": n}``: the mismatched cells of
    the reference's answers and of the control's for one seed; in a tracked
    configuration also ``sound_flags``, ``control_flags`` and ``matrices``,
    their mismatched flags and the flags compared."""
    cell = manifest.cell(name, root)
    cell.traffic.update(traffic or {})
    cfg, tr = cell.config, cell.traffic
    io = runner._module("drivers", tr["driver"], root).answers(tr)
    pool = inputs.float_pool(seed, tr["pool"], tr["batch"], cfg["n"], cfg["sampler"], device)
    fmt = runner.fmt_of(cfg)
    low = runner.fmt_of(cfg, **{k: cfg["control"][k]
                               for k in ("qfloat_len", "qfloat_ints", "true_division")})
    track = runner.tracked(cfg)
    out = {}
    for label, answer_fmt in (("sound", fmt), ("control", low)):
        samples = []
        for k in range(min(tr["keep_outputs"], tr["pool"])):
            got = reference.expected(pool[k].to(device), answer_fmt, io, cells_fmt=fmt,
                                     track=track)
            samples.append((k, tuple(g.cpu() for g in got) if isinstance(got, tuple)
                            else got.cpu().numpy() if io == "floats" else got.cpu()))
        mismatched, compared, *_ = runner.compare(cell, pool, samples, io, device)
        out[label], out["cells"] = mismatched["mismatched_cells"], compared["mismatched_cells"]
        if track:
            out[f"{label}_flags"] = mismatched["mismatched_flags"]
            out["matrices"] = compared["mismatched_flags"]
    return out


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    device = cards.require_cards(1)
    for seed in map(int, args.seeds.split(",")):
        t = time.perf_counter()
        line = {"workload": args.workload, "seed": seed, **readings(args.workload, seed, device)}
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
