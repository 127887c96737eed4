"""The end-to-end device readings, from the package of any checkout.

    python -m matrix_inversion_tpu_torch.utils.run_raw_times [TREE] [--out PATH]

times ``BatchedMatrixInversion.run_raw`` on the card at the three shapes
the port's end-to-end metrics name: HIGH n=4 over 1,048,576 matrices,
untracked and with ``track_overflow=True``, and HIGH n=16 over 262,144 (the
op-by-op path); one call between two CUDA events, after a warm call, 15
samples (5 at n=16, seconds each).  With ``TREE`` the package is imported
from that directory in place of this one: two commits are compared on one
card by unpacking both and running one process per tree, in turns (parent,
change, change, parent), within one job.  Prints one JSON line per shape
(to ``PATH`` as well, if given).
"""

from __future__ import annotations

import importlib
import json
import os
import statistics
import sys

import numpy as np
import torch

SHAPES = (("HIGH n=4", 4, 1_048_576, False, 15),
          ("HIGH n=4 tracked", 4, 1_048_576, True, 15),
          ("HIGH n=16", 16, 262_144, False, 5))


def measure(package, shapes=SHAPES, device="cuda"):
    """Rows ``{"shape", "batch", "run_raw_ms", "samples_ms"}``: the median
    and all samples of one ``run_raw`` of ``package``'s
    ``BatchedMatrixInversion`` per shape."""
    rows = []
    for label, n, batch, track, samples in shapes:
        p = package.HIGH.replace(n=n)
        inv = package.BatchedMatrixInversion(p, batch, io="packed", device=device,
                                             track_overflow=track)
        mags, signs = inv.quantize(np.random.RandomState(0).randn(batch, n, n) * 100)
        inv.run_raw(mags, signs)
        torch.cuda.synchronize()
        ms = []
        for _ in range(samples):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            inv.run_raw(mags, signs)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        rows.append({"shape": label, "batch": batch, "run_raw_ms": statistics.median(ms),
                     "samples_ms": ms})
    return rows


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    out_path = None
    if "--out" in args:
        i = args.index("--out")
        out_path = args[i + 1]
        del args[i:i + 2]
    if not torch.cuda.is_available():
        print("run_raw_times: no CUDA device", file=sys.stderr)
        return 1
    name = __package__.split(".")[0]
    if args:
        # another checkout's package under this package's name: drop ours first
        tree = os.path.abspath(args[0])
        for module in [m for m in sys.modules if m == name or m.startswith(name + ".")]:
            del sys.modules[module]
        sys.path.insert(0, tree)
    package = importlib.import_module(name)
    from_tree = os.path.dirname(os.path.dirname(os.path.abspath(package.__file__)))
    if args and from_tree != tree:
        print(f"run_raw_times: imported {from_tree}, not {tree}", file=sys.stderr)
        return 1
    card = importlib.import_module(name + ".utils.timing").card_name_and_limit()
    lines = [json.dumps({**row, "tree": from_tree, "card": card}) for row in measure(package)]
    print("\n".join(lines))
    if out_path:
        with open(out_path, "a") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
