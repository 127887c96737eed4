"""End-to-end demo: samplers x matrix sizes, like the reference's
``python matrix_inversion/main.py`` (reference main.py:157-201).

Port of ``matrix_inversion_tpu/__main__.py:17-86``, with the same flags and
output lines, plus ``--device`` (the card by default; ``--device cpu`` runs
the plain PyTorch path on the host).

Usage:
    python -m matrix_inversion_tpu_torch [--sizes 2,3,5,10] [--preset low]
                                         [--batch 1] [--simulate] [--device cuda]
"""

import argparse
import time

import numpy as np

from . import PRESETS, BatchedMatrixInversion, EncryptedMatrixInversion


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="2,3,5,10")
    ap.add_argument("--preset", default="low", choices=sorted(PRESETS))
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--simulate", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    preset = PRESETS[args.preset]
    sizes = [int(s) for s in args.sizes.split(",")]

    samplers = {
        "Normal": lambda n: (lambda: np.random.randn(n, n) * 100),
        "Uniform": lambda n: (lambda: np.random.uniform(0, 100, (n, n))),
    }

    for name, make_sampler in samplers.items():
        for n in sizes:
            print()
            title = f"Sampler={name}, N={n}"
            print(title)
            print("-" * len(title))

            sampler = make_sampler(n)

            print("Compiling...")
            start = time.time()
            if args.batch > 1:
                inv = BatchedMatrixInversion(
                    preset.replace(n=n), args.batch, backend="auto", device=args.device
                )
                run = lambda M: inv.run(
                    np.stack([M] * args.batch)
                )[0]
            else:
                inv = EncryptedMatrixInversion(
                    n,
                    sampler,
                    qfloat_base=preset.qfloat_base,
                    qfloat_len=preset.qfloat_len,
                    qfloat_ints=preset.qfloat_ints,
                    true_division=preset.true_division,
                    device=args.device,
                )
                run = lambda M: inv.run(M, simulate=args.simulate)
            print(f"(took {time.time() - start:.3f} seconds)")

            print()
            print("Generating Keys...")  # parity no-op
            start = time.time()
            if hasattr(inv, "keygen"):
                inv.keygen()
            print(f"(took {time.time() - start:.3f} seconds)")

            print()
            sample_input = sampler()
            expected_output = np.linalg.inv(sample_input)

            print("Running...")
            start = time.time()
            actual_output = run(sample_input)
            print(f"(took {time.time() - start:.3f} seconds)")

            print()
            error = np.abs(expected_output - actual_output)
            print(f"Average Error: {np.mean(error):.6f}")
            print(f"    Max Error: {np.max(error):.6f}")
            print(f"    Min Error: {np.min(error):.6f}")
            print(f"  Total Error: {np.sum(error):.6f}")
            print()


if __name__ == "__main__":
    main()
