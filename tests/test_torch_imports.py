"""The port and its GPU smoke script import neither jax nor the JAX package."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "matrix_inversion_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "matrix_inversion_tpu")


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_found():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"__init__.py", "ops/fused_inverse.py", "ops/emit.py", "ops/long_division.py",
            "ops/cuda_build.py", "runtime/api.py", "utils/__init__.py", "utils/samplers.py",
            "utils/timing.py", "utils/profiling.py", "utils/ubench.py",
            "utils/roofline.py", "ops/radix.py", "models/lu_float.py", "models/marshal.py",
            "models/inverse.py", "runtime/stream.py", "runtime/native.py", "utils/debug.py",
            "utils/precision.py", "utils/run_benchmarks.py", "__main__.py", "ops/limbs.py",
            "ops/limb_kernels.py", "parallel/__init__.py", "parallel/mesh.py",
            "parallel/distributed.py", "ops/digit_io.py", "ops/float_io.py"} <= names
    for source in ("qmarshal.cc", "limb_division.cu", "limb_tidy.cu", "limb_frame.cuh",
                   "digit_io.cu", "float_io.cu"):
        assert (PORT / "csrc" / source).is_file()


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")), ids=lambda p: p.relative_to(PORT).as_posix()
)
def test_no_jax_import(path):
    for name in imported_modules(path):
        assert name.split(".")[0] not in FORBIDDEN, f"{path.name} imports {name}"


def test_chip_smoke_imports_no_jax():
    names = list(imported_modules(REPO / "chip_smoke.py"))
    assert "matrix_inversion_tpu_torch" in names
    for name in names:
        assert name.split(".")[0] not in FORBIDDEN, f"chip_smoke.py imports {name}"
