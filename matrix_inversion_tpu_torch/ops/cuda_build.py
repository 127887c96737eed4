"""Builds of the port's native sources: nvcc for the CUDA kernels of every
kernel family, g++ for the host marshaller (``runtime/native.py``).

A library is built at first use from ``csrc/`` into ``_build/<hash>/``
beside this package, where the hash covers the texts its caller names
(sources, generated files, flags).  A library already built from the same
texts is reused.  ``nvcc.log`` beside each CUDA library holds ptxas's
registers and spills (``g++.log`` the host compiler's output).
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# host C++: no contraction of a multiply and an add into an FMA, so that the
# float64 sums round as numpy's do on every host
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-pthread", "-ffp-contract=off")


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's kernels need the CUDA toolkit")
    return path


def build_library(source, lib_name, hashed, files=None, what="", flags=(), host=False):
    """Compile ``csrc/<source>`` into ``_build/<hash>/<lib_name>`` and return
    its path.  ``hashed`` is the sequence of texts that keys the build;
    ``files`` maps names to texts written into the build directory first
    (found there by ``#include``); ``flags`` follow ``NVCC_FLAGS``, or
    ``HOST_FLAGS`` for a host library (``host=True``, built with g++); the
    caller hashes them.  A failed build raises with the compiler's output."""
    digest = hashlib.sha256()
    for text in hashed:
        digest.update(text.encode())
        digest.update(b"\0")
    out_dir = BUILD_DIR / digest.hexdigest()[:24]
    lib = out_dir / lib_name
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, text in (files or {}).items():
        (out_dir / name).write_text(text)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    compiler = ("g++", *HOST_FLAGS) if host else (_nvcc(), *NVCC_FLAGS)
    name = Path(compiler[0]).name
    cmd = [
        *compiler, *flags, "-I", str(CSRC), "-I", str(out_dir),
        "-o", tmp, str(CSRC / source),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{name} failed for {source} {what}:\n{proc.stdout}\n{proc.stderr}")
    (out_dir / f"{name}.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def run_parallel(jobs):
    """Run zero-argument build jobs at once, one thread each (each waits
    on its own nvcc process); returns their results in order and raises
    the first failure."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(jobs) or 1) as pool:
        return list(pool.map(lambda job: job(), jobs))
