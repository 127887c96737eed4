"""The float-I/O kernels' host form, for the tests that run them on the CPU.

``csrc/float_io.cu`` compiles with g++ as host C++ (its launch replaced by a
loop over the threads); :func:`build` makes that library and
:func:`kernel_route` puts it behind ``ops/float_io.py``'s wrappers, so that
CPU tensors take the kernels' code as a card's tensors take the kernels.
"""

import ctypes
import subprocess

from matrix_inversion_tpu_torch.ops import float_io
from matrix_inversion_tpu_torch.ops.cuda_build import CSRC
from matrix_inversion_tpu_torch.utils import profiling

ENTRIES = ("float_quantize", "float_dequantize")


def build(directory):
    """``csrc/float_io.cu`` built with g++ into ``directory``: ``{entry: its
    host function}``, the arguments of the launch functions less the
    stream."""
    lib = directory / "float_io.so"
    proc = subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
                           "-x", "c++", "-o", str(lib), str(CSRC / float_io.SOURCE)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, f"g++ failed:\n{proc.stderr}"
    dll = ctypes.CDLL(str(lib))
    out = {}
    for entry in ENTRIES:
        fn = getattr(dll, f"{entry}_host")
        fn.argtypes = float_io._ARGTYPES[entry][:-1]
        fn.restype = ctypes.c_int
        out[entry] = fn
    return out


def kernel_route(monkeypatch, kernels):
    """``ops/float_io.py``'s wrappers on CPU tensors, with the host build
    ``kernels`` in place of the launch, which counts under
    ``launch.<entry>`` as the launch does."""
    def launch(entry, *args, device):
        assert device.type == "cpu"
        assert kernels[entry](*args) == 0
        profiling.count("launch." + entry)

    monkeypatch.setattr(float_io, "_check_device", lambda t, what: None)
    monkeypatch.setattr(float_io, "_launch", launch)
