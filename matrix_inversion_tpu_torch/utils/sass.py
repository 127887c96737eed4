"""What the compiler made of a kernel: SASS instructions and ptxas's lines.

Readers of ``cuobjdump -sass`` output and of the ``nvcc.log`` that
``ops/cuda_build.py`` leaves beside each library (``-Xptxas -v``).  They
work on text, so the CPU tests reach them; only :func:`dump` needs the
CUDA toolkit.
"""

from __future__ import annotations

import re
import shutil
import subprocess

_INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]+);")  # addresses run past 0xffff
_BRANCH_TARGET = re.compile(r"\bBRA\S*\s+(?:\S+,\s*)*`?\(?(0x[0-9a-f]+)")


def dump(library):
    """The text of ``cuobjdump -sass`` for a built library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout


def functions(text):
    """``{mangled kernel name: [(address, instruction), ...]}`` of a SASS
    dump, NOPs and the padding after the last EXIT or RET left out."""
    out = {}
    for block in text.split("Function : ")[1:]:
        name, _, body = block.partition("\n")
        instrs = [(int(addr, 16), op.strip()) for addr, op in _INSTRUCTION.findall(body)]
        ends = [i for i, (_, op) in enumerate(instrs) if re.search(r"\b(EXIT|RET)\b", op)]
        instrs = instrs[:ends[-1] + 1] if ends else instrs
        out[name.strip()] = [(addr, op) for addr, op in instrs if not op.startswith("NOP")]
    return out


def opcode(op):
    """The opcode of one instruction, its predicate and suffixes left off:
    ``"@!P0 IMAD.WIDE.U32 R2, ..."`` gives ``"IMAD"``."""
    return re.sub(r"^@!?U?P\w+\s+", "", op).split()[0].split(".")[0]


def main_body(instrs):
    """The instructions up to the kernel's last EXIT: what follows is
    subroutines (the slow path of an IEEE division, the 64-bit division)."""
    ends = [i for i, (_, op) in enumerate(instrs) if re.search(r"\bEXIT\b", op)]
    return instrs[:ends[-1] + 1] if ends else instrs


def calls(instrs):
    return sum(1 for _, op in instrs if re.search(r"\bCALL\b", op))


def largest_loop(instrs):
    """``(instructions, calls)`` of the longest span that a backward branch
    closes: a kernel's main loop body."""
    best = (0, 0)
    for addr, op in instrs:
        target = _BRANCH_TARGET.search(op)
        if not target or int(target.group(1), 16) > addr:
            continue
        body = [(a, o) for a, o in instrs if int(target.group(1), 16) <= a <= addr]
        best = max(best, (len(body), calls(body)))
    return best


def forward_exits(instrs):
    """``(addresses of the branches to the most common forward target, that
    target)``: the early exits of an unrolled loop whose every step may
    leave to one common end."""
    targets = {}
    for addr, op in instrs:
        target = _BRANCH_TARGET.search(op)
        if target and int(target.group(1), 16) > addr:
            targets.setdefault(int(target.group(1), 16), []).append(addr)
    if not targets:
        return [], None
    target = max(targets, key=lambda t: len(targets[t]))
    return sorted(targets[target]), target


def ptxas_registers(log):
    """``{mangled entry name: registers per thread}`` from ptxas's lines."""
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"Compiling entry function '([^']*)'.*?Used (\d+) registers", log, flags=re.S)}


def ptxas_spills(log):
    """``{mangled function name: its stack-frame and spill line}`` from
    ptxas's lines."""
    return {m.group(1): m.group(2).strip() for m in re.finditer(
        r"Function properties for (\S+)\n\s*([^\n]*spill[^\n]*)", log)}


def ptxas_spill_lines(log):
    """ptxas's lines that report a spill."""
    return [line.strip() for line in log.splitlines()
            if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
