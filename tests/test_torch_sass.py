"""The readers of SASS dumps and ptxas logs (``utils/sass.py``), on text
shaped as ``cuobjdump -sass`` and ``nvcc -Xptxas -v`` print it: the card's
toolkit is needed only to make such text, not to read it."""

import pytest

from matrix_inversion_tpu_torch.utils import sass, ubench

DUMP = """
	code for sm_90a
		Function : _Z6loopedPKmPml
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                        /* 0x00000a00ff017b82 */
                                                                                 /* 0x000fe20000000800 */
        /*0010*/                   S2R R5, SR_CTAID.X ;                          /* 0x0000000000057919 */
        /*0020*/              @!P0 BRA 0x90 ;                                    /* 0x0000000000188947 */
        /*0030*/                   IMAD.WIDE.U32 R2, R5, 0x8, R2 ;               /* 0x0000000805027825 */
        /*0040*/                   CALL.REL.NOINC 0xb0 ;                         /* 0x0000000000007944 */
        /*0050*/                   NOP ;                                         /* 0x0000000000007918 */
        /*0060*/                   IADD3 R0, R0, 0x1, RZ ;                       /* 0x0000000100007810 */
        /*0070*/               @P1 BRA 0x30 ;                                    /* 0x0000000000001947 */
        /*0080*/                   FMUL R4, R4, R6 ;                             /* 0x0000000604047220 */
        /*0090*/                   EXIT ;                                        /* 0x000000000000794d */
        /*00a0*/                   BRA 0xa0;                                     /* 0xfffffffc00fc7947 */
        /*00b0*/                   I2F.U64.RP R0, R2 ;                           /* 0x0000000200007312 */
        /*00c0*/                   RET.REL.NODEC R2 0x0 ;                        /* 0x0000000002007950 */
        /*00d0*/                   BRA 0xd0;                                     /* 0xfffffffc00fc7947 */
        /*00e0*/                   NOP;                                          /* 0x0000000000007918 */
		..........

		Function : _Z8unrolledPKmPml
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                        /* 0x00000a00ff017b82 */
        /*0010*/              @!P0 BRA 0x100a0 ;                                 /* 0x0000000000188947 */
        /*0020*/                   IMAD R2, R5, 0x8, R2 ;                        /* 0x0000000805027825 */
        /*0030*/              @!P0 BRA 0x100a0 ;                                 /* 0x0000000000188947 */
        /*0040*/                   IMAD R2, R5, 0x8, R2 ;                        /* 0x0000000805027825 */
        /*0050*/              @!P1 BRA 0x70 ;                                    /* 0x0000000000188947 */
        /*0060*/              @!P0 BRA 0x100a0 ;                                 /* 0x0000000000188947 */
        /*0070*/                   IMAD R2, R5, 0x8, R2 ;                        /* 0x0000000805027825 */
        /*100a0*/                  STG.E.64 desc[UR4][R2.64], R4 ;               /* 0x0000000402007986 */
        /*100b0*/                  EXIT ;                                        /* 0x000000000000794d */
        /*100c0*/                  BRA 0x100c0;                                  /* 0xfffffffc00fc7947 */
"""

LOG = """
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6loopedPKmPml' for 'sm_90a'
ptxas info    : Function properties for _Z6loopedPKmPml
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 39 registers, used 0 barriers
ptxas info    : Compiling entry function '_Z12chain_kernelILi3ELi8EEvPKvS1_Pvli' for 'sm_90a'
ptxas info    : Function properties for _Z12chain_kernelILi3ELi8EEvPKvS1_Pvli
    24 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers
"""


def test_functions_drop_nops_and_padding():
    fns = sass.functions(DUMP)
    assert list(fns) == ["_Z6loopedPKmPml", "_Z8unrolledPKmPml"]
    looped = fns["_Z6loopedPKmPml"]
    assert [addr for addr, _ in looped] == [0, 0x10, 0x20, 0x30, 0x40, 0x60, 0x70, 0x80, 0x90,
                                            0xa0, 0xb0, 0xc0]
    assert looped[2] == (0x20, "@!P0 BRA 0x90")
    # addresses past 0xffff are read, the self-branch after the last EXIT is not
    assert [addr for addr, _ in fns["_Z8unrolledPKmPml"]][-2:] == [0x100a0, 0x100b0]


def test_main_body_and_calls():
    looped = sass.functions(DUMP)["_Z6loopedPKmPml"]
    body = sass.main_body(looped)
    assert body[-1] == (0x90, "EXIT") and len(looped) - len(body) == 3
    assert sass.calls(looped) == sass.calls(body) == 1


@pytest.mark.parametrize("op,want", [
    ("@!P0 IMAD.WIDE.U32 R2, R5, 0x8, R2", "IMAD"), ("I2F.U64.RP R0, R2", "I2F"),
    ("@UP1 UIADD3 UR4, UR4, 0x1, URZ", "UIADD3"), ("EXIT", "EXIT"), ("FLO.U32 R5, R5", "FLO"),
])
def test_opcode(op, want):
    assert sass.opcode(op) == want


def test_largest_loop():
    fns = sass.functions(DUMP)
    # 0x30 .. 0x70 without the NOP, one of them a call
    assert sass.largest_loop(fns["_Z6loopedPKmPml"]) == (4, 1)
    assert sass.largest_loop(fns["_Z8unrolledPKmPml"]) == (0, 0)


def test_forward_exits():
    unrolled = sass.functions(DUMP)["_Z8unrolledPKmPml"]
    exits, end = sass.forward_exits(unrolled)
    assert exits == [0x10, 0x30, 0x60] and end == 0x100a0
    # what a thread that leaves at the second exit issues: up to it, and the end
    assert sum(1 for addr, _ in unrolled if addr <= exits[1] or addr >= end) == 6
    assert sass.forward_exits([(0, "IADD3 R0, R0, 0x1, RZ")]) == ([], None)


def test_ptxas_lines():
    assert sass.ptxas_registers(LOG) == {
        "_Z6loopedPKmPml": 39, "_Z12chain_kernelILi3ELi8EEvPKvS1_Pvli": 255}
    assert sass.ptxas_spill_lines(LOG) == [
        "24 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads"]
    assert sass.ptxas_spill_lines(LOG.replace("12 bytes", "0 bytes")) == []


def test_ptxas_spills_by_function():
    assert sass.ptxas_spills(LOG) == {
        "_Z6loopedPKmPml": "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "_Z12chain_kernelILi3ELi8EEvPKvS1_Pvli":
            "24 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads",
    }


def test_ubench_reads_its_kernels_through_sass(monkeypatch, tmp_path):
    """``utils/ubench.py`` names its kernels by mix and chain count."""
    assert ubench._kernel_of("_Z12chain_kernelILi3ELi8EEvPKvS1_Pvli") == ("u32_shr_xor_add", 8)
    assert ubench._kernel_of("_Z6loopedPKmPml") is None
    (tmp_path / "nvcc.log").write_text(LOG)
    monkeypatch.setattr(ubench, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(ubench, "_build", lambda: tmp_path / "libubench.so")
    assert ubench.ptxas_registers() == {("u32_shr_xor_add", 8): 255}
    assert len(ubench.ptxas_spill_lines()) == 1
    dump = DUMP.replace("_Z6loopedPKmPml", "_Z12chain_kernelILi0ELi1EEvPKvS1_Pvli")
    monkeypatch.setattr(sass, "dump", lambda library: dump)
    assert ubench.sass_loop_instructions() == {("u32_add", 1): (4, 1)}
