"""The SASS loop reader (dist_svgd_torch/tools/sass_loops.py) on a listing
written out here in cuobjdump's format: loops are backward branches, bodies
nest, opcodes lose their predicates and modifiers."""

import pytest

from dist_svgd_torch.tools import sass_loops
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

LISTING = """
        code for sm_90a
                Function : _Z4testPf
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   MOV R1, c[0x0][0x28] ;                 /* 0x00000a0000017a02 */
        /*0010*/                   LDS.128 R4, [R2] ;                     /* 0x0000000002047984 */
        /*0020*/                   FFMA R8, R4, R5, R8 ;                  /* 0x0000000504087223 */
        /*0030*/                   FFMA.FTZ R9, R6, R7, R9 ;              /* 0x0000000706097223 */
        /*0040*/              @!P0 BRA 0x10 ;                             /* 0x0000000000008947 */
        /*0050*/                   MUFU.EX2 R3, R8 ;                      /* 0x0000000803037308 */
        /*0060*/               @P1 BRA 0x0 ;                              /* 0x0000000000001947 */
        /*0070*/                   BRA 0x80 ;                             /* 0x0000000000007947 */
        /*0080*/                   EXIT ;                                 /* 0x000000000000794d */
                Function : _Z5otherPf
        /*0000*/                   EXIT ;                                 /* 0x000000000000794d */
"""


def test_loops_are_backward_branches_and_nest():
    (row,) = sass_loops.loops(LISTING, "test")
    assert row["function"] == "_Z4testPf"
    assert row["instructions"] == 9
    inner, outer = row["loops"]
    assert (inner["start"], inner["end"], inner["instructions"]) == ("0x10", "0x40", 4)
    assert inner["opcodes"] == {"FFMA": 2, "LDS": 1, "BRA": 1}
    assert (outer["start"], outer["end"], outer["instructions"]) == ("0x0", "0x60", 7)
    assert outer["opcodes"]["MUFU"] == 1


@pytest.mark.parametrize("text, op", [
    ("@!P0 BRA 0x10", "BRA"), ("@P1 FFMA.FTZ R1, R2, R3, R4", "FFMA"),
    ("@!UP2 LDGSTS.E.BYPASS.128 [R61], desc[UR22][R52.64]", "LDGSTS"),
    ("HMMA.16816.F32.BF16 R48, R32, R36, RZ", "HMMA")])
def test_opcode_strips_predicate_and_modifiers(text, op):
    assert sass_loops.opcode(text) == op


def test_main_filters_functions(tmp_path, capsys):
    path = tmp_path / "sass.txt"
    path.write_text(LISTING)
    assert [r["function"] for r in sass_loops.main([str(path)])] == ["_Z4testPf", "_Z5otherPf"]
    assert [r["function"] for r in sass_loops.main([str(path), "other"])] == ["_Z5otherPf"]
    assert capsys.readouterr().out.count("\n") == 3
