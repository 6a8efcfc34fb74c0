"""`kmeans_tpu_torch/tools/sass.py` on the CPU: the parsers behind the
`ptxas` and `sass` lines of `chip_smoke.py`, on hand-made compiler output
(the toolkit itself runs only on the card's machine)."""

import pytest

from kmeans_tpu_torch.tools import sass

MANGLED = {
    "_ZN51_GLOBAL__N__07d58f05_18_quantize_assign_cu_ef1646b419assign_exact_kernelILi0ELb0EEEv"
    "PKhlllPKfiiiPKiS6_S4_S4_iliiiPvll": "assign_exact_kernel<0,0>",
    "_ZN51_GLOBAL__N__07d58f05_18_quantize_assign_cu_ef1646b413assign_kernelILi1ELi3ELi16EEEv"
    "PKhlllPKfiiPKiS4_S6_S4_S4_iliiiPvll": "assign_kernel<1,3,16>",
    "_ZN52_GLOBAL__N__a910e99b_19_lloyd_accumulate_cu_38cbc3cd17lloyd_tile_kernelILi0ELi0ELi0E"
    "EEvPKvillPKfiiS4_S4_iPf": "lloyd_tile_kernel<0,0,0>",
    "_ZN52_GLOBAL__N__a910e99b_19_lloyd_accumulate_cu_38cbc3cd17sum_blocks_kernelEPKfiiPf":
        "sum_blocks_kernel",
}


@pytest.mark.parametrize("mangled,short", list(MANGLED.items()))
def test_short_name(mangled, short):
    assert sass.short_name(mangled) == short


PTXAS = """ptxas info    : Compiling entry function '{0}' for 'sm_90a'
ptxas info    : Function properties for {0}
    96 bytes stack frame, 14 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 96 bytes cumulative stack size
ptxas info    : Compiling entry function '{1}' for 'sm_90a'
ptxas info    : Function properties for {1}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
"""


def test_ptxas_lines_parse():
    names = list(MANGLED)
    rows = [
        {"kernel": sass.short_name(m.group(1)), "registers": int(m.group(5)),
         "spill_store_bytes": int(m.group(3)), "spill_load_bytes": int(m.group(4)),
         "stack_bytes": int(m.group(2))}
        for m in sass._PTXAS.finditer(PTXAS.format(names[0], names[3]))
    ]
    assert rows == [
        {"kernel": "assign_exact_kernel<0,0>", "registers": 128, "spill_store_bytes": 14,
         "spill_load_bytes": 28, "stack_bytes": 96},
        {"kernel": "sum_blocks_kernel", "registers": 32, "spill_store_bytes": 0,
         "spill_load_bytes": 0, "stack_bytes": 0},
    ]


SASS = """
	code for sm_90a
		Function : {0}
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_ACCELERATORS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                          /* 0x00000a00ff017b82 */
        /*0010*/                   STS.128 [R3], R4 ;                             /* 0x0000000403007388 */
        /*0020*/                   MOV R9, RZ ;                                   /* 0x000000ffff097202 */
        /*0030*/                   LDS.128 R4, [R2+0x400] ;                       /* 0x0004000002047984 */
        /*0040*/                   FADD R5, -R5, R8 ;                             /* 0x0000000805057221 */
        /*0050*/                   FMUL R5, R5, R5 ;                              /* 0x0000000505057220 */
        /*0060*/               @P0 BRA 0x80 ;                                     /* 0x0000000000040947 */
        /*0070*/                   FFMA R6, R5, R7, R6 ;                          /* 0x0000000705067223 */
        /*0080*/                   ISETP.GE.AND P1, PT, R9, R10, PT ;             /* 0x0000000a0900720c */
        /*0090*/              @!P1 BRA 0x30 ;                                     /* 0xfffffff000e49947 */
        /*00a0*/              @!P2 BRA 0x20 ;                                     /* 0xfffffff000d49947 */
        /*00b0*/                   EXIT ;                                         /* 0x000000000000794d */
		Function : {1}
        /*0000*/                   EXIT ;                                         /* 0x000000000000794d */
"""


def test_centroid_loop_is_the_smallest_loop_around_the_first_lds128():
    names = list(MANGLED)
    functions = sass._functions(SASS.format(names[0], names[3]))
    assert list(functions) == ["assign_exact_kernel<0,0>", "sum_blocks_kernel"]
    loop = sass.centroid_loop(functions["assign_exact_kernel<0,0>"])
    assert loop["start"] == "0x30" and loop["instructions"] == 7 and loop["lds128"] == 1
    assert loop["opcodes"] == {"LDS.128": 1, "FADD": 1, "FMUL": 1, "BRA": 2, "FFMA": 1,
                               "ISETP.GE.AND": 1}
    assert sass.centroid_loop(functions["sum_blocks_kernel"]) is None


def test_chip_smoke_tile_sizes_match_the_sources():
    """`chip_smoke.py` divides a centroid loop's length by the pixels a
    thread scans together: its table must hold the sources' constants."""
    import re
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    csrc = root / "kmeans_tpu_torch" / "csrc"
    assign = (csrc / "quantize_assign.cu").read_text()
    lloyd = (csrc / "lloyd_accumulate.cu").read_text()
    p94, p2000 = map(int, re.search(r"return metric == kMetricCie94 \? (\d+) : (\d+);",
                                    assign).groups())
    tile = int(re.search(r"constexpr int kTilePixels = (\d+);", lloyd).group(1))
    smoke = (root / "chip_smoke.py").read_text()
    table = dict(re.findall(r'"(\w+<[\d,]+)": (\d+)', smoke.split("TILE_PIXELS = ", 1)[1]
                            .split("}", 1)[0]))
    assert {k: int(v) for k, v in table.items()} == {
        "assign_exact_kernel<0": p94, "assign_exact_kernel<1": p2000,
        "lloyd_tile_kernel<0,0": tile, "lloyd_tile_kernel<1,0": 1}
