"""The SASS comparison tool's parsing of cuobjdump output (the tool itself
runs only where the CUDA toolkit is installed)."""

from videoseal_tpu_torch.kernels.sass_diff import _key, _regions, parse

OLD = "_ZN49_GLOBAL__N__1ab40703_16_convnext_dwln_cu_46e100b28cnx_dwlnIfEEvPKT_PKfS4_S4_S4_P13__nv_bfloat16iii"
NEW = "_ZN49_GLOBAL__N__301540d8_16_convnext_dwln_cu_46e100b28cnx_dwlnIfEEvPKT_PKfS4_S4_S4_P13__nv_bfloat16iii"

SASS = f"""
\tcode for sm_90a
\t\tFunction : {OLD}
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000e220000000800 */
        /*0010*/              @!P0 BRA 0x40 ;                             /* 0x0000000000008947 */
                                                                          /* 0x000fea0003800000 */
        /*0020*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;  /* 0x0000000c0804723c */
                                                                          /* 0x000fde0000041804 */
        /*0030*/                   HMMA.16816.F32.BF16 R4, R8, R14, R4 ;  /* 0x0000000e0804723c */
                                                                          /* 0x000fde0000041804 */
        /*0040*/                   EXIT ;                                 /* 0x000000000000794d */
                                                                          /* 0x000fea0003800000 */
"""

RES = f"""Resource usage:
 Common:
  GLOBAL:0
 Function {OLD}:
  REG:128 STACK:0 SHARED:1024 LOCAL:0 CONSTANT[0]:608 TEXTURE:0 SURFACE:0 SAMPLER:0
"""


def test_key_drops_the_per_file_namespace_hash():
    assert (_key(OLD) == _key(NEW)
            == "_ZN11_GLOBAL__N_8cnx_dwlnIfEEvPKT_PKfS4_S4_S4_P13__nv_bfloat16iii")
    assert _key("_Z6kernelPf") == "_Z6kernelPf"


def test_parse_reads_instructions_and_registers():
    funcs, regs = parse(SASS, RES)
    key = _key(OLD)
    assert list(funcs) == [key]
    assert funcs[key] == ["LDC R1, c[0x0][0x28]", "@!P0 BRA 0x40",
                          "HMMA.16816.F32.BF16 R4, R8, R12, R4",
                          "HMMA.16816.F32.BF16 R4, R8, R14, R4", "EXIT"]
    assert regs == {key: 128}
    assert _regions(funcs[key]) == (2, 2, 1)
    assert _regions(["EXIT"]) == (1,)
