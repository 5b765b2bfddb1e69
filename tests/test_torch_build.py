"""The kernel build's ptxas report (``paddle_tpu_torch/ops/_build.py``):
each register / spill line put beside the kernel it belongs to, the
mangled name shortened to ``name<args>``.  Pure text: runs on the CPU."""

import pytest

from paddle_tpu_torch.ops._build import kernel_label, ptxas_report

# two kernels of one nvcc -Xptxas=-v build, as ptxas prints them
LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__4af27cb8_18_flash_attention_cu_eb31b8be20flash_bwd_dkv_kernelILi128EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_S6_iiif' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__4af27cb8_18_flash_attention_cu_eb31b8be20flash_bwd_dkv_kernelILi128EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_S6_iiif
    32 bytes stack frame, 32 bytes spill stores, 48 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 32 bytes cumulative stack size
ptxas info    : Compile time = 549.102 ms
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__8606c4e4_17_rmsnorm_matmul_cu_1a0be84721rmsnorm_matmul_kernelILb1E13__nv_bfloat16EEv14CUtensorMap_stS2_S2_PKS1_PS1_iiif' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__8606c4e4_17_rmsnorm_matmul_cu_1a0be84721rmsnorm_matmul_kernelILb1E13__nv_bfloat16EEv14CUtensorMap_stS2_S2_PKS1_PS1_iiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 16 bytes smem
"""


def test_ptxas_report_puts_each_line_beside_its_kernel():
    rep = ptxas_report(LOG)
    assert rep == {
        "flash_bwd_dkv_kernel<128>": {
            "registers": 255, "spill_stores": 32, "spill_loads": 48,
            "stack": 32, "smem": 0},
        "rmsnorm_matmul_kernel<1, __nv_bfloat16>": {
            "registers": 168, "spill_stores": 0, "spill_loads": 0,
            "stack": 0, "smem": 16}}
    assert ptxas_report("") == {}


@pytest.mark.parametrize("mangled,label", [
    ("_ZN12_GLOBAL__N_116flash_fwd_kernelILi64EEEv14CUtensorMap_st",
     "flash_fwd_kernel<64>"),
    ("_ZN12_GLOBAL__N_121rmsnorm_matmul_kernelILb0EfEEv14CUtensorMap_st",
     "rmsnorm_matmul_kernel<0, float>"),
    ("_ZN12_GLOBAL__N_125paged_decode_split_kernelIaLi8EEEvPKv",
     "paged_decode_split_kernel<int8_t, 8>"),
    ("_ZN12_GLOBAL__N_111rope_kernelEv", "rope_kernel"),
    ("_ZN12_GLOBAL__N_114rms_bwd_kernelILi8E13__nv_bfloat16S1_fEEvPKT0_",
     "rms_bwd_kernel<8, __nv_bfloat16, __nv_bfloat16, float>"),
    ("_Z5probe14CUtensorMap_stS_Pfi", "probe"),
    ("plain_c_name", "plain_c_name"),
])
def test_kernel_label_shortens_a_mangled_name(mangled, label):
    assert kernel_label(mangled) == label
