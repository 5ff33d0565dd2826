"""The profilers' stage table books every PointNet training kernel by
name (the names as torch.profiler reports them on the card), and no key
of one stage catches a kernel of another."""

import pytest

from pcseg_tpu_torch.profile_serving import stage_of

NS = "void (anonymous namespace)::"


@pytest.mark.parametrize("name, stage", [
    ("(anonymous namespace)::gp_wgmma_fwd_kernel(CUtensorMap_st, "
     "CUtensorMap_st, (anonymous namespace)::FwdArgs)", "global_pool"),
    ("(anonymous namespace)::pool_finalize_kernel(unsigned long long "
     "const*, float*, int*, long long)", "global_pool"),
    ("(anonymous namespace)::gp_cotangent_kernel(__nv_bfloat16 const*, "
     "float const*)", "global_pool_bwd"),
    ("(anonymous namespace)::gp_wgmma_dx_kernel(CUtensorMap_st)",
     "global_pool_bwd"),
    ("(anonymous namespace)::gp_wgmma_dw_kernel(CUtensorMap_st)",
     "global_pool_bwd"),
    (NS + "fwd_kernel<true>(__nv_bfloat16 const*, (anonymous namespace)::"
     "Prologue)", "pointnet_block"),
    # a kernel that is not a template has no "void " in front
    ("(anonymous namespace)::cotangent_kernel(void const*, int)",
     "pointnet_block"),
    (NS + "dx_kernel<true>(__nv_bfloat16 const*)", "pointnet_block"),
    (NS + "dw_kernel<false>(__nv_bfloat16 const*)", "pointnet_block"),
    (NS + "ce_fwd_kernel<4>(__nv_bfloat16 const*)", "seg4_ce"),
    (NS + "ce_dlogits_kernel<4>(__nv_bfloat16 const*)", "seg4_ce"),
    (NS + "dropout_kernel<float>(float const*, float*)", "dropout"),
    # row 19's pool and PyTorch's own kernels are not PointNet stages
    (NS + "pool_fwd_kernel<__nv_bfloat16, 8>(__nv_bfloat16 const*)", "glue"),
    (NS + "pool_bwd_kernel<float, 4>(int const*)", "glue"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>>", "glue"),
])
def test_pointnet_kernels_have_their_stage(name, stage):
    assert stage_of(name) == stage
