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
    (NS + "chain_wgmma_fwd_kernel<128, 2>(CUtensorMap_st, CUtensorMap_st, "
     "(anonymous namespace)::FwdArgs)", "pointnet_block"),
    (NS + "chain_simt_fwd_kernel<4, 8>((anonymous namespace)::SimtArgs)",
     "pointnet_block"),
    (NS + "chain_narrow_fwd_kernel<4, 16>((anonymous namespace)::NarrowArgs)",
     "pointnet_block"),
    # a kernel that is not a template has no "void " in front
    ("(anonymous namespace)::chain_cotangent_kernel(void const*, int)",
     "pointnet_block_bwd"),
    (NS + "chain_wgmma_bwd_kernel<2, 128, false, true>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::"
     "SweepArgs)", "pointnet_block_bwd"),
    (NS + "chain_wgmma_dx_kernel<128>(CUtensorMap_st)", "pointnet_block_bwd"),
    (NS + "chain_wgmma_dw_kernel<256, 2>(CUtensorMap_st)",
     "pointnet_block_bwd"),
    (NS + "chain_simt_bwd_kernel<4, 8>((anonymous namespace)::SimtArgs)",
     "pointnet_block_bwd"),
    (NS + "chain_narrow_bwd_kernel<4, 16>((anonymous namespace)::NarrowArgs)",
     "pointnet_block_bwd"),
    # row 17 forward and backward, one kernel each
    (NS + "ce_seg4_fwd_kernel<4, 16>((anonymous namespace)::NarrowArgs)",
     "seg4_ce"),
    (NS + "ce_seg4_bwd_kernel<16, 32>((anonymous namespace)::NarrowArgs)",
     "seg4_ce"),
    ("(anonymous namespace)::ce_seg4_bwd_mma_kernel((anonymous namespace)::"
     "NarrowArgs)", "seg4_ce"),
    # past 32 classes: the wide tile kernels of rows 15 and 17
    (NS + "chain_wide_fwd_kernel<64>((anonymous namespace)::NarrowArgs)",
     "pointnet_block"),
    (NS + "chain_wide_bwd_kernel<128>((anonymous namespace)::NarrowArgs)",
     "pointnet_block_bwd"),
    (NS + "ce_seg4_wide_fwd_kernel<64>((anonymous namespace)::NarrowArgs)",
     "seg4_ce"),
    (NS + "ce_seg4_wide_bwd_kernel<64>((anonymous namespace)::NarrowArgs)",
     "seg4_ce"),
    (NS + "dropout_kernel<float>(float const*, float*)", "dropout"),
    # row 19's pool and PyTorch's own kernels are not PointNet stages
    (NS + "pool_fwd_kernel<__nv_bfloat16, 8>(__nv_bfloat16 const*)", "glue"),
    (NS + "pool_bwd_kernel<float, 4>(int const*)", "glue"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>>", "glue"),
])
def test_pointnet_kernels_have_their_stage(name, stage):
    assert stage_of(name) == stage


@pytest.mark.parametrize("name", [
    NS + "down2x_mma_kernel<16>((anonymous namespace)::DownArgs)",
    NS + "up2x_bwd_mma_kernel<16, 32>((anonymous namespace)::UpBwdArgs)",
    NS + "down2x_bwd_mma_kernel<16, 1>((anonymous namespace)::"
    "DownBwdArgs)",
    NS + "dgrad_mma_kernel<16>((anonymous namespace)::RingArgs)",
    NS + "wgrad_mma_kernel<16>((anonymous namespace)::RingArgs)",
    NS + "wgrad_mma_kernel<64>((anonymous namespace)::RingArgs)",
    NS + "conv3x3_mma_kernel<16>((anonymous namespace)::RingArgs)",
    NS + "conv3x3_mma_kernel<64>((anonymous namespace)::RingArgs)",
    NS + "up2x_mma_kernel<16>((anonymous namespace)::UpArgs)",
    NS + "up2x_mma_kernel<32>((anonymous namespace)::UpArgs)",
    "mma_sync::fixed_sum_kernel(float const*, float*, int, long long)",
])
def test_resample_kernels_are_conv_stage(name):
    """csrc/resample.cu's and csrc/conv3d_dgrad.cu's kernels (rows 4, 5,
    7, 2, 1, 6 and 3 and their fixed-order sums) book under the voxel
    U-Net's conv stage, as the kernels they took over from did."""
    assert stage_of(name) == "conv"


@pytest.mark.parametrize("name, stage", [
    ("(anonymous namespace)::trilinear_scatter_bin_kernel(float const*, "
     "float const*, uint4*, int*, int*, int, int, int, int, int, int, int)",
     "devox_scatter"),
    (NS + "trilinear_scatter_tile_kernel<4, true>((anonymous namespace)::"
     "ScatterArgs)", "devox_scatter"),
    (NS + "trilinear_scatter_long_kernel<32, false>((anonymous namespace)::"
     "ScatterArgs)", "devox_scatter"),
    (NS + "trilinear_gather_kernel<4, true>(float const*, unsigned char "
     "const*, __nv_bfloat16 const*, float*, long long, int, int, int)",
     "devox_gather"),
])
def test_devoxelize_kernels_have_their_stage(name, stage):
    """Rows 11 and 13's kernels (the scatter's binning, tile and long-tile
    kernels; the gather at each width) book under the devoxelize stages,
    not as glue."""
    assert stage_of(name) == stage


@pytest.mark.parametrize("name, stage", [
    # row 20's backward: the strided route, the vector route, their sums
    (NS + "bias_ln_relu_mask_bwd_kernel<__nv_bfloat16, __nv_bfloat16, 8>("
     "__nv_bfloat16 const*, float const*)", "ln_bwd"),
    (NS + "ln_bwd_vec_kernel<__nv_bfloat16, __nv_bfloat16, 8>(__nv_bfloat16 "
     "const*, float const*)", "ln_bwd"),
    ("(anonymous namespace)::column_sum_kernel(float const*, int, int, "
     "float*)", "ln_bwd"),
    (NS + "bias_ln_relu_mask_kernel<__nv_bfloat16, __nv_bfloat16, 8>("
     "__nv_bfloat16 const*)", "ln"),
    # row 9: the tile kernel and its fixed-order sums; row 8
    (NS + "head_bwd_kernel<1, true>((anonymous namespace)::HeadBwdArgs)",
     "head_bwd"),
    ("(anonymous namespace)::head_bwd_sum_kernel(float const*, int, int, "
     "int, int, float*, float*, float*)", "head_bwd"),
    (NS + "head_fwd_kernel<16>(__nv_bfloat16 const*, float const*)",
     "head"),
    # row 8: the tensor-core kernel and the streaming route
    (NS + "head_fwd_kernel<1, 4>((anonymous namespace)::HeadFwdArgs)",
     "head"),
    ("(anonymous namespace)::head_fwd_stream_kernel(__nv_bfloat16 const*, "
     "float const*)", "head"),
    # row 10: the voxelizer's one launch (its table's zeros included), on
    # int32 and on int64 ids
    (NS + "voxelize_contract_kernel<int>((anonymous namespace)::"
     "VoxArgs<int>)", "voxelize"),
    (NS + "voxelize_contract_kernel<long long>((anonymous namespace)::"
     "VoxArgs<long long>)", "voxelize"),
])
def test_ln_and_head_kernels_have_their_stage(name, stage):
    """Rows 20, 9, 8 and 10 (both backward routes and the sum kernels,
    both head routes, the voxelizer's kernel) book under "ln" /
    "ln_bwd", "head" / "head_bwd" and "voxelize", not as glue."""
    assert stage_of(name) == stage


def _fake_profiles(monkeypatch, attempts):
    """profile_serving.device_profile answering each call with the next
    of ``attempts``: lists of (kernel name, device ms, recorded calls)."""
    from pcseg_tpu_torch import profile_serving as ps

    queue = list(attempts)

    def fake(fn, stages=None):
        fn()
        kernels = [{"name": n, "device_ms": ms, "calls": c}
                   for n, ms, c in queue.pop(0)]
        return {"kernels": kernels}, None

    monkeypatch.setattr(ps, "device_profile", fake)
    return ps, queue


def test_profile_calls_takes_a_complete_profile_once(monkeypatch):
    ps, queue = _fake_profiles(monkeypatch, [
        [("k_a", 2.0, 10), ("k_b", 0.5, 20)], [("k_a", 9.9, 10)]])
    got = ps.profile_calls(lambda: None, iters=10)
    assert got == {"k_a": 0.2, "k_b": 0.05}
    assert len(queue) == 1  # not profiled again


def test_profile_calls_counts_the_launches_the_profiler_dropped(
        monkeypatch):
    """Late in a long process torch.profiler keeps only some launches:
    the kernel is profiled again, and its time a call is its mean a
    recorded launch times its launches a call."""
    ps, queue = _fake_profiles(monkeypatch, [
        [("k_a", 0.6, 4), ("k_b", 0.7, 7)],
        [],
        [("k_a", 0.75, 5), ("k_b", 1.6, 16)]])
    got = ps.profile_calls(lambda: None, iters=10, attempts=3)
    assert not queue
    assert abs(got["k_a"] - 0.15) < 1e-12   # 0.15 a launch, 1 a call
    assert abs(got["k_b"] - 0.2) < 1e-12    # 0.1 a launch, 2 a call
