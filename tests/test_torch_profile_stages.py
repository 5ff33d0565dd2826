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
    (NS + "dropout_kernel<float>(float const*, float*)", "dropout"),
    # row 19's pool and PyTorch's own kernels are not PointNet stages
    (NS + "pool_fwd_kernel<__nv_bfloat16, 8>(__nv_bfloat16 const*)", "glue"),
    (NS + "pool_bwd_kernel<float, 4>(int const*)", "glue"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>>", "glue"),
])
def test_pointnet_kernels_have_their_stage(name, stage):
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
