"""The port's CUDA conv kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA device. On a
machine with a card (and without JAX, which tests/conftest.py imports):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances as in chip_smoke.py: the same rounding points, f32 sums in
another order, so y may round to the neighbouring bf16 value.
"""

import pytest
import torch

from pcseg_tpu_torch.ops import conv3d_block as cb

pytestmark = pytest.mark.cuda


@pytest.fixture()
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, b, r, cin, cout, k):
    dev = "cuda"
    x = torch.randn((b, r, r, r, cin), generator=gen, device=dev).to(
        torch.bfloat16)
    w = torch.rand((k, k, k, cin, cout), generator=gen, device=dev) - 0.5
    bias = torch.randn((cout,), generator=gen, device=dev) * 0.1
    scale = torch.rand((b, cin), generator=gen, device=dev) + 0.5
    shift = torch.randn((b, cin), generator=gen, device=dev) * 0.1 + 0.5
    return x, w, bias, scale, shift


def _close(got, ref):
    (y, st), (yp, stp) = got, ref
    torch.testing.assert_close(y.float(), yp.float(), rtol=2.0 ** -7,
                               atol=1e-3)
    if stp is None:
        assert st is None
    else:
        torch.testing.assert_close(st, stp, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("case", ["act", "act+accum", "stem", "no-stats"])
@pytest.mark.parametrize("r,c", [(8, 16), (4, 32), (12, 64)])
def test_conv3x3_kernel(gen, case, r, c):
    x, w, bias, scale, shift = _inputs(gen, 2, r, c, c, 3)
    accum = None
    if case == "act+accum":
        accum = torch.randn(x.shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    kw = dict(activate=case != "stem", want_stats=case != "no-stats")
    before = cb.LAUNCHES["conv3x3_gn_act"]
    got = cb.conv3x3_gn_act(x, w, bias, scale, shift, accum, **kw)
    torch.cuda.synchronize()
    assert cb.LAUNCHES["conv3x3_gn_act"] == before + 1
    _close(got, cb.conv3x3_gn_act_plain(x, w, bias, scale, shift, accum, **kw))


@pytest.mark.parametrize("r,c", [(8, 16), (16, 32)])
def test_down2x_kernel(gen, r, c):
    x, w, bias, scale, shift = _inputs(gen, 2, r, c, 2 * c, 2)
    got = cb.down2x_gn_act(x, w, bias, scale, shift)
    torch.cuda.synchronize()
    _close(got, cb.down2x_gn_act_plain(x, w, bias, scale, shift))


@pytest.mark.parametrize("r,c", [(4, 16), (6, 32)])
def test_up2x_kernel(gen, r, c):
    x, w, bias, scale, shift = _inputs(gen, 2, r, 2 * c, c, 2)
    got = cb.up2x_gn_act(x, w, bias, scale, shift)
    torch.cuda.synchronize()
    _close(got, cb.up2x_gn_act_plain(x, w, bias, scale, shift))


def _grid(gen, b, dhw, cin, cout):
    """_inputs on a (D, H, W) grid that need not be a cube."""
    x, w, bias, scale, shift = _inputs(gen, b, 2, cin, cout, 2)
    x = torch.randn((b, *dhw, cin), generator=gen, device="cuda").to(
        torch.bfloat16)
    return x, w, bias, scale, shift


@pytest.mark.parametrize("b,dhw,c", [(2, (8, 8, 8), 8), (2, (16, 16, 16), 16),
                                     (2, (8, 8, 16), 32), (2, (8, 8, 8), 64),
                                     (1, (6, 10, 24), 16)])
def test_down2x_mma_kernel(gen, b, dhw, c):
    """csrc/resample.cu's gathered tensor-core kernel at every fine width
    it takes (B1 6 x 10 x 24: 180 coarse voxels, a ragged last tile whose
    rows cross the coarse grid's rows), against the plain version, and bit
    for bit the same in a second call."""
    x, w, bias, scale, shift = _grid(gen, b, dhw, c, 2 * c)
    before = dict(cb.LAUNCHES)
    got = cb.down2x_gn_act(x, w, bias, scale, shift)
    again = cb.down2x_gn_act(x, w, bias, scale, shift)
    torch.cuda.synchronize()
    assert cb.LAUNCHES["down2x_mma"] == before["down2x_mma"] + 2
    assert cb.LAUNCHES["down2x_gn_act"] == before["down2x_gn_act"] + 2
    _close(got, cb.down2x_gn_act_plain(x, w, bias, scale, shift))
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.parametrize("cin,cout", [(4, 8), (16, 24)])
def test_down2x_other_widths_take_the_cuda_core_kernel(gen, cin, cout):
    """Shapes outside resample.cu's widths keep conv3d_block.cu's kernel,
    a route declared by shape."""
    x, w, bias, scale, shift = _inputs(gen, 2, 8, cin, cout, 2)
    before = dict(cb.LAUNCHES)
    got = cb.down2x_gn_act(x, w, bias, scale, shift)
    torch.cuda.synchronize()
    assert cb.LAUNCHES["down2x_mma"] == before["down2x_mma"]
    assert cb.LAUNCHES["down2x_gn_act"] == before["down2x_gn_act"] + 1
    _close(got, cb.down2x_gn_act_plain(x, w, bias, scale, shift))


def test_wrapper_rejects_bad_input(gen):
    x, w, bias, scale, shift = _inputs(gen, 2, 8, 16, 16, 3)
    with pytest.raises(TypeError):
        cb.conv3x3_gn_act(x.float(), w, bias, scale, shift)
    with pytest.raises(ValueError):
        cb.conv3x3_gn_act(x[..., :6, :], w, bias, scale, shift)
    with pytest.raises(ValueError):
        cb.conv3x3_gn_act(x, w, bias, scale[:1], shift)
