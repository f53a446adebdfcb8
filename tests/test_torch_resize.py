"""The U-Net up blocks' resize taps and their epilogue's dispatch, on
the CPU.

``ops/resize_cuda.py::_resize_taps`` gives the taps that the card's
epilogue kernel (``csrc/resize.cu``) reads; here they are
applied by a plain gather-lerp and held to ``F.interpolate(mode="linear",
align_corners=False)``: in float64 to 1e-12, in float32 to one ulp of
unit-scale data (the gather-lerp rounds its two products apart, ATen's
CPU kernel may fuse one). The kernel itself runs only on the card
(``tests/test_torch_kernels.py``); here its wrapper's checks and launch
plan, and that the CPU and training keep ATen's ops.
"""

import pytest
import torch
import torch.nn.functional as F

from circuitmap_torch.demix import unet
from circuitmap_torch.ops import resize_cuda

# the U-Net's four up blocks at 900 samples, then edge pairs: the same
# length, a downsample, one sample, a halving
PAIRS = [(32, 65), (80, 162), (193, 387), (804, 900),
         (5, 5), (7, 3), (1, 4), (900, 450)]
# (C, L_in, L_out, Cs) of ublock1..4 at 900 samples
UNET_UP = [(16, 32, 65, 32), (16, 80, 162, 16), (16, 193, 387, 16),
           (4, 804, 900, 0)]


def _interpolate(x, size):
    return F.interpolate(x, size=size, mode="linear", align_corners=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("length,size", PAIRS)
def test_resize_taps_gather_lerp_is_interpolate(length, size, dtype):
    lo, hi, frac = resize_cuda._resize_taps(length, size, torch.device("cpu"),
                                            dtype)
    assert lo.dtype == hi.dtype == torch.int32 and frac.dtype == dtype
    assert lo.shape == hi.shape == frac.shape == (size,)
    assert int(lo.min()) >= 0 and int(hi.max()) <= length - 1
    assert torch.equal(hi, torch.clamp(lo + 1, max=length - 1))
    assert bool(((frac >= 0) & (frac < 1)).all())
    gen = torch.Generator().manual_seed(length * 1000 + size)
    x = torch.rand(6, 5, length, generator=gen, dtype=torch.float64).to(dtype)
    got = (x[..., lo.long()] * (1 - frac) + x[..., hi.long()] * frac)
    tol = 1e-12 if dtype == torch.float64 else torch.finfo(dtype).eps
    torch.testing.assert_close(got, _interpolate(x, size), rtol=0, atol=tol)


def test_resize_taps_outlive_inference_mode():
    """Taps first asked for under ``inference_mode`` (a demix) serve a
    later caller that records autograd."""
    resize_cuda._resize_taps.cache_clear()
    with torch.inference_mode():
        taps = resize_cuda._resize_taps(31, 62, torch.device("cpu"),
                                        torch.float64)
    assert not any(t.is_inference() for t in taps)
    h = torch.randn(2, 3, 31, dtype=torch.float64, requires_grad=True)
    resize_cuda.relu_resize_cat_torch(h, 62).sum().backward()
    assert h.grad is not None


@pytest.mark.parametrize("C,L_in,L_out,Cs", UNET_UP)
def test_plain_epilogue_is_relu_interpolate_cat(C, L_in, L_out, Cs):
    """``relu_resize_cat_torch``, the kernel's arithmetic in plain
    PyTorch, is ReLU, ``F.interpolate`` and the concat (float64)."""
    gen = torch.Generator().manual_seed(C + L_in)
    h = torch.randn(3, C, L_in, generator=gen, dtype=torch.float64)
    skip = torch.randn(3, Cs, L_out, generator=gen, dtype=torch.float64)
    got = resize_cuda.relu_resize_cat_torch(h, L_out, skip if Cs else None)
    want = _interpolate(F.relu(h), L_out)
    if Cs:
        want = torch.cat([want, skip], dim=1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def test_cpu_and_training_keep_aten_ops(monkeypatch):
    """``forward_shards`` on CPU tensors never calls the epilogue kernel's
    wrapper: in inference (``inference_mode`` and ``no_grad``) and in a
    training step with autograd recording."""
    def refuse(*args, **kw):
        raise AssertionError("the epilogue kernel's wrapper was called")

    wrapper = resize_cuda.relu_resize_cat
    before = wrapper.launches
    monkeypatch.setattr(resize_cuda, "relu_resize_cat", refuse)
    net = unet.NWDUNet().double()
    x = torch.randn(4, 1, 900, generator=torch.Generator().manual_seed(0),
                    dtype=torch.float64)
    net.eval()
    with torch.inference_mode():
        first = net(x)
    with torch.no_grad():
        assert torch.equal(net(x), first)
    net.train()
    loss = torch.mean(torch.square(net(x)))
    loss.backward()
    assert net.ublock1.deconv.weight.grad is not None
    assert wrapper.launches == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    h = torch.rand(2, 16, 193)
    skip = torch.rand(2, 16, 387)
    with pytest.raises(ValueError, match="no relu_resize_cat kernel"):
        resize_cuda.relu_resize_cat(h, 387, skip)
    with pytest.raises(ValueError, match="contiguous"):
        resize_cuda.relu_resize_cat(h.transpose(1, 2), 387)
    with pytest.raises(ValueError, match="skip must be"):
        resize_cuda.relu_resize_cat(h, 387, skip[..., :386])
    with pytest.raises(ValueError, match="skip must be"):
        resize_cuda.relu_resize_cat(h, 387, skip.double())
    with pytest.raises(TypeError, match="float32, float64, bfloat16 or"):
        resize_cuda.relu_resize_cat(h.to(torch.int32), 387)
    with pytest.raises(ValueError, match="size must be positive"):
        resize_cuda.relu_resize_cat(h, 0)


@pytest.mark.parametrize("C,L_in,L_out,Cs", UNET_UP)
@pytest.mark.parametrize("itemsize", [2, 4, 8])
def test_launch_plan_at_the_unet_shapes(C, L_in, L_out, Cs, itemsize):
    """At the U-Net's shapes a row's lines fit one block (G = C, staged),
    the block copies the whole skip, and every load and copy is 16-byte
    wide when the tensors are 16-byte aligned (in every type the kernel
    takes); one misaligned tensor turns the vectors off."""
    aligned = [256, 4096, 512]
    G, share, vec, staged = resize_cuda.plan(4096, C, Cs, L_in, L_out,
                                             itemsize, aligned)
    assert (G, vec, staged) == (C, True, True)
    assert share == Cs * L_out
    assert not resize_cuda.plan(4096, C, Cs, L_in, L_out, itemsize,
                                [256, 4100, 512])[2]


def test_launch_plan_splits_long_lines_into_channel_groups():
    """A row whose lines exceed a block's shared memory goes to groups
    of channels; their skip shares are whole 16-byte vectors and cover
    the row's skip. A line longer than shared memory is not staged: one
    block a channel reads it from ``h``."""
    C, L_in, L_out, Cs = 5, 3000, 3001, 3
    G, share, vec, staged = resize_cuda.plan(2, C, Cs, L_in, L_out, 8,
                                             [0, 0, 0])
    groups = -(-C // G)
    assert G == resize_cuda.SMEM_BYTES // (L_in * 8) == 2 and groups == 3
    assert staged
    assert share % 2 == 0 and share * (groups - 1) < Cs * L_out <= share * groups
    assert not vec  # Cs * L_out is odd
    L_in = resize_cuda.SMEM_BYTES // 8 + 1
    G, share, vec, staged = resize_cuda.plan(2, C, Cs, L_in, L_out, 8,
                                             [0, 0, 0])
    assert (G, staged) == (1, False)
    assert share % 2 == 0 and share * (C - 1) < Cs * L_out <= share * C
