"""NWD U-Net: the 1-D waveform-demixing network as an ``nn.Module``.

The layer graph of ``circuitmap_tpu/demix/unet.py`` (and of the
reference NWDUNet): four down blocks (avg-pool -> dilated conv ->
batch-norm -> relu), four up blocks (transposed conv -> bn -> relu ->
linear resize -> skip concat) and a wide dilated output head (kernel
256, padding 255, dilation 2). The state_dict keys are the reference's
(``dblock1.conv.weight`` ...), so checkpoints carry across by re-keying
alone (demix/convert.py).

Numerics: the JAX head runs at ``Precision.HIGHEST``; on the GPU the
demixer therefore runs its convolutions with cuDNN's TF32 off
(demix/demixer.py). The graph is :func:`forward_shards`, written over
a list of shards so that the data-parallel trainer can normalise over
the global batch; ``NWDUNet.forward`` is its one-shard case. BatchNorm
(eps 1e-5) runs in eval mode for
inference (running statistics, so every trace is demixed independently
of its batch) and in train mode for training: batch statistics, and a
running-average update with momentum 0.1 from the batch mean and the
unbiased batch variance, which is the JAX package's
``update_running_stats``. Gradients come from autograd (the JAX
package's custom VJP of the transposed convolution works around slow
XLA autodiff on the CPU; cuDNN needs none). With
``torch.backends.cudnn.deterministic`` set, training's linear resize is
a product with its weights (``_resize``), so that training on the card
repeats bit for bit. In inference on the card an up block's ReLU, resize
and skip concat run as one kernel (``ops/resize_cuda.py``), equal to
ATen's ops to the last bit.

:func:`init_nwd_params` draws a fresh network from an explicit
``torch.Generator`` by the JAX package's rule (``init_nwd_params``:
kaiming-uniform fan-in bounds for weights and biases, fan-in O*K for the
transposed convolutions' [I, O, K] weights). Its draws cannot equal
jax.random's; tests carry weights across with
``convert.params_from_jax``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import resize_cuda

BN_EPS = 1e-5
BN_MOMENTUM = 0.1

# (in_ch, out_ch, kernel, dilation) per down block; (in_ch, out_ch,
# kernel, stride) per up block
DOWN_SPECS = [(1, 16, 32, 2), (16, 16, 32, 1), (16, 32, 16, 1), (32, 32, 16, 1)]
UP_SPECS = [(32, 16, 16, 1), (48, 16, 16, 1), (32, 16, 32, 1), (32, 4, 32, 2)]
OUT_SPEC = dict(in_ch=4, out_ch=1, kernel=256, padding=255, dilation=2)


def _resize(h, size):
    """The up blocks' linear resize, ``F.interpolate(h, size,
    mode="linear", align_corners=False)``. When training asks for
    repeatable results (``torch.backends.cudnn.deterministic`` set while
    autograd records) it is the product with the resize's weights
    instead, so its backward is a product too: interpolate's backward
    adds with atomics on the card, and two training runs of the same
    data would part in the last bits each step and drift apart."""
    if (torch.backends.cudnn.deterministic and torch.is_grad_enabled()
            and h.requires_grad):
        return h @ _resize_weights(h.shape[-1], size, h.device, h.dtype)
    return F.interpolate(h, size=size, mode="linear", align_corners=False)


@functools.lru_cache(maxsize=64)
def _resize_weights(length, size, device, dtype):
    """The linear resize from ``length`` to ``size`` samples as its
    [length, size] weights (interpolate's own, applied to the identity)."""
    eye = torch.eye(length, device=device, dtype=dtype)
    return F.interpolate(eye[None], size=size, mode="linear",
                         align_corners=False)[0]


def _relu_resize_cat(h, size, skip):
    """An up block's epilogue after its BatchNorm: ReLU, the linear
    resize to ``size`` samples, then ``skip``'s channels (if any). U-Net
    inference on the card takes one kernel (``ops/resize_cuda.py``);
    the CPU and autograd recording through ``h`` (training: the kernel
    has no backward) take ATen's ops and ``_resize``."""
    if h.is_cuda and not (torch.is_grad_enabled() and h.requires_grad):
        return resize_cuda.relu_resize_cat(h, size, skip)
    h = _resize(F.relu(h), size)
    return h if skip is None else torch.cat([h, skip], dim=1)


class _Down(nn.Module):
    def __init__(self, ci, co, k, dilation):
        super().__init__()
        self.conv = nn.Conv1d(ci, co, k, dilation=dilation)
        self.bn = nn.BatchNorm1d(co, eps=BN_EPS, momentum=BN_MOMENTUM)


class _Up(nn.Module):
    def __init__(self, ci, co, k, stride):
        super().__init__()
        self.deconv = nn.ConvTranspose1d(ci, co, k, stride=stride)
        self.bn = nn.BatchNorm1d(co, eps=BN_EPS, momentum=BN_MOMENTUM)


class _Head(nn.Module):
    def __init__(self):
        super().__init__()
        s = OUT_SPEC
        self.conv = nn.Conv1d(s["in_ch"], s["out_ch"], s["kernel"],
                              padding=s["padding"], dilation=s["dilation"])
        self.bn = nn.BatchNorm1d(s["out_ch"], eps=BN_EPS,
                                 momentum=BN_MOMENTUM)


def forward_shards(nets, xs, norm):
    """The U-Net's graph over shards in lockstep: ``nets`` holds one
    network per shard (shards on one device share one), ``xs`` the
    shards' [b, 1, L] inputs, and ``norm(name, hs)`` returns the
    normalised per-shard pre-activations ``hs`` of block ``name``
    (``dblock1``..``dblock4``, ``ublock1``..``ublock4``, ``conv``).
    Every shard reaches a block's normalisation before any goes on, so
    ``norm`` may reduce over all of them: the data-parallel trainer's
    global-batch BatchNorm (``demixer._global_batch_norm``). Returns the
    shards' [b, 1, L] outputs."""
    def down(name, hs):
        hs = [getattr(net, name).conv(F.avg_pool1d(h, 3, stride=2))
              for net, h in zip(nets, hs)]
        return [F.relu(h) for h in norm(name, hs)]

    def up(name, hs, size, skips=None):
        hs = norm(name, [getattr(net, name).deconv(h)
                         for net, h in zip(nets, hs)])
        skips = [None] * len(hs) if skips is None else skips
        return [_relu_resize_cat(h, size, skip) for h, skip in zip(hs, skips)]

    e1 = down("dblock1", xs)
    e2 = down("dblock2", e1)
    e3 = down("dblock3", e2)
    e4 = down("dblock4", e3)
    d1 = up("ublock1", e4, e3[0].shape[-1], e3)
    d2 = up("ublock2", d1, e2[0].shape[-1], e2)
    d3 = up("ublock3", d2, e1[0].shape[-1], e1)
    d4 = up("ublock4", d3, xs[0].shape[-1])
    hs = [net.conv.conv(h) for net, h in zip(nets, d4)]
    return [F.relu(h) for h in norm("conv", hs)]


class NWDUNet(nn.Module):
    """Demixer forward: x [B, 1, L] -> [B, 1, L]."""

    def __init__(self):
        super().__init__()
        for i, spec in enumerate(DOWN_SPECS):
            self.add_module(f"dblock{i + 1}", _Down(*spec))
        for i, spec in enumerate(UP_SPECS):
            self.add_module(f"ublock{i + 1}", _Up(*spec))
        self.conv = _Head()

    def forward(self, x):
        # one shard, each block normalised by its own BatchNorm
        return forward_shards(
            [self], [x], lambda name, hs: [getattr(self, name).bn(hs[0])])[0]


def init_nwd_params(generator, dtype=torch.float32):
    """A fresh network's state_dict, drawn from ``generator`` by the JAX
    package's rule: each conv weight and bias uniform in +-1/sqrt(fan_in)
    (fan_in = I*K for Conv1d [O, I, K], O*K for ConvTranspose1d
    [I, O, K]); BatchNorm at scale 1, bias 0, running mean 0 and
    variance 1."""
    net = NWDUNet()
    sd = net.state_dict()

    def uniform(shape, fan_in):
        bound = 1.0 / fan_in ** 0.5
        u = torch.rand(shape, generator=generator, dtype=torch.float64)
        return ((2.0 * u - 1.0) * bound).to(dtype)

    convs = [(f"dblock{i + 1}.conv", ci * k)
             for i, (ci, _co, k, _d) in enumerate(DOWN_SPECS)]
    convs += [(f"ublock{i + 1}.deconv", co * k)
              for i, (_ci, co, k, _s) in enumerate(UP_SPECS)]
    convs += [("conv.conv", OUT_SPEC["in_ch"] * OUT_SPEC["kernel"])]
    for name, fan_in in convs:
        for leaf in ("weight", "bias"):
            key = f"{name}.{leaf}"
            sd[key] = uniform(sd[key].shape, fan_in)
    return {k: (v.to(dtype) if v.is_floating_point() else v)
            for k, v in sd.items()}
