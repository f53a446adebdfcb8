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
(demix/demixer.py). BatchNorm (eps 1e-5) runs in eval mode for
inference (running statistics, so every trace is demixed independently
of its batch) and in train mode for training: batch statistics, and a
running-average update with momentum 0.1 from the batch mean and the
unbiased batch variance, which is the JAX package's
``update_running_stats``. Gradients come from autograd (the JAX
package's custom VJP of the transposed convolution works around slow
XLA autodiff on the CPU; cuDNN needs none).

:func:`init_nwd_params` draws a fresh network from an explicit
``torch.Generator`` by the JAX package's rule (``init_nwd_params``:
kaiming-uniform fan-in bounds for weights and biases, fan-in O*K for the
transposed convolutions' [I, O, K] weights). Its draws cannot equal
jax.random's; tests carry weights across with
``convert.params_from_jax``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1

# (in_ch, out_ch, kernel, dilation) per down block; (in_ch, out_ch,
# kernel, stride) per up block
DOWN_SPECS = [(1, 16, 32, 2), (16, 16, 32, 1), (16, 32, 16, 1), (32, 32, 16, 1)]
UP_SPECS = [(32, 16, 16, 1), (48, 16, 16, 1), (32, 16, 32, 1), (32, 4, 32, 2)]
OUT_SPEC = dict(in_ch=4, out_ch=1, kernel=256, padding=255, dilation=2)


class _Down(nn.Module):
    def __init__(self, ci, co, k, dilation):
        super().__init__()
        self.conv = nn.Conv1d(ci, co, k, dilation=dilation)
        self.bn = nn.BatchNorm1d(co, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x):
        return F.relu(self.bn(self.conv(F.avg_pool1d(x, 3, stride=2))))


class _Up(nn.Module):
    def __init__(self, ci, co, k, stride):
        super().__init__()
        self.deconv = nn.ConvTranspose1d(ci, co, k, stride=stride)
        self.bn = nn.BatchNorm1d(co, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x, size, skip=None):
        up = F.interpolate(F.relu(self.bn(self.deconv(x))), size=size,
                           mode="linear", align_corners=False)
        return up if skip is None else torch.cat([up, skip], dim=1)


class _Head(nn.Module):
    def __init__(self):
        super().__init__()
        s = OUT_SPEC
        self.conv = nn.Conv1d(s["in_ch"], s["out_ch"], s["kernel"],
                              padding=s["padding"], dilation=s["dilation"])
        self.bn = nn.BatchNorm1d(s["out_ch"], eps=BN_EPS,
                                 momentum=BN_MOMENTUM)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


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
        e1 = self.dblock1(x)
        e2 = self.dblock2(e1)
        e3 = self.dblock3(e2)
        e4 = self.dblock4(e3)
        d1 = self.ublock1(e4, e3.shape[-1], skip=e3)
        d2 = self.ublock2(d1, e2.shape[-1], skip=e2)
        d3 = self.ublock3(d2, e1.shape[-1], skip=e1)
        d4 = self.ublock4(d3, x.shape[-1])
        return self.conv(d4)


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
