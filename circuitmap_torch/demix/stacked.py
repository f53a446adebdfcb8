"""StackedDenoisingNetwork: a plain stacked-1D-conv denoiser and its
dataset helper (port of ``circuitmap_tpu/demix/stacked.py``).

The reference ships this simpler alternative to the U-Net (its
constructor crashes as shipped; this is the working equivalent, as in
the JAX package): long same-padded 1-D convolutions with a ReLU after
each, a single-channel output. ``PSCData`` is the (inputs, targets)
dataset and minibatching helper, host numpy.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


class PSCData:
    """Paired (input, target) PSC traces with shuffled minibatching."""

    def __init__(self, inputs, targets):
        inputs = np.asarray(inputs, dtype=np.float32)
        targets = np.asarray(targets, dtype=np.float32)
        if inputs.shape != targets.shape:
            raise ValueError(f"inputs {inputs.shape} and targets "
                             f"{targets.shape} differ in shape")
        self.inputs = inputs
        self.targets = targets

    def __len__(self):
        return self.inputs.shape[0]

    def __getitem__(self, idx):
        return self.inputs[idx], self.targets[idx]

    def batches(self, batch_size, rng=None):
        """Shuffled minibatches; the final partial batch is yielded too."""
        n = len(self)
        order = (rng or np.random.default_rng()).permutation(n)
        for i0 in range(0, n, batch_size):
            sel = order[i0:i0 + batch_size]
            yield self.inputs[sel], self.targets[sel]


def init_stacked_params(generator, n_layers=3, kernel_size=99,
                        channels=(16, 8, 1), dtype=torch.float32,
                        device="cpu"):
    """Fresh parameters for the stacked conv denoiser, drawn from
    ``generator`` (a ``torch.Generator`` on the CPU): a list of
    ``{"w": [O, I, kernel_size], "b": [O]}``, each uniform in
    +-1/sqrt(I*kernel_size), on ``device``."""
    if n_layers < 2 or channels[-1] != 1:
        raise ValueError("the stacked denoiser needs >= 2 layers and a "
                         "single-channel output")
    params = []
    c_in = 1
    for i in range(n_layers):
        c_out = channels[i]
        bound = 1.0 / np.sqrt(c_in * kernel_size)

        def draw(shape):
            u = torch.rand(shape, generator=generator, dtype=torch.float64)
            return ((2.0 * u - 1.0) * bound).to(device=device, dtype=dtype)

        params.append({"w": draw((c_out, c_in, kernel_size)),
                       "b": draw((c_out,))})
        c_in = c_out
    return params


def stacked_forward(params, x):
    """x: [B, 1, L] -> [B, 1, L]; a ReLU after every convolution."""
    h = x
    for layer in params:
        pad = (layer["w"].shape[-1] - 1) // 2
        h = F.relu(F.conv1d(h, layer["w"], layer["b"], padding=pad))
    return h
