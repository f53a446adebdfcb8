"""Operations and bytes the algorithm needs, counted from the shapes, and
the card's published peaks.

The byte bound of the blocked sweep (B1, ``csrc/sweep_cluster.cuh``)
and the idea of counting it from the shapes are those of the kernel
table in PERF.md (commit 2a4eea50fb68982d273bbeba2057be11d71ede01): each
input read once, each output written once. The U-Net's layer shapes are
the NWD demixer's (``circuitmap_torch/demix/unet.py`` at that commit),
written out here so that the count cannot move with the program.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense rates (NVIDIA's data sheet, 700 W)
PEAK_F32_FLOPS = 67e12      # float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # HBM3

# (in_ch, out_ch, kernel, dilation) per down block, each after an
# average pool of 3 at stride 2; (in_ch, out_ch, kernel, stride) per up
# block, each a transposed convolution; the output head
DOWN = [(1, 16, 32, 2), (16, 16, 32, 1), (16, 32, 16, 1), (32, 32, 16, 1)]
UP = [(32, 16, 16, 1), (48, 16, 16, 1), (32, 16, 32, 1), (32, 4, 32, 2)]
HEAD = dict(in_ch=4, out_ch=1, kernel=256, padding=255, dilation=2)


def unet_layer_lengths(T):
    """Output lengths of the down blocks' convolutions, and input
    lengths of the up blocks' transposed convolutions, for a T-sample
    trace: the first up block takes the deepest output, each later one
    the previous block's output resized to a skip's length."""
    outs, L = [], T
    for _, _, k, dil in DOWN:
        L = (L - 3) // 2 + 1                  # avg_pool1d(3, stride=2)
        L = L - dil * (k - 1)                 # valid convolution
        outs.append(L)
    return outs, outs[::-1]


def unet_flops(T):
    """Multiply-adds x 2 of the convolutions of one T-sample trace
    (pools, BatchNorm, ReLU and the resizes are not counted)."""
    outs, up_in = unet_layer_lengths(T)
    f = sum(2 * lo * co * ci * k
            for (ci, co, k, _), lo in zip(DOWN, outs))
    f += sum(2 * li * ci * co * k for (ci, co, k, _), li in zip(UP, up_in))
    h = HEAD
    out_len = T + 2 * h["padding"] - h["dilation"] * (h["kernel"] - 1)
    f += 2 * out_len * h["out_ch"] * h["in_ch"] * h["kernel"]
    return f


def caviar_iteration_flops(N, K):
    """One CAVIaR iteration's products: the Gram matrix lam lam^T
    (2 N^2 K), lam y and mu lam (2 N K each, three of them with the
    noise update), the Cholesky factor (N^3 / 3) and the triangular
    inverse (N^3 / 3) with its two matrix-vector products (4 N^2)."""
    return 2 * N * N * K + 3 * 2 * N * K + 2 * N ** 3 // 3 + 4 * N * N


def map_flops(N, K, T, iters, demix=True):
    """A whole map's products: the demix of K traces (when ``demix``)
    and ``iters`` CAVIaR iterations."""
    return (K * unet_flops(T) if demix else 0) + iters * \
        caviar_iteration_flops(N, K)


def sweep_bytes(N, K, P, item=4):
    """B1's least traffic for one sweep of an [N, K] problem: the stim
    and the spike posteriors read once and the new posteriors written
    once ([N, K] each), the charges and the trial mask ([K]), the
    per-neuron weights, variances, power-curve means ([N] each) and
    power counts ([N, P])."""
    return item * (3 * N * K + 2 * K + 4 * N + N * P)


def sweep_bound_s(N, K, P, item=4):
    """The least time of one B1 launch: its bytes at the HBM peak."""
    return sweep_bytes(N, K, P, item) / PEAK_BYTES_PER_S
