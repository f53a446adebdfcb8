"""W1: the weight update's Gram matrix ``lam @ lam.mT`` from the design's
co-stimulation lists, in CUDA (``csrc/gram_costim.cu``).

The spike posterior ``lam`` [N, K] is zero wherever the stim is zero:
CAVIaR's init, its sweeps and its reconnection scan all write it so. So
``G[i, j] = sum_k lam[i, k] lam[j, k]`` has nonzero terms only on the
trials where i and j are both targets, K H^2 of them for H targets a
trial against the dense product's N^2 K. :func:`costim_lists` builds,
once a fit, the lists W1 walks: each neuron's trials and each trial's
targets. :func:`costim_gram` launches W1 over them: a gather of each
target's posterior into a compact list, then the rows; each
``G[i, j]`` takes its products in ascending trial order, one fused
multiply-add each from 0, so G is exactly symmetric and repeats bit for
bit.

:func:`gram` is the dispatch: W1 when it is given the lists, else the
dense product in full float32, which is also W1's plain version. It
counts each Gram by path in ``costim_gram.plans`` (``"costim"`` or
``"dense"``); ``costim_gram.launches`` and ``launches_f64`` count W1's
launches. It replaces no TPU kernel: the JAX package's Gram is one XLA
dot (``circuitmap_tpu/solvers/caviar.py::update_weights``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import highest_matmul
from ._counts import count_launch, count_plan, reset_launches

LANES = 32              # one warp a block
SMEM_BYTES = 48 * 1024  # a block's shared memory, without opting in to more
MAX_TARGETS = 96        # the most targets a trial may hold: a lane stages one
                        # trial's (float64 at 96: 37 of a block's 48 KB)
GATHER = 256            # threads a block of the gather
GATHER_BLOCKS = 132 * 16  # enough to fill the card; the blocks stride on
# The rule (takes_w1): W1's time and the dense product's, fitted on an
# NVIDIA H100 80GB HBM3 (700 W) to chip_smoke.py's phase 3e, which times
# both on 36 designs (even, uneven and skewed; float32 and float64;
# N = 300..2000, K = 20 N), and so picks the faster on each. W1 takes
# W1_FLOOR_S and the longer of two: the busiest row's walk, a latency
# chain of W1_TRIAL_S + W1_TARGET_S * hmax each of its trials (one warp a
# row), and the pairs at W1_PAIR_S each (all rows at once). The dense
# product takes DENSE_FLOOR_S and DENSE_MAC_S a multiply-add of N^2 K.
W1_FLOOR_S = 30e-6
W1_TRIAL_S = 80e-9
W1_TARGET_S = 5e-9
W1_PAIR_S = {torch.float32: 10e-12, torch.float64: 15e-12}
DENSE_FLOOR_S = 20e-6
DENSE_MAC_S = {torch.float32: 4.0e-14, torch.float64: 3.4e-14}


class CostimLists(NamedTuple):
    """A single experiment's co-stimulation lists (int32, on the stim's
    device). The targets in the trials' order: ``targets[trial_ptr[k]:
    trial_ptr[k + 1]]`` are trial k's, ascending, and ``trials[t]`` the
    trial of ``targets[t]``. By neuron: ``row_trials[row_ptr[i]:row_ptr[i
    + 1]]`` are neuron i's trials, ascending, and ``row_pos`` where each
    sits in the trials' order. ``hmax`` is the most targets a trial
    holds."""
    row_ptr: torch.Tensor
    row_trials: torch.Tensor
    row_pos: torch.Tensor
    trial_ptr: torch.Tensor
    targets: torch.Tensor
    trials: torch.Tensor
    hmax: int


class GramPlan(NamedTuple):
    """W1's launch layout (:func:`plan`)."""
    stride: int         # a lane's staging slots: odd, at least hmax
    width: int          # columns a block
    chunks: int         # blocks a row
    smem: int           # shared memory bytes a block
    gather_blocks: int  # blocks of the gather


def takes_w1(N, K, hmax, row_trials, pairs, dtype):
    """Whether the Gram of an [N, K] design in ``dtype`` runs as W1: its
    densest trial holds ``hmax`` targets, at most ``MAX_TARGETS``; its
    busiest neuron takes ``row_trials`` trials; its ``pairs`` (the sum
    over trials of their targets squared) are few enough that W1's time
    comes under the dense product's (the fitted times above)."""
    if hmax > MAX_TARGETS or dtype not in W1_PAIR_S:
        return False
    w1 = W1_FLOOR_S + max(row_trials * (W1_TRIAL_S + W1_TARGET_S * hmax),
                          pairs * W1_PAIR_S[dtype])
    return w1 <= DENSE_FLOOR_S + DENSE_MAC_S[dtype] * N * N * K


def costim_lists(stim, always=False):
    """The co-stimulation lists of a single experiment's [N, K] stim (a
    target is a row where ``stim != 0``), with which its Gram runs as W1;
    None where the dense product runs: a stim with no element, or a
    design :func:`takes_w1` turns down (unless ``always``). Built on the
    stim's device with one host read, of the most targets a trial holds,
    the most trials a neuron takes, the number of targets and the
    pairs."""
    if stim.numel() == 0:
        return None
    hit = stim != 0
    per_trial, per_row = hit.sum(0), hit.sum(1)
    hmax, row_trials, nnz, pairs = torch.stack([
        per_trial.max(), per_row.max(), per_trial.sum(),
        (per_trial * per_trial).sum()]).tolist()
    if not always and not takes_w1(*stim.shape, hmax, row_trials, pairs,
                                   stim.dtype):
        return None
    # (trial, neuron) of every target, ascending by trial, then by neuron;
    # sized by the read above, so no second one
    where = torch.nonzero_static(hit.T, size=nnz)
    trials, neurons = where[:, 0], where[:, 1]
    by_neuron = torch.argsort(neurons, stable=True)  # keeps trials ascending
    zero = per_trial.new_zeros(1)
    i32 = torch.int32
    return CostimLists(
        torch.cat([zero, torch.cumsum(per_row, 0)]).to(i32),
        trials[by_neuron].to(i32), by_neuron.to(i32),
        torch.cat([zero, torch.cumsum(per_trial, 0)]).to(i32),
        neurons.to(i32), trials.to(i32), int(hmax))


def plan(N, nnz, hmax, itemsize):
    """W1's :class:`GramPlan` for N neurons, ``nnz`` targets, at most
    ``hmax`` a trial: a block of the rows holds its columns of the row
    and each lane's staged posteriors and their columns within
    ``SMEM_BYTES``; the gather takes a thread a target, up to
    ``GATHER_BLOCKS`` blocks."""
    if not 0 <= hmax <= MAX_TARGETS:
        raise ValueError(f"costim_gram takes trials of at most {MAX_TARGETS} "
                         f"targets, got {hmax}")
    stride = hmax | 1  # odd: the lanes' staging stores fall in 32 banks
    stage = LANES * stride * (itemsize + 4)
    width = max(1, min(N, (SMEM_BYTES - stage) // itemsize))
    return GramPlan(stride, width, -(-N // width), width * itemsize + stage,
                    max(1, min(GATHER_BLOCKS, -(-nnz // GATHER))))


def gram(lam, lists=None):
    """``lam @ lam.mT`` ([..., N, N]) in full float32: W1 over ``lists``
    (:func:`costim_lists` of the stim ``lam`` belongs to) when given,
    else the dense product."""
    if lists is None:
        count_plan(costim_gram, "dense")
        with highest_matmul():
            return lam @ lam.mT
    return costim_gram(lam, lists)


def costim_gram(lam, lists):
    """W1: ``lam @ lam.mT`` of an [N, K] CUDA float32 or float64 ``lam``
    that is zero wherever its stim is, from that stim's
    :class:`CostimLists`: the gather and the rows, two launches on the
    current stream of ``lam``'s device. Returns the [N, N] Gram, written
    whole."""
    if lam.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"costim_gram takes float32 or float64, got "
                        f"{lam.dtype}")
    if lam.device.type != "cuda":
        raise ValueError(f"no costim_gram kernel for device {lam.device}")
    N, K = lam.shape
    if (lists.row_ptr.shape != (N + 1,) or lists.trial_ptr.shape != (K + 1,)
            or any(t.dtype != torch.int32 or t.device != lam.device
                   or not t.is_contiguous() for t in lists[:6])):
        raise ValueError(
            f"costim_gram: lists of an [{N}, {K}] stim on {lam.device} "
            "(contiguous int32) are needed")
    lam = lam.contiguous()
    nnz = lists.targets.numel()
    vals = torch.empty(nnz, dtype=lam.dtype, device=lam.device)
    G = torch.empty((N, N), dtype=lam.dtype, device=lam.device)
    p = plan(N, nnz, lists.hmax, lam.element_size())
    _enqueue(lam, lists, vals, G,
             (N, K, nnz, p.stride, p.width, p.gather_blocks))
    count_launch(costim_gram, lam.dtype)
    count_plan(costim_gram, "costim")
    return G


reset_launches(costim_gram)


def _enqueue(lam, lists, vals, G, sizes):
    """Launch the gather and the rows on the current stream of ``lam``'s
    device, uncounted (``costim_gram`` counts its launches)."""
    from . import _build

    lib = _build.library()
    entry = (lib.cm_costim_gram_f64 if lam.dtype == torch.float64
             else lib.cm_costim_gram_f32)
    with torch.cuda.device(lam.device):
        err = entry(lam.data_ptr(), *(t.data_ptr() for t in lists[:6]),
                    vals.data_ptr(), G.data_ptr(), *sizes,
                    torch.cuda.current_stream(lam.device).cuda_stream)
    _build.check(lib, err, "costim_gram")
