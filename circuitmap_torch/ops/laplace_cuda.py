"""Laplace power-curve refit: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``circuitmap_tpu/ops/laplace_pallas.py::laplace_from_stats_pallas``
(and of the XLA form it replaces, ``solvers/_laplace.py:106-163``). For
each neuron, independently, 10 damped Newton steps on phi = (phi0, phi1)
of the barrier-regularised power-curve objective built from the bucket
statistics S, C [P+1], with a 41-candidate Armijo step (first accepted
0.5^j; NaN candidates rejected; 0.5^40 when none is accepted). Returns
phi and the inverse Hessian of the last direction evaluation (at
phi_9).

Leading batch dimensions (a batch of experiments) flatten into one
launch, the port of the Pallas kernel's custom-vmap rule.

Dispatch: a CPU tensor takes the plain version; a CUDA float32 or
float64 tensor launches ``csrc/laplace.cu`` in that type (float32: any
bucket count, up to 17 held in registers, more read from device memory;
float64: ``cm_laplace_f64``, the runtime count); any other raises. The
kernel computes in double whatever its I/O type (the 2x2 Hessian is
ill-conditioned at closely spaced power levels), so it agrees with the
plain version run in float64 on the same inputs. ``launches`` counts
its launches, ``launches_f64`` those in float64.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._counts import count_launch, reset_launches

NEWTON_STEPS = 10
BARRIER_T = 1e1
ARMIJO_ALPHA = 0.25
BACKTRACK_BETA = 0.5
MAX_BACKTRACK = 40


def _inv2x2(M):
    """Closed-form inverse of [..., 2, 2] (adjugate / determinant)."""
    a, b, c, d = M[..., 0, 0], M[..., 0, 1], M[..., 1, 0], M[..., 1, 1]
    det = a * d - b * c
    adj = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
    return adj / det[..., None, None]


def laplace_from_stats_torch(S, C, levels, phi_prior, phi_cov_prior,
                             t=BARRIER_T):
    """Plain PyTorch version, vectorised over neurons (and any leading
    batch dims). S, C: [..., P+1]; levels: [P+1]; phi_prior: [..., 2];
    phi_cov_prior: [..., 2, 2]. Returns (phi [..., 2], cov [..., 2, 2])."""
    for phi, cov, _ in _newton(S, C, levels, phi_prior, phi_cov_prior, t):
        pass
    return phi, cov


def accepted_steps(S, C, levels, phi_prior, phi_cov_prior):
    """The first accepted Armijo index j (step 0.5^j) of every lane at
    each Newton step of the plain version, [..., NEWTON_STEPS] int64;
    ``MAX_BACKTRACK + 1`` where no candidate was accepted (the step is
    then 0.5^MAX_BACKTRACK). A search that stops at the first acceptance
    evaluates min(j, MAX_BACKTRACK) + 1 candidates."""
    return torch.stack([j for _, _, j in _newton(S, C, levels, phi_prior,
                                                  phi_cov_prior, BARRIER_T)],
                       -1)


def _newton(S, C, levels, phi_prior, phi_cov_prior, t):
    """The plain recursion, one Newton step at a time: yields (phi, cov,
    j) after each step, as ``accepted_steps`` defines j."""
    prec = _inv2x2(phi_cov_prior)
    steps = BACKTRACK_BETA ** torch.arange(MAX_BACKTRACK + 1, dtype=S.dtype,
                                           device=S.device)

    def objective(phi):  # phi [..., 2] or [..., J, 2] -> [...] / [..., J]
        extra = phi.dim() - phi_prior.dim()
        Sx, Cx = S, C
        pp, pr = phi_prior, prec
        for _ in range(extra):
            Sx, Cx = Sx[..., None, :], Cx[..., None, :]
            pp, pr = pp[..., None, :], pr[..., None, :, :]
        x = phi[..., 0:1] * levels - phi[..., 1:2]
        ll = Sx * F.logsigmoid(x) + (Cx - Sx) * F.logsigmoid(-x)
        d = phi - pp
        quad = torch.sum(d * torch.sum(pr * d[..., None, :], -1), -1)
        return (-torch.sum(torch.nan_to_num(ll), -1)
                - torch.sum(torch.log(phi), -1) / t + 0.5 * quad)

    phi = phi_prior
    for _ in range(NEWTON_STEPS):
        f = torch.sigmoid(phi[..., 0:1] * levels - phi[..., 1:2])
        resid = S - C * f
        g = torch.stack([-torch.sum(levels * resid, -1), torch.sum(resid, -1)], -1)
        g = g + torch.sum(prec * (phi - phi_prior)[..., None, :], -1) - 1.0 / (t * phi)
        w = C * f * (1.0 - f)
        h00 = torch.sum(levels * levels * w, -1)
        h01 = -torch.sum(levels * w, -1)
        h11 = torch.sum(w, -1)
        H = torch.stack([torch.stack([h00, h01], -1),
                         torch.stack([h01, h11], -1)], -2)
        H = H + prec + torch.diag_embed(1.0 / (t * phi * phi))
        cov = _inv2x2(H)
        v = -torch.sum(cov * g[..., None, :], -1)
        cand = phi[..., None, :] + steps[:, None] * v[..., None, :]  # [..., J, 2]
        lhs = objective(cand)
        rhs = objective(phi)[..., None] + ARMIJO_ALPHA * steps * torch.sum(
            g * v, -1)[..., None]
        ok = ~torch.isnan(lhs) & (lhs <= rhs)
        first = torch.argmax(ok.to(torch.int8), dim=-1)
        j = torch.where(ok.any(-1), first,
                        torch.full_like(first, MAX_BACKTRACK + 1))
        phi = phi + steps[j.clamp(max=MAX_BACKTRACK)][..., None] * v
        yield phi, cov, j


def laplace_from_stats(S, C, levels, phi_prior, phi_cov_prior):
    """MAP phi and covariance for every neuron from its bucket stats.

    S, C: [..., N, P+1]; levels: [P+1]; phi_prior: [..., N, 2];
    phi_cov_prior: [..., N, 2, 2]. Returns (phi, cov) of the prior
    shapes. CPU tensors take the plain version, CUDA float32 and float64
    tensors the kernel.
    """
    if S.device.type == "cpu":
        return laplace_from_stats_torch(S, C, levels, phi_prior, phi_cov_prior)
    if S.device.type != "cuda":
        raise ValueError(f"no Laplace kernel for device {S.device}")
    return _launch(S, C, levels, phi_prior, phi_cov_prior)


reset_launches(laplace_from_stats)


def _launch(S, C, levels, phi_prior, phi_cov_prior):
    args, phi, cov = _prepare(S, C, levels, phi_prior, phi_cov_prior)
    _enqueue(args)
    count_launch(laplace_from_stats, phi.dtype)
    return phi, cov


def _prepare(S, C, levels, phi_prior, phi_cov_prior):
    """The kernel's arguments for ``_enqueue`` and its outputs (phi,
    cov) in the prior shapes; raises on what the kernel does not take."""
    dt = S.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(
            f"the CUDA Laplace kernel takes float32 or float64, got {dt}")
    P1 = S.shape[-1]
    lead = S.shape[:-1]
    dev = S.device
    Sf = S.reshape(-1, P1).contiguous()
    Cf = torch.as_tensor(C, dtype=dt, device=dev).expand(
        *lead, P1).reshape(-1, P1).contiguous()
    pp, n_pp = _rows(phi_prior, lead, (2,), dt, dev)
    pc, n_pc = _rows(phi_cov_prior, lead, (2, 2), dt, dev)
    lev = torch.as_tensor(levels, dtype=dt, device=dev).contiguous()
    n = Sf.shape[0]
    phi = torch.empty((*lead, 2), dtype=dt, device=dev)
    cov = torch.empty((*lead, 2, 2), dtype=dt, device=dev)
    return (Sf, Cf, lev, pp, pc, phi, cov, n, P1, n_pp, n_pc), phi, cov


def _rows(a, lead, tail, dt, dev):
    """``a`` broadcast to lead + tail, as a contiguous block of its last
    rows [rows, *tail] and their count. The leading dims along which it
    does not vary (stride 0: a prior shared by the experiments of a
    batch) are not copied; the kernel reads lane n at row n mod rows."""
    a = torch.as_tensor(a, dtype=dt, device=dev).expand(
        *lead, *tail)
    k = 0
    while k < len(lead) and a.stride(k) == 0:
        k += 1
    block = a[(0,) * k].reshape(-1, *tail).contiguous()
    return block, block.shape[0]


def _enqueue(args):
    """Launch the kernel on the current stream with ``_prepare``'s
    arguments, uncounted (``laplace_from_stats`` counts its launches)."""
    from . import _build

    lib = _build.library()
    tensors, sizes = args[:7], args[7:]
    entry = (lib.cm_laplace_f64 if tensors[0].dtype == torch.float64
             else lib.cm_laplace_f32)
    err = entry(
        *(t.data_ptr() for t in tensors), *sizes,
        torch.cuda.current_stream(tensors[0].device).cuda_stream)
    _build.check(lib, err, "laplace")
