"""Persistent fit server for the port: one process owns the GPU, fits
arrive over HTTP. ``python -m circuitmap_torch serve`` /
``serve.FitClient``.

The server speaks the wire of ``circuitmap_tpu/serve.py`` byte for byte
(the codecs below are the port's copies of that module's), so the JAX
package's ``FitClient`` drives this server unchanged and this module's
``FitClient`` drives the JAX package's server.

Why a resident process:

* **One process owns the card.** Rigs, notebooks and batch scripts
  talk to one warm server instead of each starting its own process,
  and requests run one at a time on the serving thread.
* **Warm state is process-local.** A fresh process builds (or loads)
  the CUDA kernels (``ops/_build.py``), creates the cuBLAS and cuSOLVER
  handles and grows the allocator's pools; the server pays that once,
  and ``/warm`` pays it before the first real request.
* **Closed-loop latency.** ``OnlineCaviar`` streams live in the server
  between requests with their capacity buffers on the device, so a
  posterior refresh mid-experiment is one small block upload and a few
  CAVI iterations.

Protocol (stdlib-only on both ends — the rig-side client needs numpy
and nothing else):

* request/response bodies are ``.npz`` bytes (``np.savez``); control
  responses are JSON;
* the client compresses the design by default (column-sparse stim in an
  exact sparse-hologram form) and ``psc_wire='f16'/'int8'/'int4'/
  'int4d2'`` optionally types or quantises the traces; an int4 body is
  handed to the device as its codes (``PackedInt4Traces``) and never
  decoded to dense on the host;
* scalar/structured options ride the ``X-Options`` header as JSON;
* the server is single-threaded by design: every device operation runs
  on the serving thread.

Endpoints
---------
``GET  /health``                  → JSON (device, uptime, counters)
``POST /demix``                   npz{psc} → npz{demixed}
``POST /fit``                     npz{psc, stim} → npz{mu, beta, ...}
``POST /fit_many``                npz{pscs, stims} → npz stacked [B, ...]
``POST /warm``                    X-Options {"shapes": [[N, K], ...]}
``POST /profile``                 X-Options {"action": "start" | "stop"}
``POST /stream/<name>/update``    npz{psc, stim} → JSON counters
``GET  /stream/<name>/posterior`` → npz small fields
``GET  /stream/<name>/result``    → npz full posterior
``POST /stream/<name>/design``    → npz{stim, pool, resolved, rounds}
``POST /stream/<name>/save``      → JSON (needs --state-dir)
``POST /stream/<name>/load``      → JSON (restores stream + designer)
``DELETE /stream/<name>``         → JSON
``POST /shutdown``                → JSON (graceful stop; auto-saves
                                    live streams under --state-dir)

Operations: ``--status-port`` runs a read-only liveness sidecar on its
own thread and port (``GET /health`` → ``status_payload()``, never
touches torch or the device) so probes keep working while the main port
is busy; ``--request-timeout-s`` arms a watchdog that turns a request
stuck past that bound into exit code 86 (a supervisor restart) after a
bounded stream auto-save. ``--mesh N > 0`` shards every fit over a
trial mesh of N shards (``parallel.trial_mesh``): the first N visible
GPUs, or N shards on ``--device`` when one is named (a card, or the
CPU). Batch fits then run the trial-sharded solvers, ``/fit_many`` the
experiment-sharded ones, streams ``OnlineCaviar(mesh=)``, and the
demixer splits its rows over the mesh when ``mesh_compatible`` allows;
a request opts out with ``{"sharded": false}``.
"""

from __future__ import annotations

import io
import json
import time

import numpy as np

from .utils.profiling import Metrics, span

DEFAULT_PORT = 8799
# process exit code when --request-timeout-s fires: distinct from
# crash codes so a supervisor (systemd Restart=always, runit, a shell
# loop) can tell "watchdog killed a wedged daemon" from "bug".
WATCHDOG_EXIT_CODE = 86

# fit_options the HTTP layer accepts for POST /fit. Everything here is
# a JSON-safe scalar/list knob of the batch solvers; mesh= and
# callback-like options deliberately have no wire form.
_FIT_OPTION_KEYS = frozenset((
    "iters", "msrmp", "powers", "seed", "num_mc_samples",
    "minimum_spike_count", "delay_spont_est", "scale_factor", "penalty",
    "max_backtrack_iters", "tol", "spont_orthogonality", "analytic_mc",
    "save_histories", "sweep_impl", "sweep_block_size", "laplace_impl",
    "update_order", "track_elbo", "elbo_tol", "y_xcorr_thresh",
    "fn_scan", "trace_wire", "verbose", "k",
))

# batched-solver knobs for POST /fit_many (solvers/batched.py —
# JSON-safe only; mesh= comes from the server's --mesh, opt out per
# request with {"sharded": false}). The union across methods: each *_many
# signature rejects knobs foreign to the chosen method (400).
_FIT_MANY_OPTION_KEYS = frozenset((
    "method",
    "iters", "msrmp", "powers", "seeds", "num_mc_samples",
    "y_xcorr_thresh", "minimum_spike_count", "delay_spont_est",
    "scale_factor", "penalty", "max_backtrack_iters", "tol",
    "spont_orthogonality", "fn_scan", "analytic_mc", "sweep_block_size",
    "laplace_impl", "compile_mode", "trace_wire", "verbose",
    "demix", "sharded",
    # cavi_sns / mbcs extras
    "analytic_noise", "learn_lam", "constrain_weights", "noise_scale",
    "num_mc_samples_noise_model", "outlier_penalty", "init_spike_prior",
    "outlier_tol", "spont_rate", "lam_mask_fraction",
    "delay_spont_estimation", "minimum_maximal_spike_prob",
    "orthogonal_outliers", "max_penalty_iters", "max_lasso_iters",
    # response-wire levers (serve-level, not solver knobs)
    "return_fields", "wire_meta",
))

# OnlineCaviar constructor knobs creatable over the wire (subset of
# solvers/online.py::OnlineCaviar.__init__ — JSON-safe only).
_STREAM_CREATE_KEYS = frozenset((
    "powers", "seed", "capacity", "y_xcorr_thresh", "msrmp",
    "num_mc_samples", "minimum_spike_count", "delay_spont_est",
    "scale_factor", "penalty", "max_backtrack_iters", "tol",
    "spont_orthogonality", "analytic_mc", "sweep_impl",
    "sweep_block_size", "laplace_impl", "update_order",
))

# AdaptiveDesigner knobs for /stream/<name>/design (design.py).
_DESIGNER_KEYS = frozenset((
    "N", "H", "powers", "null_trials", "conn_trials",
))

# each experiment endpoint's body form: (traces key, design key or None,
# the 400 when a key is missing) — FitService._decode_experiment
_BODY_FORMS = {
    "fit": ("psc", "stim",
            "npz must carry 'psc' [K, T|1] and 'stim' [N, K]"),
    "stream": ("psc", "stim",
               "npz must carry 'psc' [k, T] and 'stim' [N, k]"),
    "demix": ("psc", None, "npz must carry 'psc' [K, T]"),
    "stacked": ("pscs", "stims",
                "npz must carry 'pscs' [B, K, T|1] and 'stims' [B, N, K]"),
    "ragged": ("psc", "stim",
               "ragged fit_many bodies carry 'psc' [sum_K, T] (or a "
               "quantised psc_* wire) + 'stim' [N, sum_K] + 'k_trues'"),
}


def _npz_bytes(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()
                     if v is not None})
    return buf.getvalue()


# response fields that ride along regardless of a return_fields filter:
# scalars/metadata the client-side protocol needs to interpret the body
_ALWAYS_FIELDS = frozenset(("fit_time_s", "k_trues", "_k_fields",
                            "_shape_fields"))


def _filter_fields(out, fields, what="fit"):
    """Apply a ``return_fields`` response filter to a result dict.

    The posterior is dominated by [N, K]-sized fields (``lam`` alone is
    80 MB f32 at N=1000/K=20000); callers that only need the [N]-sized
    summaries (``mu``/``beta``/``alpha``) cut the response ~2000×. A
    requested name absent from the results is a client error (a typo
    silently dropping 'mu' would be worse than a 400)."""
    if fields is None:
        return out
    if isinstance(fields, str):
        fields = [fields]
    if (not isinstance(fields, (list, tuple))
            or not all(isinstance(f, str) for f in fields)):
        raise _BadRequest("return_fields must be a list of field names")
    missing = [f for f in fields if f not in out]
    if missing:
        raise _BadRequest(
            f"return_fields {missing} not produced by this {what}; "
            f"available: {sorted(k for k in out if k not in _ALWAYS_FIELDS)}")
    keep = set(fields) | _ALWAYS_FIELDS
    return {k: v for k, v in out.items() if k in keep}


# ceiling on what a sparse-stim body may reconstruct to — a
# few-hundred-byte crafted body must not allocate the daemon to death
_MAX_SPARSE_DENSE_BYTES = 16 << 30


def _load_npz(body):
    try:
        with np.load(io.BytesIO(body), allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    except Exception as exc:
        raise _BadRequest(f"body is not a readable .npz: {exc}") from None


# ------------------------------------------------- HTTP wire encodings
#
# np.savez does not compress, so a naive POST /fit body at N=1000,
# K=20000 is 232 MB — and 160 MB of that is the f64 stim matrix, which
# is >90% zeros. Mapping designs are column-sparse (each trial
# stimulates at most H of N neurons at one of a few power levels), so
# the client ships the same sparse-hologram form the device upload
# already uses (solvers/_common._sparsify): [H, K] target indices +
# [H, K] level codes + the level table (~0.8 MB at that shape). The
# encoding is EXACT — levels keep the input dtype and codes index them
# — so a sparse-shipped fit is bit-identical to a dense-shipped one.
# Traces can optionally ship as int8 codes with the demixer wire's
# per-trace peak/127 scale; the per-row max code is exactly 127, so the
# server-side dequantise → device-side int8 requantise round-trips
# bit-exactly.


def encode_stim_sparse(stim, max_ratio=0.25):
    """Sparse-hologram npz arrays for a [N, K] design, or ``None``
    when the dense matrix ships fewer than 1/``max_ratio``× the bytes
    (dense also wins on decode cost for near-dense designs)."""
    stim = np.asarray(stim)
    if stim.ndim != 2:
        return None
    N, K = stim.shape
    if N > 32766 or K == 0:  # int16 target space
        return None
    mask = stim != 0
    nz_k, nz_n = np.nonzero(mask.T)  # transposed: sorted by trial
    counts = np.bincount(nz_k, minlength=K)
    H = int(counts.max()) if nz_k.size else 0
    vals = stim.T[nz_k, nz_n]
    levels, code_flat = np.unique(vals, return_inverse=True)
    if levels.size > 65535:  # uint16 code space
        return None
    code_dtype = np.uint8 if levels.size <= 255 else np.uint16
    sparse_bytes = H * K * (2 + np.dtype(code_dtype).itemsize)
    if sparse_bytes + levels.nbytes >= stim.nbytes * max_ratio:
        return None
    offsets = np.concatenate([[0], np.cumsum(counts)])
    slots = np.arange(nz_k.size) - offsets[nz_k]
    targets = np.full((H, K), -1, dtype=np.int16)
    codes = np.zeros((H, K), dtype=code_dtype)
    targets[slots, nz_k] = nz_n.astype(np.int16)
    codes[slots, nz_k] = code_flat.reshape(-1).astype(code_dtype)
    return {"stim_sparse_targets": targets, "stim_sparse_codes": codes,
            "stim_sparse_levels": levels, "stim_sparse_n": np.int32(N)}


def _decode_stim_sparse(targets, codes, levels, n_neurons):
    """Exact dense [N, K] reconstruction of ``encode_stim_sparse``."""
    targets, codes = np.asarray(targets), np.asarray(codes)
    levels = np.asarray(levels)
    if (targets.ndim != 2 or codes.shape != targets.shape
            or levels.ndim != 1):
        raise _BadRequest(
            "malformed sparse stim: targets/codes must be matching "
            "[H, K] arrays and levels 1-D")
    # the level table is the ONLY value source of the reconstruction:
    # validating it finite here (a few entries) is what lets the fit
    # endpoints skip the dense [N, K] isfinite pass for sparse bodies
    if (not np.issubdtype(levels.dtype, np.number)
            or not np.isfinite(levels).all()):
        raise _BadRequest("sparse stim levels must be finite numbers")
    try:
        n = int(np.asarray(n_neurons).reshape(()))
    except (TypeError, ValueError):
        raise _BadRequest("stim_sparse_n must be a scalar neuron count")
    if not 0 < n <= 32766:  # the encoder's own int16 target-space cap
        raise _BadRequest(
            f"stim_sparse_n={n} outside (0, 32766] — not a value "
            "encode_stim_sparse produces")
    if (n * targets.shape[1] * max(levels.dtype.itemsize, 1)
            > _MAX_SPARSE_DENSE_BYTES):
        # a few-hundred-byte body must not be able to allocate an
        # arbitrarily large dense matrix in the daemon. The bound is
        # generous (16 GB ≈ a B=100 flagship-shape f64 fit_many batch —
        # far past what one card fits anyway); legitimate larger
        # workloads should split the batch or cast the design to f32
        raise _BadRequest(
            f"sparse stim reconstructs to a {n} x {targets.shape[1]} "
            f"dense matrix (> {_MAX_SPARSE_DENSE_BYTES >> 30} GB) — "
            "split the batch or ship an f32 design")
    h, k = np.nonzero(targets >= 0)
    t = targets[h, k].astype(np.int64)
    c = codes[h, k].astype(np.int64)
    if t.size and int(t.max()) >= n:
        raise _BadRequest(
            f"sparse stim target {int(t.max())} out of range for "
            f"N={n} neurons")
    if c.size and (int(c.min()) < 0 or int(c.max()) >= levels.size):
        # negative codes would wrap-index the level table silently
        raise _BadRequest(
            f"sparse stim code(s) out of range for {levels.size} levels")
    stim = np.zeros((n, targets.shape[1]), dtype=levels.dtype)
    stim[t, k] = levels[c]
    return stim


def encode_psc_int8(psc):
    """Per-trace peak/127 int8 codes + f32 scales for a [..., K, T]
    block (the scale axis is the last one — one scale per trace).
    Shares the one quantiser with the demixer/solver device wires
    (utils/quant.py — that is what makes requantisation the identity)."""
    from .utils.quant import quantise_int8

    psc = np.asarray(psc)
    if psc.ndim < 2:
        raise ValueError(f"psc must be [..., K, T], got shape {psc.shape}")
    codes, scale = quantise_int8(psc.reshape(-1, psc.shape[-1]))
    return {"psc_q8": codes.reshape(psc.shape),
            "psc_q8_scale": scale.reshape(psc.shape[:-1])}


def encode_psc_int4(psc, decimate=1):
    """Nibble-packed int4 codes + per-trace peak/7 f32 scales for a
    [..., K, T] block (utils/quant.quantise_pack_int4 — the same pack
    the device wire and the QAT train-time transform use, so the
    server-side dequantise → device int4 requantise is the identity).
    ``decimate=2`` is the int4d2 wire: antialias mean-pool by 2 before
    quantising (demix.demixer.wire_transform(decimate=2) exactly — pair
    the fit with a *_int4d2qat.npz server demixer), halving the body
    again."""
    from .utils.quant import encode_int4_traces

    psc = np.asarray(psc)
    if psc.ndim < 2:
        raise ValueError(f"psc must be [..., K, T], got shape {psc.shape}")
    t = psc.shape[-1]
    packed, scale = encode_int4_traces(psc.reshape(-1, t),
                                       decimate=decimate)
    out = {"psc_q4": packed, "psc_q4_scale": scale,
           "psc_q4_t": np.int64(t),
           "psc_q4_lead": np.asarray(psc.shape[:-1], np.int64)}
    if decimate != 1:
        # key omitted for decimate=1: older servers reject unknown keys
        out["psc_q4_dec"] = np.int64(decimate)
    return out


def _encode_psc(psc, wire):
    """Client-side trace typing: None keeps the caller's dtype; 'f32'/
    'f16' cast; 'int8'/'int4'/'int4d2' quantise (``encode_psc_int8`` /
    ``encode_psc_int4``)."""
    if wire is None:
        return {"psc": np.asarray(psc)}
    if wire == "int8":
        return encode_psc_int8(psc)
    if wire == "int4":
        return encode_psc_int4(psc)
    if wire == "int4d2":
        return encode_psc_int4(psc, decimate=2)
    if wire in ("f16", "f32"):
        return {"psc": np.asarray(psc).astype(
            np.float16 if wire == "f16" else np.float32)}
    raise ValueError(
        f"unknown psc_wire {wire!r}; expected 'f32' | 'f16' | 'int8' | "
        "'int4' | 'int4d2' (this types the HTTP body; `trace_wire` in "
        "the options types the server's host->device upload)")


def _decode_arrays(arrays):
    """Reverse the FitClient wire encodings on a request body."""
    for dense_key in ("stim", "stims"):
        # batched designs (/fit_many): [B, N, K] shipped as one sparse
        # [N, B*K] matrix (trial columns concatenated across experiments
        # preserve column-sparsity) plus the experiment count ``_b``
        stacked = dense_key == "stims"
        wire = [f"{dense_key}_sparse_{part}" for part in
                ("targets", "codes", "levels", "n") + ("b",) * stacked]
        if wire[0] not in arrays:
            continue
        missing = set(wire) - set(arrays)
        if missing:
            raise _BadRequest(
                f"sparse {dense_key} missing key(s) {sorted(missing)}")
        if dense_key in arrays:
            raise _BadRequest(
                f"body carries both dense and sparse {dense_key}")
        dense = _decode_stim_sparse(*(arrays.pop(k) for k in wire[:4]))
        if stacked:
            b = int(np.asarray(arrays.pop(wire[4])).reshape(()))
            if b <= 0 or dense.shape[1] % b:
                raise _BadRequest(
                    f"stims_sparse_b={b} does not divide the "
                    f"{dense.shape[1]} shipped trial columns")
            dense = np.ascontiguousarray(
                dense.reshape(dense.shape[0], b, -1).transpose(1, 0, 2))
        arrays[dense_key] = dense
    for dense_key in ("psc", "pscs"):
        qk = f"{dense_key}_q4"
        if qk not in arrays:
            continue
        from .utils.quant import PackedInt4Traces, decode_int4_traces

        missing = {f"{qk}_scale", f"{qk}_t", f"{qk}_lead"} - set(arrays)
        if missing:
            raise _BadRequest(f"{qk} missing key(s) {sorted(missing)}")
        if dense_key in arrays:
            raise _BadRequest(
                f"body carries both raw and int4 {dense_key}")
        packed = np.asarray(arrays.pop(qk))
        scale = np.asarray(arrays.pop(f"{qk}_scale"), dtype=np.float32)
        try:
            t = int(np.asarray(arrays.pop(f"{qk}_t")).reshape(()))
        except (TypeError, ValueError):
            raise _BadRequest(f"{qk}_t must be a scalar sample count")
        try:
            dec = int(np.asarray(arrays.pop(f"{qk}_dec", 1)).reshape(()))
        except (TypeError, ValueError):
            raise _BadRequest(f"{qk}_dec must be the scalar 1 or 2")
        if dec not in (1, 2):
            raise _BadRequest(f"{qk}_dec must be 1 or 2, got {dec}")
        lead = tuple(int(x) for x in
                     np.asarray(arrays.pop(f"{qk}_lead")).ravel())
        if (packed.ndim != 2 or packed.dtype != np.uint8
                or scale.shape != (packed.shape[0],)):
            raise _BadRequest(
                f"{qk} must be uint8 [rows, ceil(T'/2)] with "
                f"{qk}_scale [rows]")
        t2 = (t + 1) // 2 if dec == 2 else t
        if not 0 < t2 <= 2 * packed.shape[1]:
            raise _BadRequest(
                f"{qk}_t={t} (dec={dec}) inconsistent with "
                f"{packed.shape[1]} packed bytes per row")
        if not lead or any(d <= 0 for d in lead) or int(
                np.prod(lead, dtype=np.int64)) != packed.shape[0]:
            # the encoder always emits >= 1 lead dim; an empty lead
            # would reconstruct a 1-D psc that escapes the [..., K, T]
            # contract downstream
            raise _BadRequest(
                f"{qk}_lead={list(lead)} does not match "
                f"{packed.shape[0]} packed rows")
        if not (np.isfinite(scale).all() and (scale > 0).all()):
            raise _BadRequest(f"{qk}_scale must be finite and positive")
        if packed.shape[1] == (t2 + 1) // 2:
            # keep the wire form: trace consumers that understand it
            # (the demixer upload, the solver trace wire, the *_many
            # flattened batch upload) ship these codes to the device
            # without any host recode (requantise identity);
            # everything else densifies via __array__
            arrays[dense_key] = PackedInt4Traces(packed, scale, t, dec,
                                                 lead=lead)
        else:
            flat = decode_int4_traces(packed, scale, t, dec)
            arrays[dense_key] = flat.reshape(*lead, t)
    for dense_key, qk, sk in (("psc", "psc_q8", "psc_q8_scale"),
                              ("pscs", "pscs_q8", "pscs_q8_scale")):
        if qk not in arrays:
            continue
        if sk not in arrays:
            raise _BadRequest(f"{qk} without {sk}")
        if dense_key in arrays:
            raise _BadRequest(
                f"body carries both raw and int8 {dense_key}")
        codes = np.asarray(arrays.pop(qk))
        scale = np.asarray(arrays.pop(sk), dtype=np.float32)
        if codes.ndim < 2 or scale.shape != codes.shape[:-1]:
            raise _BadRequest(
                f"{qk} must be [..., K, T] with {sk} [..., K]")
        if not (np.isfinite(scale).all() and (scale > 0).all()):
            # the encoder guarantees finite positive scales; NaN or
            # negative values would flow silently into the fit
            raise _BadRequest(f"{sk} must be finite and positive")
        arrays[dense_key] = codes.astype(np.float32) * scale[..., None]
    return arrays


def _require_finite(name, arr):
    """Reject NaN/inf in decoded dense wire bodies with a 400.

    Real rig exports carry NaN channels and saturated-inf samples
    (utils/io handles the file-loading side); a wire body that smuggles
    them past the client would otherwise fit to silently-NaN posteriors
    on the server. Quantised wire containers (PackedInt4Traces) skip
    the scan — their codes are finite by construction and their scales
    are validated at decode. A non-numeric dtype (np.savez round-trips
    string arrays without pickle!) is equally a client error — it must
    400 here, not TypeError into a 500."""
    if not isinstance(arr, np.ndarray):
        return
    if not np.issubdtype(arr.dtype, np.number):
        raise _BadRequest(
            f"{name} must be a numeric array, got dtype {arr.dtype}")
    if not np.isfinite(arr).all():
        bad = int((~np.isfinite(arr)).sum())
        raise _BadRequest(
            f"{name} contains {bad} non-finite (NaN/inf) values — "
            "clean the recording first (utils/io.load_experiment's "
            "on_nonfinite='drop'/'zero' names the repair options)")


def _normalize_return_fields(value):
    """Validate/normalise a return_fields option BEFORE any fit runs:
    it also gates Model's device→host pulls (fit(_materialize=)), and
    a malformed value must 400 up front — not after a B-experiment
    batch has already run, and not surfaced as a solver-rejection
    message."""
    if value is None:
        return None
    if isinstance(value, str):
        value = [value]
    if (not isinstance(value, list)
            or not all(isinstance(f, str) for f in value)):
        raise _BadRequest("return_fields must be a list of field names")
    return value


class _BadRequest(ValueError):
    """Client error → HTTP 400 with the message."""


class _Unauthorized(Exception):
    """Missing/wrong bearer token → HTTP 401."""


class FitService:
    """The server's state + request logic, HTTP-free (unit-testable).

    Every public ``do_*`` method returns ``(content_type, payload_bytes)``
    and raises ``_BadRequest`` for client errors. ``device=None`` means
    CUDA (the package's device rule: without a GPU it raises unless
    given ``device="cpu"``).
    """

    verbose = False
    max_body_bytes = 2 << 30
    metrics_fh = None  # open file: one JSON line per request (--metrics)
    auth_token = None  # require `Authorization: Bearer <token>` (--token)

    def __init__(self, demixer_path=None, default_wire=None, priors=None,
                 mesh_devices=0, state_dir=None, device=None):
        import torch

        from ._device import resolve_device

        self._t0 = time.time()
        self.torch_device = resolve_device(device)
        # mesh_devices > 0: batch fits dispatch the trial-sharded
        # solvers over the mesh (per-request opt-out: {"sharded": false})
        # and streams run OnlineCaviar(mesh=)
        self.mesh = None
        if mesh_devices:
            from .parallel import trial_mesh

            self.mesh = (trial_mesh(int(mesh_devices)) if device is None
                         else trial_mesh(devices=[self.torch_device]
                                         * int(mesh_devices)))
        # plain strings, cached here: the status sidecar reads them
        # without touching torch
        if self.torch_device.type == "cuda":
            self.device = torch.cuda.get_device_name(self.torch_device)
            self.platform = "gpu"
        else:
            self.device = str(self.torch_device)
            self.platform = self.torch_device.type
        self.default_wire = default_wire
        self.priors = priors
        self.demixer = None
        self.demixer_path = demixer_path
        if demixer_path:
            from .demix.demixer import NeuralDemixer

            self.demixer = (NeuralDemixer(seed=0, device=self.torch_device)
                            if demixer_path == "default"
                            else NeuralDemixer(path=demixer_path,
                                               device=self.torch_device))
        self.state_dir = state_dir
        if state_dir:
            import os

            os.makedirs(state_dir, exist_ok=True)
        self.streams = {}
        self.designers = {}  # stream name -> AdaptiveDesigner
        self.n_fits = 0
        self.n_demixes = 0
        self._profile_dir = None  # active torch.profiler trace dir
        self._profiler = None
        # (method, path, monotonic start) while a request is being
        # served on the main thread; None when idle. Written by the
        # request handler, read by the status sidecar and the watchdog
        # (single reference assignment — safe under the GIL).
        self.inflight = None

    # -- helpers -----------------------------------------------------------

    def _parse_options(self, header_value, allowed, what):
        if not header_value:
            return {}
        try:
            opts = json.loads(header_value)
        except json.JSONDecodeError as exc:
            raise _BadRequest(f"X-Options is not valid JSON: {exc}")
        if not isinstance(opts, dict):
            raise _BadRequest("X-Options must be a JSON object")
        unknown = set(opts) - allowed
        if unknown:
            raise _BadRequest(
                f"unknown {what} option(s) {sorted(unknown)}; "
                f"allowed: {sorted(allowed)}")
        return opts

    def _wire_token(self, opts):
        """Demixer transfer dtype from options/default ('f16'/'int8'/
        'int4'/'int4d2' tokens; None = f32)."""
        from .demix.demixer import resolve_transfer_dtype

        tok = opts.pop("trace_wire", self.default_wire)
        try:
            return resolve_transfer_dtype(tok)
        except ValueError as exc:
            raise _BadRequest(str(exc)) from None

    def _require_demixer(self):
        if self.demixer is None:
            raise _BadRequest(
                "demix requested but the server was started without a "
                "demixer (pass --demixer to `circuitmap_torch serve`)")

    def _maybe_demix(self, traces, opts, stages):
        """Demix on request (`demix` option; default: iff the server
        was started with a demixer). The output stays on the device and
        feeds the solver directly. When demixing, ``trace_wire``
        configures the demixer's host→device upload; when not, the
        option is left in ``opts`` for the solver's raw-trace wire."""
        if not opts.pop("demix", self.demixer is not None):
            return traces
        wire = self._wire_token(opts)
        self._require_demixer()
        # a --mesh server demixes sharded too (rows split over the
        # mesh), but only for a request whose resolved options carry the
        # mesh: a {"sharded": false} opt-out or a cosamp fit runs the
        # single-device solver
        return self._demix(traces, wire, stages, keep_on_device=True,
                           mesh=self._demix_mesh(opts))

    def _demix(self, traces, wire, stages, **kw):
        """The demixer on [..., K, T] traces, dense or
        ``PackedInt4Traces``: leading dims flatten into one call's rows
        and are restored on its output. ``stages``: the request's
        ``Metrics``, which gets the ``cm.serve.demix`` span."""
        from .utils.quant import PackedInt4Traces

        lead = traces.shape[:-2]
        if lead:
            traces = (traces.flat() if isinstance(traces, PackedInt4Traces)
                      else np.asarray(traces).reshape(-1, traces.shape[-1]))
        self.n_demixes += 1
        with span("cm.serve.demix", stages):
            out = self.demixer(traces, verbose=False, transfer_dtype=wire,
                               **kw)
        return out.reshape(*lead, -1, out.shape[-1]) if lead else out

    @staticmethod
    def _demix_mesh(opts):
        """The mesh the demixer may shard over for this request: the
        request's resolved solver mesh (``opts['mesh']``), and only when
        the demixer says it can shard over it
        (``demix.demixer.mesh_compatible``)."""
        from .demix.demixer import mesh_compatible

        mesh = opts.get("mesh")
        return mesh if mesh_compatible(mesh) else None

    def _resolve_mesh(self, opts, what, method=None, ragged=False):
        """Parse the request's ``sharded`` option and set
        ``opts["mesh"]`` where the fit runs on the server's mesh: on a
        --mesh server unless the request opts out with
        ``{"sharded": false}``, and never for a fit with no sharded path
        — cosamp (a host-side greedy baseline) or a ragged sns/mbcs
        batch (per-experiment sequential fits). An explicit
        ``{"sharded": true}`` the server cannot honour is a 400.
        ``method``: the /fit method, or a ragged /fit_many's."""
        sharded = opts.pop("sharded", None)
        if sharded is not None:
            sharded = bool(sharded)  # JSON 0/1 behave like false/true
        sequential = ragged and method != "caviar"
        if sharded:
            if sequential:
                raise _BadRequest(
                    f"ragged fit_many with method={method!r} runs "
                    "per-experiment sequential fits (no traced-k_true "
                    "program to shard) — drop 'sharded', or use "
                    "method='caviar'")
            if self.mesh is None:
                raise _BadRequest(f"sharded {what} requested but the "
                                  "server has no mesh (start it with "
                                  "--mesh N)")
            if method == "cosamp":
                raise _BadRequest("cosamp has no sharded path (it is a "
                                  "host-side greedy baseline) — drop "
                                  "sharded or pick another method")
        if (self.mesh is not None and sharded is not False
                and method != "cosamp" and not sequential):
            opts["mesh"] = self.mesh

    def _decode_experiment(self, body, stages, form):
        """The traces, design and ragged trial counts of an experiment
        request's body, ``(psc, stim, k_trues)``, decoded and validated
        in the ``cm.serve.decode`` span. ``form`` is a key of
        ``_BODY_FORMS``; "fit_many" is "ragged" when the body carries
        ``k_trues`` (else "stacked", and ``k_trues`` None). A
        sparse-shipped design reconstructs from its (validated, tiny)
        level table — finite by construction, so the dense isfinite
        pass is only paid for a dense-shipped one."""
        with span("cm.serve.decode", stages):
            raw = _load_npz(body)
            if form == "fit_many":
                form = "ragged" if "k_trues" in raw else "stacked"
            psc_key, stim_key, need = _BODY_FORMS[form]
            stim_trusted = f"{stim_key}_sparse_targets" in raw
            arrays = _decode_arrays(raw)
            ks = None
            if form == "ragged":
                ks = np.asarray(arrays.pop("k_trues")).ravel()
                if (ks.size == 0 or not np.issubdtype(ks.dtype, np.integer)
                        or (ks <= 0).any()):
                    raise _BadRequest("k_trues must be positive integer "
                                      "trial counts")
                ks = ks.astype(np.int64)
            if psc_key not in arrays or (stim_key and
                                         stim_key not in arrays):
                raise _BadRequest(need)
            psc, stim = arrays[psc_key], arrays.get(stim_key)
            if form == "fit" and psc.shape[0] != stim.shape[1]:
                raise _BadRequest(
                    f"psc carries {psc.shape[0]} trials but stim "
                    f"{stim.shape[1]} — psc is [K, T], stim [N, K]")
            if form == "stacked":
                if psc.ndim != 3 or stim.ndim != 3:
                    raise _BadRequest(
                        f"pscs must be [B, K, T] and stims [B, N, K]; got "
                        f"{psc.shape} and {stim.shape}")
                if psc.shape[0] != stim.shape[0]:
                    raise _BadRequest(
                        f"pscs carries {psc.shape[0]} experiments but "
                        f"stims {stim.shape[0]}")
                if psc.shape[1] != stim.shape[2]:
                    raise _BadRequest(
                        f"pscs carries {psc.shape[1]} trials but stims "
                        f"{stim.shape[2]} — pscs is [B, K, T], stims "
                        "[B, N, K]")
            if form == "ragged":
                sum_k = int(ks.sum())
                if psc.ndim != 2 or len(psc) != sum_k:
                    raise _BadRequest(
                        f"psc must be [sum(k_trues)={sum_k}, T]; got "
                        f"{tuple(psc.shape)}")
                if stim.ndim != 2 or stim.shape[1] != sum_k:
                    raise _BadRequest(
                        f"stim must be [N, sum(k_trues)={sum_k}]; got "
                        f"{tuple(stim.shape)}")
            # a non-finite block would fit to a silently-NaN posterior
            # (and a stream's get persisted by --state-dir auto-save)
            _require_finite(psc_key, psc)
            if stim is not None and not stim_trusted:
                _require_finite(stim_key, stim)
        return psc, stim, ks

    @staticmethod
    def _respond(results, return_fields, stages, what="fit", stack=None,
                 lam_wire=None):
        """The npz response of a fit, in the ``cm.serve.encode`` span:
        one result dict, or (``stack`` given) a list of one per
        experiment that ``stack`` joins into one dict; each filtered to
        ``return_fields`` and made host numpy. ``lam_wire='int8'``
        ships ``lam`` as per-row peak int8 codes."""
        with span("cm.serve.encode", stages):
            outs = [{k: np.asarray(v) for k, v in
                     _filter_fields(r, return_fields, what).items()}
                    for r in (results if stack else [results])]
            out = stack(outs) if stack else outs[0]
            if lam_wire == "int8" and "lam" in out:
                # lam dominates the response size (80 MB f32 at N=1000,
                # K=20000; spike posteriors in [0, 1]) — per-row peak
                # int8 codes quarter it at <=0.4%-of-peak step error.
                # History arrays keep full precision (opt-in and rare)
                enc = encode_psc_int8(out.pop("lam"))
                out["lam_q8"] = enc["psc_q8"]
                out["lam_q8_scale"] = enc["psc_q8_scale"]
            return "application/npz", _npz_bytes(**out)

    # -- endpoints ----------------------------------------------------------

    def do_health(self):
        # one source of truth with the sidecar's payload; busy/inflight
        # are dropped — the main thread answering /health at all means
        # it is not wedged (and inflight would just name this request)
        payload = self.status_payload()
        payload.pop("busy", None)
        payload.pop("inflight", None)
        payload["demixer"] = self.demixer_path
        payload["mesh_devices"] = (self.mesh.size if self.mesh is not None
                                   else 0)
        return "application/json", json.dumps(payload).encode()

    def status_payload(self):
        """Wedge-proof liveness snapshot for the status sidecar.

        Reads ONLY plain-Python fields (device/platform are strings
        cached at init; stream counters are ints) — it never calls into
        torch or the device, so it keeps answering while a long fit or a
        stuck device call has the main serving thread blocked.
        """
        snap = self.inflight  # one read: (method, path, t0) or None
        payload = {
            "status": "ok",
            "busy": snap is not None,
            "device": self.device,
            "platform": self.platform,
            "uptime_s": round(time.time() - self._t0, 1),
            "fits": self.n_fits,
            "demixes": self.n_demixes,
            # snapshot first: the main serving thread mutates the dict
            # (stream create/delete) while the sidecar thread iterates
            "streams": {name: {"trials": s.trial_count,
                               "iterations": s.iteration}
                        for name, s in list(self.streams.items())},
        }
        if snap is not None:
            method, path, t0 = snap
            payload["inflight"] = {
                "method": method, "path": path,
                "seconds": round(time.monotonic() - t0, 2)}
        return payload

    def do_demix(self, body, options_header, stages=None):
        """``stages``: the request's ``Metrics``, which gets the
        ``cm.serve.decode``, ``demix`` and ``encode`` spans."""
        opts = self._parse_options(
            options_header, frozenset(("trace_wire", "response_wire")),
            "demix")
        psc, _, _ = self._decode_experiment(body, stages, "demix")
        if self.demixer is None:
            raise _BadRequest("server started without a demixer")
        # RESPONSE wire: the same quantised vocabulary the request body
        # uses works on the way back (per-trace peak scales)
        response_wire = opts.pop("response_wire", None)
        out = self._demix(psc, self._wire_token(opts), stages)
        with span("cm.serve.encode", stages):
            if response_wire is None:
                return "application/npz", _npz_bytes(demixed=out)
            try:
                enc = _encode_psc(np.asarray(out), str(response_wire))
            except ValueError as exc:
                raise _BadRequest(str(exc)) from None
            return "application/npz", _npz_bytes(
                **{"demixed" + k[len("psc"):]: v for k, v in enc.items()})

    def do_fit(self, body, options_header, stages=None):
        """``stages``: the request's ``Metrics``, which gets the
        ``cm.serve.decode``, ``demix``, ``fit`` and ``encode`` spans."""
        import torch

        from .model import Model

        opts = self._parse_options(
            options_header,
            _FIT_OPTION_KEYS | {"method", "demix", "sharded",
                                "return_fields", "response_wire"},
            "fit")
        return_fields = _normalize_return_fields(
            opts.pop("return_fields", None))
        response_wire = opts.pop("response_wire", None)
        if response_wire not in (None, "int8"):
            raise _BadRequest(
                f"unknown fit response_wire {response_wire!r}; only "
                "'int8' is supported (per-row peak codes on the [N, K] "
                "lam posterior — use return_fields to drop it instead)")
        psc, stim, _ = self._decode_experiment(body, stages, "fit")
        method = opts.pop("method", "caviar")
        if method not in ("caviar", "cavi_sns", "mbcs", "cosamp"):
            raise _BadRequest(
                f"unknown method {method!r}; expected "
                "caviar | cavi_sns | mbcs | cosamp")
        self._resolve_mesh(opts, "fit", method)
        obs = self._maybe_demix(psc, opts, stages)
        if method != "cosamp":  # the host baseline takes no verbose
            opts.setdefault("verbose", False)
        model = Model(stim.shape[0], priors=self.priors)
        try:
            # return_fields also gates the device→host pull: a
            # summary-only response never pays for lam [N, K]
            with span("cm.serve.fit", stages):
                model.fit(obs, stim, method=method, fit_options=opts,
                          device=self.torch_device,
                          _materialize=return_fields)
        except (ValueError, TypeError) as exc:
            # solver-side validation (bad powers, an option the chosen
            # method doesn't take, shape mismatches) is a client error,
            # not a server fault — the request, not the server, is wrong
            raise _BadRequest(f"{method} rejected the request: {exc}")
        self.n_fits += 1
        # include device-resident (un-pulled) fields so a typo'd
        # return_fields 400 names the FULL available set; the filter
        # then keeps only requested fields, which Model already pulled
        out = {k: v for k, v in model.state.items()
               if isinstance(v, (np.ndarray, torch.Tensor))}
        out["fit_time_s"] = np.float64(model.time)
        if model.history:
            out.update({f"history_{k}": v for k, v in model.history.items()
                        if v is not None})
        return self._respond(out, return_fields, stages,
                             lam_wire=response_wire)

    def _run_many(self, obs, stims, opts, stages, method="caviar",
                  **extra):
        """Shared /fit_many solver call, in the ``cm.serve.fit`` span:
        method dispatch over the batched solver family, default priors,
        400 on solver-level rejections (bad values AND unknown knobs
        for the chosen method — each *_many signature rejects foreign
        kwargs)."""
        from .model import default_priors
        from .solvers import caviar_many, mbcs_many, sns_many

        opts.setdefault("verbose", False)
        priors = dict(self.priors or {})
        # stims is [B, N, K] for stacked batches, a list of [N, K_b]
        # for ragged sequential ones
        n_cells = (stims[0].shape[0] if isinstance(stims, (list, tuple))
                   else stims.shape[1])
        for key, val in default_priors(n_cells).items():
            priors.setdefault(key, val)
        if method == "caviar":
            fn, prior_args = caviar_many, (
                priors["mu"], priors["beta"], priors["shape"],
                priors["rate"], priors["phi"], priors["phi_cov"])
        elif method == "cavi_sns":
            fn, prior_args = sns_many, (
                priors["mu"], priors["beta"], priors["alpha"],
                priors["shape"], priors["rate"], priors["phi"],
                priors["phi_cov"])
        elif method == "mbcs":
            fn, prior_args = mbcs_many, (
                priors["mu"], priors["beta"], priors["shape"],
                priors["rate"])
        else:
            raise _BadRequest(
                f"unknown fit_many method {method!r}; expected 'caviar' "
                "| 'cavi_sns' | 'mbcs'")
        try:
            with span("cm.serve.fit", stages):
                results = fn(obs, stims, *prior_args, **extra, **opts,
                             device=self.torch_device)
        except (ValueError, TypeError) as exc:
            raise _BadRequest(
                f"{fn.__name__} rejected the request: {exc}")
        self.n_fits += len(results)
        return results

    def _fit_many_ragged(self, psc, stim, ks, opts, method, stages):
        """Ragged /fit_many: the trial counts ``ks`` split a concatenated
        single-experiment-wire body ('psc' [sum_K, T] — dense or any
        quantised psc_* wire — + 'stim' [N, sum_K]) into B experiments
        with different trial counts. For caviar the server pads to one
        shared 128-aligned K (int4 bodies pad at the WIRE level and
        keep the device pass-through) and runs caviar_many with
        ``k_trues``. sns/mbcs instead split the flat block and run
        per-experiment true-shape sequential fits (their *_many ragged
        contract). Returns the per-experiment results and the shared
        K."""
        from .utils.quant import PackedInt4Traces

        B = int(ks.size)
        k_pad = -(-int(ks.max()) // 128) * 128
        offs = np.concatenate([[0], np.cumsum(ks)])
        # the server pads EVERY experiment to the longest one's width,
        # so one giant + many tiny k_trues amplifies a small wire body
        # into B*k_pad rows — bound the padded allocations with the
        # same named cap as the sparse-stim decode
        row_bytes = (psc.packed.shape[1]
                     if isinstance(psc, PackedInt4Traces)
                     else psc.shape[1] * psc.dtype.itemsize)
        # floor the stim itemsize at f32's: the fit itself and the
        # [B, N, k_pad] output stack are f32 regardless of the wire
        # dtype, so a narrow (int8/f16) stim body must not undercut
        # the cap that bounds those allocations
        pad_bytes = max(
            B * k_pad * row_bytes,
            B * stim.shape[0] * k_pad * max(stim.dtype.itemsize, 4))
        if pad_bytes > _MAX_SPARSE_DENSE_BYTES:
            raise _BadRequest(
                f"ragged fit_many would pad to {B} x {k_pad} trials "
                f"(~{pad_bytes >> 30} GB server-side, > "
                f"{_MAX_SPARSE_DENSE_BYTES >> 30} GB) — split the "
                "batch, or group experiments of similar length")
        self._resolve_mesh(opts, "fit_many", method, ragged=True)
        if method != "caviar":
            # sns/mbcs run per-experiment TRUE-SHAPE sequential fits
            # (solvers/batched.py): demix once over the flat block,
            # split at the offsets, hand the ragged lists over
            import torch

            obs_flat = self._maybe_demix(psc, opts, stages)
            obs_flat = (obs_flat.cpu().numpy()
                        if isinstance(obs_flat, torch.Tensor)
                        else np.asarray(obs_flat))
            ys_list = [obs_flat[int(offs[b]):int(offs[b + 1])]
                       for b in range(B)]
            st_list = [stim[:, int(offs[b]):int(offs[b + 1])]
                       for b in range(B)]
            return self._run_many(ys_list, st_list, opts, stages,
                                  method=method), k_pad
        if isinstance(psc, PackedInt4Traces):
            # pad at the wire level (16x smaller than dense): zero
            # packed rows at scale 1 decode to exact zeros
            packed_pad = np.zeros((B * k_pad, psc.packed.shape[1]),
                                  np.uint8)
            scale_pad = np.ones((B * k_pad,), np.float32)
            for b in range(B):
                lo, hi = int(offs[b]), int(offs[b + 1])
                packed_pad[b * k_pad:b * k_pad + hi - lo] = \
                    psc.packed[lo:hi]
                scale_pad[b * k_pad:b * k_pad + hi - lo] = \
                    psc.scale[lo:hi]
            pscs = PackedInt4Traces(packed_pad, scale_pad, psc.t_true,
                                    psc.decimate, lead=(B, k_pad))
        else:
            pscs = np.zeros((B, k_pad, psc.shape[1]), psc.dtype)
            for b in range(B):
                pscs[b, :int(ks[b])] = psc[int(offs[b]):int(offs[b + 1])]
        stims = np.zeros((B, stim.shape[0], k_pad), stim.dtype)
        for b in range(B):
            stims[b, :, :int(ks[b])] = stim[:, int(offs[b]):
                                            int(offs[b + 1])]
        obs = self._maybe_demix(pscs, opts, stages)
        return self._run_many(obs, stims, opts, stages, method=method,
                              k_trues=ks), k_pad

    @staticmethod
    def _pack_ragged_results(results, ks, k_pad, wire_meta=False):
        """Stack true-width per-experiment result dicts (host numpy)
        into one response dict.

        Trial-axis fields — any field whose LAST dim equals each
        experiment's true trial count in every experiment (lam
        [N, K_b], z [K_b], mbcs' per-trial shape/rate [K_b]) —
        zero-pad that dim to the shared k_pad. Other per-experiment
        shape mismatches (mbcs receptive_fields [N, P_b] when
        experiments scan different level tables) zero-pad each dim to
        the max.

        With ``wire_meta`` (sent by metadata-aware FitClients) the
        response also carries ``_k_fields`` (names of the trial-axis
        padded fields), and — for the non-trial padded fields —
        ``_shape_fields`` plus a ``_shapes_<key>`` [B, ndim] array of
        true extents, so the client restores EVERY field to its true
        shape (the library ragged *_many contract). Without it, the
        wire matches the pre-metadata protocol (padded arrays only):
        a pre-metadata client iterates every response key per
        experiment, so an unrequested metadata array would crash it."""
        B = len(results)
        out = {}
        meta = {}
        k_fields = []
        shape_fields = []
        for key in results[0]:
            vals = [r[key] for r in results]
            trialish = all(
                v.ndim >= 1 and v.shape[-1] == int(ks[b])
                for b, v in enumerate(vals))
            if trialish:
                k_fields.append(key)
                stack = np.zeros((B, *vals[0].shape[:-1], k_pad),
                                 vals[0].dtype)
                for b, v in enumerate(vals):
                    stack[(b, *map(slice, v.shape))] = v
            elif len({v.shape for v in vals}) > 1:
                shape_fields.append(key)
                meta[f"_shapes_{key}"] = np.asarray(
                    [v.shape for v in vals], np.int32)
                dims = [max(v.shape[d] for v in vals)
                        for d in range(vals[0].ndim)]
                stack = np.zeros((B, *dims), vals[0].dtype)
                for b, v in enumerate(vals):
                    stack[(b, *map(slice, v.shape))] = v
            else:
                stack = np.stack(vals)
            out[key] = stack
        out["k_trues"] = ks.astype(np.int32)
        if wire_meta:
            out["_k_fields"] = np.asarray(k_fields)
            out["_shape_fields"] = np.asarray(shape_fields)
            out.update(meta)
        return out

    def do_fit_many(self, body, options_header, stages=None):
        """Fit B same-shape experiments in one request
        (``solvers.caviar_many`` — or ``sns_many``/``mbcs_many`` via
        the ``method`` option) — the server's replacement for a SLURM
        job array. Ragged batches (different trial counts) arrive as a
        concatenated body + 'k_trues' (``_fit_many_ragged``; all three
        methods). ``stages``: the request's ``Metrics``, which gets the
        ``cm.serve.decode``, ``demix``, ``fit`` and ``encode`` spans."""
        opts = self._parse_options(options_header, _FIT_MANY_OPTION_KEYS,
                                   "fit_many")
        method = str(opts.pop("method", "caviar"))
        return_fields = _normalize_return_fields(
            opts.pop("return_fields", None))
        # response-metadata capability signal: only clients that SAY
        # they understand the `_k_fields`/`_shape_fields` metadata
        # arrays get them — a pre-metadata FitClient iterates every
        # response key per experiment, so unconditional emission broke
        # old clients against a new server (IndexError at B >= 3).
        # Client/server version skew is a designed-for scenario (the
        # client deploys numpy-only on acquisition machines)
        wire_meta = bool(opts.pop("wire_meta", False))
        psc, stim, ks = self._decode_experiment(body, stages, "fit_many")
        if ks is not None:
            # ragged batch: one concatenated [sum_K, T] trace block +
            # one flat [N, sum_K] stim (the SINGLE-experiment wire,
            # reused verbatim) + per-experiment trial counts
            results, k_pad = self._fit_many_ragged(psc, stim, ks, opts,
                                                   method, stages)

            def stack(rs):
                return self._pack_ragged_results(rs, ks, k_pad, wire_meta)
        else:
            self._resolve_mesh(opts, "fit_many")
            obs = self._maybe_demix(psc, opts, stages)
            results = self._run_many(obs, stim, opts, stages, method=method)

            def stack(rs):
                return {key: np.stack([r[key] for r in rs])
                        for key in rs[0]}
        return self._respond(results, return_fields, stages, "fit_many",
                             stack)

    def do_warm(self, options_header):
        """Run the demix+fit pipeline once on synthetic data of the given
        shapes in THIS process: the first request at a shape pays the
        kernel build (``ops/_build.py``), the cuBLAS/cuSOLVER handles
        and the allocator's pools. ``batch`` also warms /fit_many at
        that experiment count."""
        opts = self._parse_options(
            options_header,
            frozenset(("shapes", "iters", "powers", "trace_wire",
                       "batch")), "warm")
        from .utils.synthetic import synthetic_experiment

        shapes = opts.pop("shapes", None)
        if not shapes:
            raise _BadRequest('X-Options must carry {"shapes": [[N, K], ...]}')
        iters = int(opts.pop("iters", 50))
        powers = [float(p) for p in opts.pop("powers", (45.0, 55.0, 65.0))]
        batch = int(opts.pop("batch", 0))
        timings = {}
        for shape in shapes:
            try:
                n, k = (int(shape[0]), int(shape[1]))
            except (TypeError, ValueError, IndexError):
                raise _BadRequest(f"bad shape {shape!r}; want [N, K]")
            psc, stim = synthetic_experiment(n, k, powers=powers)
            body = _npz_bytes(psc=psc, stim=stim)
            t0 = time.perf_counter()
            self.do_fit(body, json.dumps(
                {"iters": iters, "powers": powers, **opts}))
            timings[f"{n}x{k}"] = round(time.perf_counter() - t0, 2)
            if batch > 0:
                body = _npz_bytes(
                    pscs=np.broadcast_to(
                        psc, (batch,) + psc.shape).copy(),
                    stims=np.broadcast_to(
                        stim, (batch,) + stim.shape).copy())
                t0 = time.perf_counter()
                self.do_fit_many(body, json.dumps(
                    {"iters": iters, "powers": powers, **opts}))
                timings[f"{batch}x{n}x{k}"] = round(
                    time.perf_counter() - t0, 2)
        return "application/json", json.dumps(
            {"warmed": timings}).encode()

    def do_stream_update(self, name, body, options_header, stages=None):
        """``stages``: the request's ``Metrics``, which gets the
        ``cm.serve.decode``, ``demix``, ``fit`` and ``encode`` spans."""
        from .solvers import OnlineCaviar

        opts = self._parse_options(
            options_header,
            frozenset(("iters", "fn_scan", "trace_wire", "demix", "create")),
            "stream-update")
        psc, stim, _ = self._decode_experiment(body, stages, "stream")
        create = opts.pop("create", {}) or {}
        if not isinstance(create, dict):
            raise _BadRequest("'create' must be a JSON object of "
                              "OnlineCaviar options")
        stream = self.streams.get(name)
        fresh = stream is None
        if fresh:
            unknown = set(create) - _STREAM_CREATE_KEYS
            if unknown:
                raise _BadRequest(
                    f"unknown stream-create option(s) {sorted(unknown)}; "
                    f"allowed: {sorted(_STREAM_CREATE_KEYS)}")
            designer = self.designers.get(name)
            if designer is not None and designer.N != stim.shape[0]:
                raise _BadRequest(
                    f"stream {name!r} has a designer built for "
                    f"N={designer.N} but this block carries "
                    f"{stim.shape[0]} neurons")
            stream = OnlineCaviar(stim.shape[0], priors=self.priors,
                                  device=self.torch_device, mesh=self.mesh,
                                  **create)
        elif create:
            raise _BadRequest(
                f"stream {name!r} already exists; 'create' options only "
                "apply to the first update")
        # closed-loop blocks may arrive raw; demix if asked (the
        # demixed block stays on the device and the stream takes it as
        # it is). A bad trace_wire token is validated by the solver wire
        # itself (prepare_traces) BEFORE any ingestion — its ValueError
        # maps to 400 below.
        import torch

        obs = self._maybe_demix(psc, opts, stages)
        try:
            with span("cm.serve.fit", stages):
                stream.update(obs if isinstance(obs, torch.Tensor)
                              else np.asarray(obs), stim,
                              iters=int(opts.pop("iters", 10)),
                              fn_scan=bool(opts.pop("fn_scan", True)),
                              trace_wire=opts.pop("trace_wire", None)
                              or None)
        except ValueError as exc:
            raise _BadRequest(str(exc))
        if fresh:
            # register only after the first update succeeds — a failed
            # create must not burn the name with a zombie stream whose
            # create-options can never be retried
            self.streams[name] = stream
        reply = {
            "stream": name,
            "trial_count": stream.trial_count,
            "iterations": stream.iteration,
            "reconnected": stream.last_reconnected,
        }
        designer = self.designers.get(name)
        if designer is not None:
            # closed-loop: fold the acquired block into the design
            # policy so the next /design concentrates the budget on
            # the unresolved pool (design.AdaptiveDesigner protocol).
            # The block is already ingested at this point, so a policy
            # failure must NOT turn into an error status — the rig
            # would retry and double-ingest the same trials; report it
            # in the (successful) reply instead.
            try:
                designer.observe(stim, stream.posterior())
            except Exception as exc:
                reply["designer_error"] = f"{type(exc).__name__}: {exc}"
        with span("cm.serve.encode", stages):
            return "application/json", json.dumps(reply).encode()

    def _get_stream(self, name):
        stream = self.streams.get(name)
        if stream is None:
            raise _BadRequest(
                f"no stream {name!r}; live: {sorted(self.streams)}")
        return stream

    def do_stream_posterior(self, name):
        return "application/npz", _npz_bytes(
            **self._get_stream(name).posterior())

    def do_stream_result(self, name, options_header):
        opts = self._parse_options(options_header,
                                   frozenset(("fn_scan",)), "stream-result")
        res = self._get_stream(name).result(
            fn_scan=bool(opts.pop("fn_scan", True)))
        return "application/npz", _npz_bytes(**res)

    def do_stream_design(self, name, options_header):
        """Next stimulus design for a closed-loop stream: the rig asks
        'what do I stimulate next?'. Round 0 works before the stream
        exists (no posterior yet — the static blockwise protocol);
        after each /update the server folds the acquired block into
        the policy, so later designs concentrate on the unresolved
        pool and ``resolved`` ends the experiment early."""
        from .design import AdaptiveDesigner

        opts = self._parse_options(
            options_header, frozenset(("trials", "designer")), "design")
        designer = self.designers.get(name)
        fresh = designer is None
        spec = opts.pop("designer", None)
        if fresh:
            if not isinstance(spec, dict):
                raise _BadRequest(
                    'first design call must carry {"designer": {"N": ..., '
                    '"H": ..., "powers": [...]}} (optional null_trials / '
                    'conn_trials)')
            unknown = set(spec) - _DESIGNER_KEYS
            if unknown:
                raise _BadRequest(
                    f"unknown designer option(s) {sorted(unknown)}; "
                    f"allowed: {sorted(_DESIGNER_KEYS)}")
            missing = {"N", "H", "powers"} - set(spec)
            if missing:
                raise _BadRequest(f"designer needs {sorted(missing)}")
            stream = self.streams.get(name)
            try:
                designer = AdaptiveDesigner(
                    spec["N"], spec["H"], spec["powers"],
                    **{k: spec[k] for k in ("null_trials", "conn_trials")
                       if k in spec})
            except (ValueError, TypeError) as exc:
                raise _BadRequest(str(exc)) from None
            if stream is not None and designer.N != stream.N:
                raise _BadRequest(
                    f"designer N={designer.N} but stream {name!r} "
                    f"runs N={stream.N}")
        elif spec is not None:
            raise _BadRequest(
                f"stream {name!r} already has a designer; 'designer' "
                "options only apply to the first design call")
        out = dict(resolved=designer.resolved, pool=designer.pool,
                   rounds=designer.rounds)
        if not designer.resolved:
            trials = opts.pop("trials", None)
            if trials is None:
                raise _BadRequest('X-Options must carry {"trials": ...}')
            try:
                out["stim"] = designer.next_design(int(trials))
            except (ValueError, TypeError) as exc:
                raise _BadRequest(str(exc))
        if fresh:
            # register only after the whole call succeeds — a rejected
            # first call (missing trials, bad design parameters) must
            # not burn the name (same invariant as stream creation)
            self.designers[name] = designer
        return "application/npz", _npz_bytes(**out)

    def do_stream_delete(self, name):
        self._get_stream(name)  # 400 on unknown
        del self.streams[name]
        self.designers.pop(name, None)
        return "application/json", json.dumps({"deleted": name}).encode()

    # -- stream persistence: a daemon restart must not lose a live
    # closed-loop experiment (OnlineCaviar.save/load carry the full
    # streaming state: capacity buffers, CAVI state, tables, counters)

    def _stream_path(self, name):
        import os
        from urllib.parse import quote

        if not self.state_dir:
            raise _BadRequest(
                "stream persistence needs the server started with "
                "--state-dir")
        # quote() the name for the filesystem — stream names are free
        # text ('rig A/slice#2'), filenames must be single components
        return os.path.join(self.state_dir,
                            quote(str(name), safe="") + ".npz")

    def _designer_path(self, name):
        # appended to the FULL stream path: stream files always end
        # ".npz" and this never does, so no stream name (however
        # quoted) can collide with another stream's designer sidecar
        return self._stream_path(name) + ".designer"

    def _save_one(self, name, stream):
        import os

        path = self._stream_path(name)
        stream.save(path)
        designer = self.designers.get(name)
        dpath = self._designer_path(name)
        if designer is not None:
            designer.save(dpath)
        elif os.path.exists(dpath):
            # the name's PREVIOUS experiment had a designer; a stale
            # sidecar must not resurrect its evidence counts on reload
            os.remove(dpath)
        return path

    def do_stream_save(self, name):
        stream = self._get_stream(name)
        try:
            self._save_one(name, stream)
        except RuntimeError as exc:  # no state yet (never updated)
            raise _BadRequest(str(exc))
        return "application/json", json.dumps({
            "saved": name,
            "trial_count": stream.trial_count,
            "iterations": stream.iteration,
            "designer": name in self.designers,
        }).encode()

    def do_stream_load(self, name, options_header):
        import os

        from .solvers import OnlineCaviar

        opts = self._parse_options(options_header,
                                   frozenset(("create",)), "stream-load")
        create = opts.pop("create", {}) or {}
        if not isinstance(create, dict):
            raise _BadRequest("'create' must be a JSON object of "
                              "OnlineCaviar options")
        unknown = set(create) - _STREAM_CREATE_KEYS
        if unknown:
            raise _BadRequest(
                f"unknown stream-create option(s) {sorted(unknown)}; "
                f"allowed: {sorted(_STREAM_CREATE_KEYS)}")
        if name in self.streams:
            raise _BadRequest(
                f"stream {name!r} is already live — DELETE it before "
                "loading a checkpoint over it")
        path = self._stream_path(name)
        if not os.path.exists(path):
            raise _BadRequest(f"no saved state for stream {name!r}")
        try:
            stream = OnlineCaviar.load(
                path, priors=self.priors, device=self.torch_device,
                mesh=self.mesh, **create)
        except (ValueError, TypeError) as exc:
            # bad create knobs are the request's fault, not the file's
            raise _BadRequest(f"stream restore rejected: {exc}") from None
        dpath = self._designer_path(name)
        designer = None
        if os.path.exists(dpath):
            from .design import AdaptiveDesigner

            designer = AdaptiveDesigner.load(dpath)
            if designer.N != stream.N:
                raise _BadRequest(
                    f"saved designer was built for N={designer.N} but "
                    f"the stream checkpoint runs N={stream.N} — the "
                    "sidecar is from a different experiment; remove "
                    f"{dpath} to load the stream without it")
        self.streams[name] = stream
        if designer is not None:
            self.designers[name] = designer
        return "application/json", json.dumps({
            "loaded": name,
            "trial_count": stream.trial_count,
            "iterations": stream.iteration,
            "designer": name in self.designers,
        }).encode()

    def do_profile(self, options_header):
        """Capture a ``torch.profiler`` trace around LIVE requests:
        ``{"action": "start"}`` begins a trace in this process, every
        later request (fit, demix, stream update) records into it, and
        ``{"action": "stop"}`` writes a Chrome trace (``trace.json``,
        open it in chrome://tracing or Perfetto) and returns its
        directory and path. One trace at a time; a trace still open at
        a graceful shutdown is written then."""
        opts = self._parse_options(options_header,
                                   frozenset(("action", "dir")),
                                   "profile")
        action = str(opts.pop("action", ""))
        if action == "start":
            if self._profile_dir is not None:
                raise _BadRequest(
                    "a profile is already active (dir="
                    f"{self._profile_dir}); POST {{\"action\": "
                    "\"stop\"}} first")
            import os
            import tempfile

            import torch

            # a client-named dir is a SERVER filesystem path: confine
            # it to the temp dir (or the operator-chosen --state-dir)
            # — the same "a wire request must not name an arbitrary
            # server location" policy as _stream_path.
            client_dir = opts.pop("dir", None)
            if client_dir is None:
                trace_dir = tempfile.mkdtemp(prefix="cm_profile_")
            else:
                bases = [tempfile.gettempdir()]
                if self.state_dir:
                    bases.append(self.state_dir)
                real = os.path.realpath(str(client_dir))
                if not any(
                        real == os.path.realpath(b)
                        or real.startswith(os.path.realpath(b) + os.sep)
                        for b in bases):
                    raise _BadRequest(
                        "profile dir must live under the server's temp "
                        f"dir ({tempfile.gettempdir()}) or --state-dir; "
                        "omit it for a fresh temp directory")
                trace_dir = str(client_dir)
                os.makedirs(trace_dir, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.torch_device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            try:
                prof.start()
            except Exception as exc:
                raise _BadRequest(f"profiler failed to start: {exc}")
            self._profiler = prof
            self._profile_dir = trace_dir
            return "application/json", json.dumps(
                {"profiling": True, "dir": trace_dir}).encode()
        if action == "stop":
            if self._profile_dir is None:
                raise _BadRequest("no active profile; POST "
                                  '{"action": "start"} first')
            trace_dir = self._profile_dir
            trace = self.stop_profile()
            return "application/json", json.dumps(
                {"profiling": False, "dir": trace_dir,
                 "trace": trace}).encode()
        raise _BadRequest(
            'X-Options must carry {"action": "start" | "stop"}')

    def stop_profile(self):
        """Finalise an active trace and write it as a Chrome trace;
        returns the file's path (None when no trace is active)."""
        if self._profile_dir is None:
            return None
        import os

        trace_dir, prof = self._profile_dir, self._profiler
        # clear first: a failed stop must not leave the service
        # believing a profile is active
        self._profile_dir = self._profiler = None
        path = os.path.join(trace_dir, "trace.json")
        try:
            if self.torch_device.type == "cuda":
                import torch

                torch.cuda.synchronize(self.torch_device)
            prof.stop()
            prof.export_chrome_trace(path)
        except Exception as exc:
            raise RuntimeError(
                f"profiler failed to stop (capture in {trace_dir} may "
                f"be incomplete): {exc}")
        return path

    def save_all_streams(self):
        """Checkpoint every live stream (used on graceful shutdown when
        --state-dir is set). Returns {name: path or error}."""
        out = {}
        for name, stream in self.streams.items():
            try:
                out[name] = self._save_one(name, stream)
            except Exception as exc:
                out[name] = f"FAILED: {exc}"
        return out


def _make_handler(service, server_box):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        # One response per connection (no keep-alive): the server is
        # single-threaded, so a keep-alive client idling between
        # requests would hold the accept loop hostage and wedge every
        # other client (urllib closes per request, but requests.Session
        # / Go net/http / curl keep connections open). TCP setup is
        # noise next to a fit; correctness beats the round trip.
        protocol_version = "HTTP/1.0"
        # ...and a stalled client mid-request (silent socket, half-sent
        # body) times out instead of blocking the daemon forever. This
        # is recv-idle time, not total transfer time — big uploads on
        # slow links are fine as long as bytes keep flowing.
        timeout = 300

        def log_message(self, fmt, *args):  # quiet by default
            if service_verbose:
                super().log_message(fmt, *args)

        def _reply(self, code, content_type, payload):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _json_error(self, code, message):
            # an error path may not have drained the request body —
            # drop the connection so keep-alive can't desync
            self.close_connection = True
            self._reply(code, "application/json",
                        json.dumps({"error": message}).encode())

        def _body(self):
            length = int(self.headers.get("Content-Length", 0))
            if length > max_body:
                raise _BadRequest(
                    f"body {length / 1e6:.0f} MB exceeds the server's "
                    f"--max-mb {max_body / 1e6:.0f}")
            with span("cm.serve.read", self.stages):
                return self.rfile.read(length)

        def _route(self):
            from urllib.parse import unquote

            path = self.path.split("?", 1)[0].rstrip("/")
            opts = self.headers.get("X-Options")
            method = self.command
            if auth_token is not None:
                import hmac

                got = self.headers.get("Authorization", "")
                if not (got.startswith("Bearer ") and hmac.compare_digest(
                        got[len("Bearer "):], auth_token)):
                    raise _Unauthorized(
                        "missing or wrong bearer token (the server was "
                        "started with --token)")
            if method == "GET" and path in ("", "/health"):
                return service.do_health()
            if path.startswith("/stream/"):
                parts = path.split("/")
                if len(parts) == 4:
                    _, _, name, verb = parts
                    name = unquote(name)
                    if method == "POST" and verb == "update":
                        return service.do_stream_update(
                            name, self._body(), opts, self.stages)
                    if method == "POST" and verb == "save":
                        return service.do_stream_save(name)
                    if method == "POST" and verb == "load":
                        return service.do_stream_load(name, opts)
                    if method == "POST" and verb == "design":
                        return service.do_stream_design(name, opts)
                    if method == "GET" and verb == "posterior":
                        return service.do_stream_posterior(name)
                    if method == "GET" and verb == "result":
                        return service.do_stream_result(name, opts)
                if len(parts) == 3 and method == "DELETE":
                    return service.do_stream_delete(unquote(parts[2]))
            if method == "POST":
                if path == "/demix":
                    return service.do_demix(self._body(), opts, self.stages)
                if path == "/fit":
                    return service.do_fit(self._body(), opts, self.stages)
                if path == "/fit_many":
                    return service.do_fit_many(self._body(), opts,
                                               self.stages)
                if path == "/warm":
                    return service.do_warm(opts)
                if path == "/profile":
                    return service.do_profile(opts)
                if path == "/shutdown":
                    import threading

                    threading.Thread(
                        target=server_box[0].shutdown, daemon=True).start()
                    return ("application/json",
                            json.dumps({"shutting_down": True}).encode())
            return None

        def _stage_seconds(self):
            """{stage: host seconds} of the request's ``cm.serve.*``
            spans, for its log row."""
            out = {}
            for r in self.stages.records:
                key = r["name"][len("cm.serve."):]
                out[key] = out.get(key, 0.0) + r["seconds"]
            return {k: round(v, 6) for k, v in out.items()}

        def _metric(self, status, t0, bytes_out):
            if metrics_fh is None:
                return
            try:
                metrics_fh.write(json.dumps({
                    "ts": round(time.time(), 3),
                    "method": self.command,
                    "path": self.path.split("?", 1)[0],
                    "status": status,
                    "seconds": round(time.perf_counter() - t0, 4),
                    "bytes_in": int(self.headers.get("Content-Length", 0)
                                    or 0),
                    "bytes_out": bytes_out,
                    "stages": self._stage_seconds(),
                }) + "\n")
                metrics_fh.flush()
            except Exception:  # monitoring must never break serving
                pass

        def _handle(self):
            service.inflight = (self.command,
                                self.path.split("?", 1)[0],
                                time.monotonic())
            try:
                self._handle_tracked()
            finally:
                service.inflight = None

        def _handle_tracked(self):
            t0 = time.perf_counter()
            # the request's stages, in host seconds, for its log row
            self.stages = Metrics()
            try:
                routed = self._route()
            except _Unauthorized as exc:
                self._metric(401, t0, 0)
                return self._json_error(401, str(exc))
            except _BadRequest as exc:
                self._metric(400, t0, 0)
                return self._json_error(400, str(exc))
            except BrokenPipeError:
                raise
            except Exception as exc:  # keep the daemon alive
                self._metric(500, t0, 0)
                return self._json_error(
                    500, f"{type(exc).__name__}: {exc}")
            if routed is None:
                self._metric(404, t0, 0)
                return self._json_error(
                    404, f"no route {self.command} {self.path}")
            try:
                with span("cm.serve.write", self.stages):
                    self._reply(200, *routed)
            except BrokenPipeError:
                # client went away mid-response: the dashboard must see
                # a failure, not a 200 with undelivered bytes
                self._metric(499, t0, 0)
                raise
            self._metric(200, t0, len(routed[1]))

        do_GET = do_POST = do_DELETE = _handle

    service_verbose = service.verbose
    max_body = service.max_body_bytes
    metrics_fh = getattr(service, "metrics_fh", None)
    auth_token = getattr(service, "auth_token", None)
    return Handler


def start_status_server(service, host="127.0.0.1", port=0):
    """Read-only status sidecar: GET /health (or /status) on its OWN
    thread and port, answering from ``FitService.status_payload()``.

    The main server is single-threaded by design (one card, one
    request at a time), which means it cannot answer a liveness probe
    while a fit runs — and cannot answer at all if a device call never
    returns. The sidecar touches neither torch nor the device, so it
    stays responsive through both, and its ``inflight.seconds`` field is
    what lets a supervisor tell a long request from a wedge. Returns the
    bound ``HTTPServer`` (already serving; ``shutdown()`` +
    ``server_close()`` to stop).
    """
    import threading
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class StatusHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.0"
        timeout = 30

        def log_message(self, fmt, *args):  # monitoring endpoint: quiet
            pass

        def do_GET(self):
            path = self.path.split("?", 1)[0].rstrip("/")
            if path in ("", "/health", "/status"):
                code, payload = 200, json.dumps(
                    service.status_payload()).encode()
            else:
                code, payload = 404, json.dumps(
                    {"error": f"no route GET {path} (status sidecar "
                              "serves /health only)"}).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

    httpd = HTTPServer((host, port), StatusHandler)
    threading.Thread(target=httpd.serve_forever, daemon=True,
                     name="status-sidecar").start()
    return httpd


def start_watchdog(service, timeout_s, exit_fn=None, grace_s=10.0):
    """Kill the daemon if ONE request runs longer than ``timeout_s``.

    The failure mode this targets: a device call never returns (a
    hung kernel, a lost card), and the single-threaded daemon wedges
    forever holding its port — no error, no exit, nothing for a
    supervisor to react to. The watchdog turns that into a crash a
    supervisor CAN react to: it logs a JSON diagnostic (stderr + the --metrics log), makes
    a bounded best-effort ``save_all_streams()`` (in a side thread
    with a ``grace_s`` join — the saver itself may hang on a dead
    device), then ``os._exit(WATCHDOG_EXIT_CODE)``.

    Opt-in (``--request-timeout-s``), and the bound must cover the
    slowest legitimate request INCLUDING the first one, which builds
    the CUDA kernels when no build is cached.

    Returns a ``threading.Event``; ``set()`` cancels the watchdog
    (tests). ``exit_fn`` overrides ``os._exit`` (tests).
    """
    import os as _os
    import sys as _sys
    import threading

    if exit_fn is None:
        def exit_fn(code):
            _os._exit(code)
    timeout_s = float(timeout_s)
    stop = threading.Event()

    def _run():
        poll = max(0.05, min(1.0, timeout_s / 10))
        while not stop.wait(poll):
            snap = service.inflight
            if snap is None:
                continue
            method, path, t0 = snap
            elapsed = time.monotonic() - t0
            if elapsed <= timeout_s:
                continue
            msg = {"watchdog_fired": True, "method": method,
                   "path": path, "seconds": round(elapsed, 1),
                   "timeout_s": timeout_s,
                   "exit_code": WATCHDOG_EXIT_CODE}
            print(json.dumps(msg), file=_sys.stderr, flush=True)
            fh = getattr(service, "metrics_fh", None)
            if fh is not None:
                try:
                    fh.write(json.dumps(msg) + "\n")
                    fh.flush()
                except Exception:
                    pass
            if service.state_dir and service.streams:
                saver = threading.Thread(
                    target=service.save_all_streams, daemon=True)
                saver.start()
                saver.join(grace_s)
            exit_fn(WATCHDOG_EXIT_CODE)
            return

    threading.Thread(target=_run, daemon=True, name="watchdog").start()
    return stop


def run_server(host="127.0.0.1", port=DEFAULT_PORT, demixer_path=None,
               default_wire=None, max_mb=2048, warm_shapes=(),
               verbose=False, ready_fd=None, mesh_devices=0,
               state_dir=None, metrics_path=None, auth_token=None,
               status_port=None, request_timeout_s=None, device=None):
    """Build the service, bind, optionally pre-warm, then serve forever.

    ``port=0`` lets the OS assign one; the bound port is printed as
    ``SERVING host=<h> port=<p> device=<d>`` (and written to
    ``ready_fd`` if given) before the warm-up so supervisors can wait on
    it. ``device=None`` means CUDA and raises without a GPU (pass
    ``device="cpu"`` to serve from the CPU).
    """
    from http.server import HTTPServer

    service = FitService(demixer_path=demixer_path,
                         default_wire=default_wire,
                         mesh_devices=mesh_devices, state_dir=state_dir,
                         device=device)
    service.verbose = verbose
    service.max_body_bytes = int(max_mb * 1e6)
    service.auth_token = auth_token or None
    if metrics_path:
        # request log, one JSON line each: {ts, method, path, status,
        # seconds, bytes_in, bytes_out} — tail-able by any log shipper
        service.metrics_fh = open(metrics_path, "a")
    server_box = [None]
    httpd = HTTPServer((host, port), _make_handler(service, server_box))
    server_box[0] = httpd
    bound = httpd.server_address[1]
    status_httpd = None
    if status_port is not None:
        # announce BEFORE the SERVING line: supervisors parse stdout
        # up to SERVING, so both ports are known by then
        status_httpd = start_status_server(service, host, status_port)
        print(f"STATUS host={host} port={status_httpd.server_address[1]}",
              flush=True)
    if request_timeout_s:
        start_watchdog(service, request_timeout_s)
    print(f"SERVING host={host} port={bound} device={service.device}",
          flush=True)
    if ready_fd is not None:
        import os

        os.write(ready_fd, f"{bound}\n".encode())
        os.close(ready_fd)
    if warm_shapes:
        t0 = time.perf_counter()
        try:
            service.do_warm(json.dumps(
                {"shapes": [list(s) for s in warm_shapes]}))
            print(f"warmed {len(warm_shapes)} shape(s) in "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
        except Exception as exc:
            # warm-up is advisory: SERVING was already announced (a
            # supervisor may have proceeded on it), so a bad warm shape
            # or an out-of-memory warm fit must not take the daemon down
            print(f"warm-up failed (serving anyway): {exc}", flush=True)
    # supervisors stop daemons with SIGTERM, which would bypass the
    # finally-block auto-save below (no unwind on the default handler).
    # Route it into the same graceful stop as POST /shutdown. The
    # shutdown() call must come from another thread: called inline from
    # the handler it would deadlock (shutdown waits for the serve loop,
    # which is paused inside this very handler).
    import signal
    import threading

    def _on_sigterm(_sig, _frm):
        print("SIGTERM: stopping gracefully", flush=True)
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    prev_sigterm = None
    try:
        prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:  # not the main thread (embedded use) — skip
        pass
    try:
        httpd.serve_forever()
    finally:
        if prev_sigterm is not None:
            # restore the embedding program's handler — leaving ours
            # installed would make every later SIGTERM a no-op
            # (shutdown() of an already-stopped server returns
            # immediately) and the process unkillable except by KILL
            try:
                signal.signal(signal.SIGTERM, prev_sigterm)
            except ValueError:
                pass
        httpd.server_close()
        if status_httpd is not None:
            status_httpd.shutdown()
            status_httpd.server_close()
        try:
            where = service.stop_profile()  # don't lose a live capture
            if where:
                print(f"profile trace -> {where}", flush=True)
        except Exception:
            pass
        if state_dir and service.streams:
            # a graceful stop must not lose live closed-loop experiments
            saved = service.save_all_streams()
            for name, where in saved.items():
                print(f"stream {name!r} -> {where}", flush=True)
    return service


# ---------------------------------------------------------------- client

class FitClient:
    """Stdlib client for the fit server (numpy + urllib only — rig-side
    machines need neither torch nor a GPU). It speaks the wire of the
    JAX package's server too.

    >>> client = FitClient("http://127.0.0.1:8799")
    >>> state = client.fit(psc, stim, iters=50, msrmp=0.3)
    >>> state["mu"]          # posterior weight means, [N]
    """

    # endpoints safe to re-send after a CONNECTION-level failure (no
    # HTTP response at all — server down/restarting, refused, reset;
    # a client-side read timeout is NOT one of these and is never
    # retried): stateless requests whose replay changes nothing.
    # Stream mutations (/stream/<n>/update advances trial counters)
    # and /shutdown are deliberately absent: replaying them after an
    # ambiguous failure could double-apply.
    _RETRY_SAFE = frozenset(("/health", "/fit", "/fit_many", "/demix",
                             "/warm"))

    def __init__(self, base_url=f"http://127.0.0.1:{DEFAULT_PORT}",
                 timeout=600.0, token=None, retries=0,
                 retry_backoff_s=1.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.token = token
        # retries > 0: re-send stateless requests that failed at the
        # connection level (see _RETRY_SAFE) with exponential backoff —
        # rides out a supervisor restart of a watchdog-killed daemon
        self.retries = int(retries)
        self.retry_backoff_s = float(retry_backoff_s)

    def _request(self, method, path, body=None, options=None):
        return self._decode(*self._exchange(method, path, body, options))

    @staticmethod
    def _decode(payload, ctype):
        if ctype.startswith("application/npz"):
            return {k: v for k, v in
                    np.load(io.BytesIO(payload), allow_pickle=False).items()}
        return json.loads(payload)

    def _exchange(self, method, path, body=None, options=None):
        """Send one request; returns the response's (bytes, content
        type)."""
        import urllib.error
        import urllib.request

        headers = {}
        if options:
            headers["X-Options"] = json.dumps(options)
        if body is not None:
            headers["Content-Type"] = "application/npz"
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(
            self.base_url + path, data=body, headers=headers, method=method)
        attempts = 1 + (self.retries if path in self._RETRY_SAFE else 0)
        for attempt in range(attempts):
            try:
                with urllib.request.urlopen(
                        req, timeout=self.timeout) as resp:
                    payload = resp.read()
                    ctype = resp.headers.get("Content-Type", "")
                break
            except urllib.error.HTTPError as exc:
                # the server answered: a real 4xx/5xx, never retried
                detail = exc.read().decode(errors="replace")
                try:
                    detail = json.loads(detail)["error"]
                except Exception:
                    pass
                raise RuntimeError(
                    f"{method} {path} → HTTP {exc.code}: {detail}"
                ) from None
            except OSError as exc:
                # no HTTP response (URLError wraps refused/reset/DNS).
                # A client-side read TIMEOUT is NOT retried: the
                # single-threaded server may still be working on the
                # original request, and a re-send would queue a
                # duplicate fit behind it exactly when it is slowest —
                # raise so the caller can lengthen `timeout` instead.
                reason = getattr(exc, "reason", exc)
                if isinstance(reason, TimeoutError):
                    raise
                if attempt + 1 >= attempts:
                    raise
                time.sleep(self.retry_backoff_s * (2 ** attempt))
        return payload, ctype

    def health(self):
        return self._request("GET", "/health")

    def wait_ready(self, timeout_s=120.0, poll_s=1.0):
        """Block until the server answers ``/health`` — e.g. right
        after a supervisor restarted a watchdog-killed daemon, or
        while a fresh one is still loading its demixer. Returns the
        health payload; raises ``TimeoutError`` if it never comes up.
        (An HTTP-level error — wrong token, bad route — raises
        immediately: the server is up, waiting won't fix it.)"""
        deadline = time.monotonic() + float(timeout_s)
        while True:
            try:
                return self.health()
            except OSError:
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"server at {self.base_url} not ready after "
                        f"{timeout_s:.0f}s")
                time.sleep(poll_s)

    def demix(self, psc, trace_wire=None, psc_wire=None,
              response_wire=None):
        """Demix on the server. ``psc_wire`` types the REQUEST body
        and ``response_wire`` ('f16'/'int8'/'int4'/'int4d2') the
        response — the demixed [K, T] block is 72 MB f32 at the
        flagship shape; int4 returns it at 1/16th (decoded to f32
        here, numpy-only)."""
        opts = self._options({"trace_wire": trace_wire} if trace_wire
                             else {}, response_wire=response_wire or None)
        out = self._request("POST", "/demix",
                            body=self._body(psc, None, False, psc_wire),
                            options=opts or None)
        if "demixed" in out:
            # 'f16'/'f32' response wires arrive as plain arrays on this
            # key — decode to f32 like the quantised wires (docstring
            # contract), so the return dtype never depends on the wire
            return np.asarray(out["demixed"], dtype=np.float32)
        dec = _decode_arrays({"psc" + k[len("demixed"):]: v
                              for k, v in out.items()})
        return np.asarray(dec["psc"])

    @staticmethod
    def _options(base, demix=None, return_fields=None, response_wire=None):
        """A request's X-Options: ``base`` and the serve-level levers
        that are set."""
        opts = dict(base)
        if demix is not None:
            opts["demix"] = bool(demix)
        if return_fields is not None:
            opts["return_fields"] = [str(f) for f in (
                [return_fields] if isinstance(return_fields, str)
                else return_fields)]
        if response_wire is not None:
            opts["response_wire"] = str(response_wire)
        return opts

    @staticmethod
    def _body(psc, stim, sparse_stim, psc_wire, stacked=False, **extra):
        """A request's npz body: traces ``psc`` typed by ``psc_wire``
        and design ``stim`` (None: traces only), in its sparse-hologram
        form when ``sparse_stim`` and the design is column-sparse.
        ``stacked``: [B, K, T] traces and [B, N, K] designs under the
        ``pscs``/``stims`` keys, the designs sparse as one [N, B*K]
        matrix (trial columns side by side stay column-sparse) plus the
        experiment count. ``extra``: arrays shipped as they are."""
        s = "s" if stacked else ""
        with span("cm.client.encode"):
            arrays = {"psc" + s + k[len("psc"):]: v
                      for k, v in _encode_psc(psc, psc_wire).items()}
            if stim is not None:
                stim = np.asarray(stim)
                flat = stim
                if stacked:
                    flat = (stim.transpose(1, 0, 2).reshape(stim.shape[1],
                                                            -1)
                            if stim.ndim == 3 else None)
                sparse = (encode_stim_sparse(flat)
                          if sparse_stim and flat is not None else None)
                if sparse is None:
                    arrays["stim" + s] = stim
                else:
                    arrays.update({"stim" + s + k[len("stim"):]: v
                                   for k, v in sparse.items()})
                    if stacked:
                        arrays["stims_sparse_b"] = np.int32(len(stim))
            arrays.update(extra)
            return _npz_bytes(**arrays)

    def fit(self, psc, stim, method="caviar", demix=None,
            sparse_stim=True, psc_wire=None, return_fields=None,
            response_wire=None, **fit_options):
        """Run a batch fit; returns the model state dict (numpy).

        ``return_fields`` trims the RESPONSE wire to the named state
        fields (plus ``fit_time_s``): the full posterior is dominated
        by [N, K]-sized arrays (``lam`` is 80 MB at the flagship
        shape), so callers that only need the [N]-sized summaries pass
        e.g. ``return_fields=("mu", "beta", "alpha")`` and cut the
        response ~2000×. A name the fit did not produce is a 400
        listing what is available. For full-posterior pulls,
        ``response_wire='int8'`` instead quarters ``lam`` on the wire
        (per-row peak codes, <=0.4%-of-peak step error on the [0, 1]
        spike posteriors; decoded back to f32 here).

        ``psc``: [K, T] traces (raw if the server demixes, demixed
        otherwise); ``stim``: [N, K] design; ``fit_options`` as in
        ``Model.fit`` (JSON-safe knobs only).

        ``sparse_stim`` (default on) ships the design in the exact
        sparse-hologram wire form — ~200× fewer stim bytes at mapping
        shapes, bit-identical fit — falling back to dense automatically
        when the matrix is not column-sparse. ``psc_wire`` types the
        trace payload: None ships the caller's dtype, 'f32'/'f16' cast
        (2×/4× smaller than f64), 'int8'/'int4'/'int4d2' quantise with
        the device wires' per-trace peak scales (8×/16×/32× smaller
        than f32; the server ships matching int4 bodies to the device in
        their wire form with no host recode — 'int4d2' additionally
        mean-pools 2× exactly like the *_int4d2qat.npz train-time
        transform, so pair it with that server demixer)."""
        opts = self._options({"method": method, **fit_options}, demix,
                             return_fields, response_wire)
        response = self._exchange("POST", "/fit",
                                  body=self._body(psc, stim, sparse_stim,
                                                  psc_wire),
                                  options=opts)
        with span("cm.client.decode"):
            out = self._decode(*response)
            if "lam_q8" in out:
                out["lam"] = (out.pop("lam_q8").astype(np.float32)
                              * out.pop("lam_q8_scale")[..., None])
        return out

    def fit_many(self, pscs, stims, demix=None, sparse_stim=True,
                 psc_wire=None, return_fields=None, **fit_options):
        """Fit B same-shape experiments in one request
        (``solvers.caviar_many`` on the server — the job-array
        workload through one warm executable). ``pscs``: [B, K, T];
        ``stims``: [B, N, K]. An ARRAY input returns a dict of stacked
        arrays (``mu`` [B, N], ``lam`` [B, N, K], ...); a LIST input
        always returns a list of B per-experiment dicts — same-shape
        or ragged, so the return type never depends on whether trial
        counts happen to coincide. Wire levers as in ``fit`` — the
        batched design ships as one sparse [N, B*K] hologram matrix
        when column-sparse.

        ``method=`` (a fit option) picks the batched solver:
        'caviar' (default) | 'cavi_sns' | 'mbcs'
        (``sns_many``/``mbcs_many`` on the server).

        RAGGED batches — a list of [K_b, T] trace blocks with
        DIFFERENT trial counts and a matching list of [N, K_b] stims —
        ship as one concatenated single-experiment-wire body (no
        padding bytes on the wire) plus ``k_trues``; the server fits
        them through caviar_many's traced-k_true path ('caviar') or
        per-experiment true-shape sequential fits ('cavi_sns'/'mbcs').
        The return is then a LIST of per-experiment dicts at each
        experiment's true width (mirroring the library's ragged
        ``*_many`` contract) — this client advertises the response-
        metadata capability (``wire_meta``), so the server names every
        padded field and ALL of them come back at true shape.
        ``return_fields`` trims the response as in ``fit``."""
        opts = self._options(fit_options, demix, return_fields)
        # a LIST input always returns a list of per-experiment dicts
        # (never silently flips to the stacked dict the day two folds
        # happen to record the same trial count); an array input
        # returns the stacked dict
        as_list = isinstance(pscs, (list, tuple)) and len(pscs) > 0
        if as_list:
            ks = [int(np.shape(p)[0]) for p in pscs]
            if len(set(ks)) > 1:
                return self._fit_many_ragged(pscs, stims, ks, sparse_stim,
                                             psc_wire, opts)
        out = self._request("POST", "/fit_many",
                            body=self._body(np.asarray(pscs), stims,
                                            sparse_stim, psc_wire,
                                            stacked=True),
                            options=opts)
        if as_list:
            return [{key: val[b] for key, val in out.items()}
                    for b in range(len(pscs))]
        return out

    def _fit_many_ragged(self, pscs, stims, ks, sparse_stim, psc_wire,
                         opts):
        if not isinstance(stims, (list, tuple)) or len(stims) != len(
                pscs):
            raise ValueError(
                f"ragged pscs ({len(pscs)} experiments) needs a matching "
                "list of per-experiment [N, K_b] stims")
        for b, (p, s) in enumerate(zip(pscs, stims)):
            if np.shape(s)[-1] != ks[b]:
                raise ValueError(
                    f"experiment {b}: stim carries {np.shape(s)[-1]} "
                    f"trials but traces {ks[b]}")
        body = self._body(
            np.concatenate([np.asarray(p) for p in pscs], axis=0),
            np.concatenate([np.asarray(s) for s in stims], axis=1),
            sparse_stim, psc_wire, k_trues=np.asarray(ks, np.int32))
        # capability signal: this client understands the response
        # metadata arrays — servers only emit them when asked, so a
        # pre-metadata client's every-key iteration keeps working
        try:
            out = self._request("POST", "/fit_many", body=body,
                                options={**opts, "wire_meta": 1})
        except RuntimeError as exc:
            # the REVERSE skew: a pre-capability server rejects the
            # signal itself as an unknown option (the fit never ran —
            # a replay is safe). Resend without it and fall back to
            # the legacy lam/z slicing below
            if "wire_meta" not in str(exc):
                raise
            out = self._request("POST", "/fit_many", body=body,
                                options=opts)
        out.pop("k_trues", None)  # we know the true widths we sent
        # the server names every trial-axis field it padded (lam, z,
        # and e.g. mbcs' per-trial shape/rate) — slice those back to
        # true widths on their last axis
        kf = out.pop("_k_fields", None)
        k_fields = ({str(k) for k in kf} if kf is not None
                    else {"lam", "z"})  # pre-_k_fields servers
        # ... and every non-trial field it max-padded (e.g. mbcs
        # receptive_fields [N, P_b] over different level tables),
        # echoed with per-experiment true extents — slice those back
        # to true shape on every axis
        sf = out.pop("_shape_fields", None)
        shapes = {}
        for key in ([] if sf is None else sf):
            key = str(key)
            shapes[key] = np.asarray(out.pop(f"_shapes_{key}"))
        results = []
        for b, kb in enumerate(ks):
            d = {}
            for key, val in out.items():
                v = val[b]
                if key in k_fields:
                    v = v[..., :kb]
                elif key in shapes:
                    v = v[tuple(map(slice, shapes[key][b]))]
                d[key] = v
            results.append(d)
        return results

    def profile_start(self, dir=None):
        """Begin a profiler trace on the server; every subsequent
        request records into it until ``profile_stop()``. Returns
        {'profiling': True, 'dir': <trace dir on the server>}."""
        opts = {"action": "start"}
        if dir:
            opts["dir"] = str(dir)
        return self._request("POST", "/profile", options=opts)

    def profile_stop(self):
        return self._request("POST", "/profile",
                             options={"action": "stop"})

    def warm(self, shapes, iters=50, **options):
        shapes = [list(map(int, s)) for s in
                  (shapes if isinstance(shapes[0], (list, tuple))
                   else [shapes])]
        return self._request(
            "POST", "/warm",
            options={"shapes": shapes, "iters": iters, **options})

    @staticmethod
    def _quote(name):
        from urllib.parse import quote

        return quote(str(name), safe="")

    def stream_update(self, name, psc, stim, iters=10, create=None,
                      sparse_stim=True, psc_wire=None, **options):
        opts = {"iters": iters, **options}
        if create:
            opts["create"] = create
        return self._request("POST", f"/stream/{self._quote(name)}/update",
                             body=self._body(psc, stim, sparse_stim,
                                             psc_wire),
                             options=opts)

    def stream_posterior(self, name):
        return self._request("GET", f"/stream/{self._quote(name)}/posterior")

    def stream_result(self, name, fn_scan=True):
        return self._request("GET", f"/stream/{self._quote(name)}/result",
                             options={"fn_scan": fn_scan})

    def stream_delete(self, name):
        return self._request("DELETE", f"/stream/{self._quote(name)}")

    def stream_design(self, name, trials=None, designer=None):
        """Next stimulus design for a closed-loop stream. First call
        passes ``designer={"N":..., "H":..., "powers":[...]}`` (works
        before the stream exists — round 0 needs no posterior); later
        calls just ``trials``. Returns {'stim': [N, trials], 'pool':
        unresolved indices, 'resolved': bool, 'rounds': int} — no
        'stim' key once resolved (the experiment is complete)."""
        opts = {}
        if trials is not None:
            opts["trials"] = int(trials)
        if designer:
            opts["designer"] = designer
        return self._request("POST", f"/stream/{self._quote(name)}/design",
                             options=opts)

    def stream_save(self, name):
        return self._request("POST", f"/stream/{self._quote(name)}/save")

    def stream_load(self, name, create=None):
        """Restore a checkpointed stream on the server (same create
        options as the original run — they are solver configuration,
        not state)."""
        opts = {"create": create} if create else None
        return self._request("POST", f"/stream/{self._quote(name)}/load",
                             options=opts)

    def shutdown(self):
        return self._request("POST", "/shutdown")
