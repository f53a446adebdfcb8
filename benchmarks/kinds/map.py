"""The ``map`` kind of request: raw traces and a stim matrix to a
posterior map, in a closed loop of one client (the next request goes
when the last answer is on the host).

A mix of this kind (``traffic/<mix>.json``) says whether a request
starts from raw traces (``demix``: the demixer on the configuration's
wire, then the fit) or from the traces demixed once in set-up and left
on the device (the fit alone), and whether it goes to a ``FitService``
(``"via": "http"``) that the run starts on a thread of its own process
(``127.0.0.1``, port 0, its request log in ``$TMPDIR``) through one
``FitClient``. Every request is the same work from one run to the next
and from one seed to another: only the values of the data change.

How ``correct`` is decided: the program's answers from the window
against the plain reference (``cmbench/reference.py``) at the timed
sizes. The numbers read (a cell's ``limits/<cell>.json`` names those
compared):

* ``demix_gap``: the widest gap of the demixed traces over the
  reference's largest magnitude;
* ``phi_med_gap``, ``lam_med_gap``, ``mu_med_gap``: for each neuron the
  reference connects, its widest gap in the power curve, the spike
  posteriors (absolute, since they lie in [0, 1]) and the weight (over
  the reference's largest magnitude); the number is the median over
  those neurons;
* the widest gap of each field over all neurons (``mu_gap``,
  ``phi_gap``, ...), which ``control.py`` reports beside them.

A widest gap over the neurons is not compared: on some seeds CAVIaR
settles one trial's event on another of the trial's stimulated neurons
in float32 than in float64, a mode of the same fit that float32 rounding
picks (the control does it too). It moves those two neurons' posteriors
by a whole event, and through the noise and the joint weight solve the
other neurons' weights and spike posteriors by as much as the control
moves its own; their power curves move much less.

The small fields are compared on every answer of the window, the spike
posteriors and the demixed traces on the answers sampled from the seed.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import torch

from cmbench import check, datagen
from cmbench import reference as R

# the fields kept only for the answers sampled from the seed
BIG = ("lam", "dem", "z")


def fit_options(cfg):
    """The keywords of ``Model.fit``'s ``fit_options`` and of the
    served fit: the configuration's solver options and its powers."""
    fit = dict(cfg["fit"])
    fit.pop("method")
    return dict(fit, powers=[float(p) for p in cfg["powers"]],
                verbose=False)


def make_data(cfg, seed, device, root):
    """The experiment, made on ``device`` from the seed, handed over as
    host float64 traces and stim, as a rig's acquisition."""
    d = datagen.make_experiment(cfg, seed, device)
    psc = d["psc"].cpu().numpy()
    return {"psc_f32": psc, "psc_host": psc.astype("float64"),
            "stim_host": d["stim"].cpu().numpy().astype("float64"),
            "stim": d["stim"], "weights": d["weights"], "root": root}


def _served(traffic):
    return traffic.get("via") == "http"


class Driver:
    """Drives the program (``circuitmap_torch``) with one mix's requests."""

    def __init__(self, cfg, traffic, data, device, root, setup):
        from circuitmap_torch import Model
        from circuitmap_torch.demix.demixer import NeuralDemixer

        self.device = device
        self.Model = Model
        self.N = cfg["N"]
        self.opts = fit_options(cfg)
        self.method = cfg["fit"]["method"]
        self.wire = cfg["trace_wire"]
        self.psc, self.stim = data["psc_host"], data["stim_host"]
        self.demix = bool(traffic["demix"])
        self.ckpt = os.path.join(root, cfg["demixer"])
        self.server = None
        t0 = time.perf_counter()
        if _served(traffic):
            self._start_server(root, setup)
        else:
            self.demixer = NeuralDemixer(self.ckpt, device=device)
            setup["demixer_s"] = time.perf_counter() - t0
            if not self.demix:  # demixed once, resident on the device
                t0 = time.perf_counter()
                self.dem = self.demixer(self.psc, keep_on_device=True,
                                        transfer_dtype=self.wire,
                                        verbose=False)
                setup["demix_once_s"] = time.perf_counter() - t0

    def _start_server(self, root, setup):
        from http.server import HTTPServer

        from circuitmap_torch.serve import FitClient, FitService, _make_handler

        t0 = time.perf_counter()
        service = FitService(demixer_path=self.ckpt, device=self.device)
        setup["demixer_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        log_dir = os.environ.get("TMPDIR") or os.path.join(root, ".benchtmp")
        os.makedirs(log_dir, exist_ok=True)
        self.log_path = os.path.join(log_dir, f"serve_metrics_{os.getpid()}"
                                     ".jsonl")
        service.metrics_fh = open(self.log_path, "w")
        box = [None]
        httpd = HTTPServer(("127.0.0.1", 0), _make_handler(service, box))
        box[0] = httpd
        self.thread = threading.Thread(target=httpd.serve_forever,
                                       kwargs={"poll_interval": 0.05},
                                       daemon=True)
        self.thread.start()
        self.server, self.service = httpd, service
        self.client = FitClient(f"http://127.0.0.1:{httpd.server_address[1]}",
                                timeout=600.0)
        self.client.health()
        setup["bind_s"] = time.perf_counter() - t0

    def request(self, spans):
        """One map; returns its outputs (host arrays, and the demixed
        traces as a device tensor where the request demixed them)."""
        if self.server is not None:  # its layers are the server's own log
            return self.client.fit(self.psc, self.stim, method=self.method,
                                   psc_wire=self.wire, **self.opts)
        if self.demix:
            spans.mark("demix")
            dem = self.demixer(self.psc, keep_on_device=True,
                               transfer_dtype=self.wire, verbose=False)
            spans.mark("demix.end")
        else:
            dem = self.dem
        spans.mark("fit")
        model = self.Model(self.N).fit(dem, self.stim, method=self.method,
                                       fit_options=dict(self.opts),
                                       device=self.device)
        spans.mark("fit.end")
        out = dict(model.state)
        if self.demix:
            out["dem"] = dem
        return out

    def counters(self):
        """The program's kernel-launch counters."""
        from circuitmap_torch.ops.laplace_cuda import laplace_from_stats
        from circuitmap_torch.ops.sweep_cuda import sweep_spikes_blocked

        return {"sweep_blocked": sweep_spikes_blocked.launches,
                "laplace": laplace_from_stats.launches}

    def request_log(self):
        """The server's request log of the ``/fit`` requests, one dict a
        request in order, or None where no server runs."""
        if self.server is None:
            return None
        with open(self.log_path) as fh:
            rows = [json.loads(line) for line in fh if line.strip()]
        return [r for r in rows if r["path"] == "/fit"]

    def close(self):
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self.thread.join(timeout=30)
            self.service.metrics_fh.close()
            self.server = None
        self.__dict__.pop("dem", None)
        self.__dict__.pop("demixer", None)
        self.__dict__.pop("service", None)


def end_to_end(traffic, window_s, answered, latencies):
    """Seconds per map over the window: ``served_map_s`` at the client of
    a served mix, ``map_s`` otherwise."""
    name = "served_map_s" if _served(traffic) else "map_s"
    return {name: window_s / max(answered, 1)}


# ---------------------------------------------------------------------------
# The reference and the compared numbers
# ---------------------------------------------------------------------------


def reference_inputs(cfg, data, dtype, device):
    """The reference's demixed traces, charges and active-trial mask of
    the whole experiment, worked out from the raw traces."""
    if cfg["trace_wire"] != "int4d2":
        raise ValueError("the reference implements the int4d2 wire only")
    codes, step = R.int4d2_codes(data["psc_f32"])
    traces = R.int4d2_decode(codes, step, cfg["T"], dtype, device)
    w = R.load_unet(os.path.join(data["root"], cfg["demixer"]), dtype,
                    device)
    dem = R.demix(w, traces)
    y, mask = R.charges(dem, cfg["fit"]["y_xcorr_thresh"])
    return dem, y, mask


def reference_map(cfg, data, dtype, device, inputs=None):
    """(demixed traces, posterior) of one batch map; ``inputs``: the
    demixed traces, charges and mask when already worked out."""
    dem, y, mask = inputs or reference_inputs(cfg, data, dtype, device)
    post = R.caviar(y.to(dtype), data["stim"].to(device), mask.to(dtype),
                    cfg["powers"], cfg["fit"], dtype, device)
    return dem, post


def reference(cfg, traffic, data, device):
    """The float64 reference's (demixed traces, posterior)."""
    with R.precision(False):
        return reference_map(cfg, data, torch.float64, device)


def _host(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return np.asarray(a, np.float64)


def median_gaps(out, post):
    """The medians, over the neurons the reference connects, of each
    neuron's widest gap in ``mu`` and ``phi`` (over the reference's
    largest magnitude) and, where ``out`` holds them, in ``lam``
    (absolute)."""
    mu, mu_ref = _host(out["mu"]), _host(post["mu"])
    if mu.shape != mu_ref.shape or np.isnan(mu).any():
        return {k: float("inf")
                for k in ("mu_med_gap", "phi_med_gap", "lam_med_gap")}
    on = mu_ref != 0
    if not on.any():
        on[:] = True
    phi, phi_ref = _host(out["phi"]), _host(post["phi"])
    nums = {
        "mu_med_gap": check.median(np.abs(mu - mu_ref)[on])
        / max(float(np.max(np.abs(mu_ref))), 1e-300),
        "phi_med_gap": check.median(np.max(np.abs(phi - phi_ref), 1)[on])
        / max(float(np.max(np.abs(phi_ref))), 1e-300),
    }
    if "lam" in out:
        d = _host(out["lam"]) - _host(post["lam"])
        nums["lam_med_gap"] = check.median(np.max(np.abs(d), 1)[on])
    return nums


WIDEST = ("mu", "beta", "rate", "phi")


def numbers(cfg, traffic, ref, small, sampled):
    """Every number the check can read from the kept answers (see the
    module docstring)."""
    ref_dem, post = ref
    nums = {}
    for out in (*small, *sampled):
        for k, v in median_gaps(out, post).items():
            nums[k] = max(nums.get(k, 0.0), v)
    for f in WIDEST:
        nums[f"{f}_gap"] = max(check.gap(o[f], post[f]) for o in small)
    nums["lam_gap"] = max(check.gap(o["lam"], post["lam"], absolute=True)
                          for o in sampled)
    if traffic["demix"] and not _served(traffic):
        nums["demix_gap"] = max(check.gap(o["dem"], ref_dem)
                                for o in sampled)
    return nums


def control(cfg, traffic, data, device):
    """The control's answers, as (every answer, the sampled answers): the
    reference in float32 with TF32 products and convolutions in the
    program's place. Where the window fits traces demixed in set-up, the
    control fits the float64 reference's demixed traces: only the fit is
    in its place."""
    inputs = None
    if not traffic["demix"]:
        with R.precision(False):
            inputs = reference_inputs(cfg, data, torch.float64, device)
    with R.precision(True):
        dem, post = reference_map(cfg, data, torch.float32, device, inputs)
    out = dict(post, dem=dem)
    return [out], [out]
