"""NeuralDemixer: load, train and apply the waveform demixer.

Port of ``circuitmap_tpu/demix/demixer.py``. Inference: per-trace peak
normalisation, the U-Net forward, the rescale and the monotone-decay
filter, over chunks of the trace block. The upload is a choice of wires
— f32, f16, int8 (per-trace peak/127 codes), int4 (two peak/7 codes per
byte) and int4d2 (2x mean-pool, then int4) — encoded on the host and
unpacked, scaled and (d2) upsampled on the device; ``wire_transform`` is
the host reference of what a wire delivers, with which a
quantisation-aware fine-tune corrupts its inputs.

Training: ``generate_training_data`` (host numpy, ``demix/datagen.py``)
and ``train``, SGD on the mean squared error with the JAX package's
batches (``np.random.default_rng(seed).permutation`` an epoch) and its
per-epoch history. The training set is uploaded once and each step's
batch gathered on the device; BatchNorm runs in train mode and keeps
its running averages (momentum 0.1). ``train(mesh=)`` is data-parallel:
the batch splits over the mesh's shards, the weights are replicated, and
BatchNorm normalises with the global batch's statistics, so a step
equals the one-device step up to the order of its sums. Inference and
training share one ``nn.Module``: ``__call__`` puts it in eval mode,
``train`` in train mode. Convolutions run with cuDNN's TF32 off in both.
"""

from __future__ import annotations

import contextlib
import copy
import time

import numpy as np
import torch

from .._device import highest_matmul, resolve_device, torch_dtype
from ..ops.monotone import monotone_decay_filter
from ..solvers._common import prepare_traces
from ..utils.profiling import span
from ..utils.quant import PackedInt4Traces, _pool2, _upsample2
from . import convert
from .datagen import generate_psc_dataset
from .unet import NWDUNet, forward_shards, init_nwd_params


def resolve_transfer_dtype(token):
    """A user-facing wire token as ``__call__``'s ``transfer_dtype``:
    'f32'/''/None -> None, 'f16' -> np.float16, 'int8' -> np.int8,
    'int4'/'int4d2' pass through. Raises ValueError on anything else."""
    if token is None or isinstance(token, type) or hasattr(token, "itemsize"):
        return token
    tok = str(token).lower()
    if tok in ("", "f32", "float32"):
        return None
    if tok in ("f16", "float16"):
        return np.float16
    if tok == "int8":
        return np.int8
    if tok in ("int4", "int4d2"):
        return tok
    raise ValueError(
        f"unknown trace wire {token!r}; expected f32/f16/int8/int4/int4d2")


_WIRES = {np.dtype(np.float32): None, np.dtype(np.float16): "f16",
          np.dtype(np.int8): "int8"}


def _wire_name(transfer_dtype):
    """``transfer_dtype`` as a ``prepare_traces`` wire name."""
    wire = resolve_transfer_dtype(transfer_dtype)
    if wire is None or isinstance(wire, str):
        return wire
    try:
        return _WIRES[np.dtype(wire)]
    except KeyError:
        raise ValueError(
            f"unknown trace wire {transfer_dtype!r}; expected "
            "f32/f16/int8/int4/int4d2") from None


def wire_transform(traces, bits=4, decimate=1):
    """Host reference of the quantised trace wire: what the device
    reconstructs from a ``transfer_dtype`` upload, as float32 traces.

    ``decimate=2`` is the int4d2 wire: mean-pool by 2 (an odd tail keeps
    the raw last sample), quantise the pooled trace with a per-trace
    peak/(2^{bits-1}-1) scale, then upsample back linearly (even sample
    ``0.75*p[i] + 0.25*p[i-1]``, odd ``0.75*p[i] + 0.25*p[i+1]``,
    clamped edges), the device's own interpolation.
    """
    x = np.asarray(traces, dtype=np.float32)
    T = x.shape[-1]
    if decimate not in (1, 2):
        raise ValueError(f"decimate must be 1 or 2, got {decimate!r}")
    p = _pool2(x) if decimate == 2 else x
    qmax = 2 ** (bits - 1) - 1
    peak = np.abs(p).max(axis=-1, keepdims=True)
    scale = np.where(peak > 0, peak / qmax, 1.0).astype(np.float32)
    q = (np.clip(np.rint(p / scale), -qmax, qmax).astype(np.float32)
         * scale)
    if decimate == 1:
        return q
    return np.ascontiguousarray(_upsample2(q, T), dtype=np.float32)


def _global_batch_norm(mesh, nets, name, hs):
    """Train-mode BatchNorm of block ``name`` over the mesh's global
    batch: every shard is normalised with the mean and the biased
    variance of all the shards' activations ``hs`` [b, C, L] (two psums:
    the mean, then the centred sum of squares), and each replica's
    running statistics take the global mean and unbiased variance, as
    ``nn.BatchNorm1d`` does for one batch. Differentiable: ``psum`` is
    ``.to()`` and ``+``."""
    n = sum(h.shape[0] for h in hs) * hs[0].shape[2]
    mean = [m / n for m in mesh.psum([h.sum(dim=(0, 2)) for h in hs])]
    cent = [h - m[None, :, None] for h, m in zip(hs, mean)]
    var = [v / n for v in mesh.psum([torch.square(c).sum(dim=(0, 2))
                                     for c in cent])]
    bns = [getattr(net, name).bn for net in nets]

    def update(bn, m, v):
        with torch.no_grad():
            bn.running_mean.mul_(1 - bn.momentum).add_(bn.momentum * m)
            bn.running_var.mul_(1 - bn.momentum).add_(
                bn.momentum * v * n / max(n - 1, 1))
            bn.num_batches_tracked.add_(1)

    mesh.rep(update, bns, mean, var)  # once per replica
    return [c * torch.rsqrt(v + bn.eps)[None, :, None]
            * bn.weight[None, :, None] + bn.bias[None, :, None]
            for c, v, bn in zip(cent, var, bns)]


def _sum_grads(replicas):
    """Give every replica the sum of the replicas' gradients (added on
    the first replica's device, in replica order)."""
    for params in zip(*(r.parameters() for r in replicas)):
        total = params[0].grad
        for q in params[1:]:
            total = total + q.grad.to(total.device)
        for q in params:
            q.grad = total.to(q.device)


def mesh_compatible(mesh):
    """True iff ``NeuralDemixer.__call__(mesh=mesh)`` can shard rows: a
    power-of-two shard count up to 1024, the JAX package's rule (there
    every row buffer pads to a power-of-two bucket that the mesh must
    divide). The fit server asks this before it demixes over its
    mesh."""
    if mesh is None:
        return False
    n = int(mesh.size)
    return 0 < n <= 1024 and (n & (n - 1)) == 0


class NeuralDemixer:
    """Load (or train) a demixer and apply it to PSC trace blocks on
    ``device``.

    ``path``: a checkpoint, the in-repo ``.npz`` format or a Lightning
    ``.ckpt``/``.pt``/``.pth``; ``params``: a JAX-layout parameter pytree
    (``circuitmap_tpu`` params); neither: a fresh network drawn from
    ``seed`` by the JAX package's initialisation rule
    (``unet.init_nwd_params``). ``device=None`` means CUDA (package
    rule).
    """

    def __init__(self, path=None, params=None, eval_mode=True, device=None,
                 seed=0, dtype=torch.float32, compute_dtype=None):
        del eval_mode  # __call__ and train set the module's mode
        self.device = resolve_device(device)
        net = NWDUNet()
        if params is not None:
            net.load_state_dict(convert.params_from_jax(params))
        elif path is not None:
            net.load_state_dict(convert.load_params(path))
        else:
            net.load_state_dict(init_nwd_params(
                torch.Generator().manual_seed(int(seed))))
        dtype = torch_dtype(dtype if compute_dtype is None else compute_dtype)
        self.net = net.to(device=self.device, dtype=dtype).eval()
        self._mesh_nets = None  # (mesh, weights' versions, {device: net})
        self.training_data = None
        self.test_data = None

    def _precision(self, deterministic=False, devices=None):
        # the JAX head runs at HIGHEST precision; cuDNN would run a
        # float32 convolution in TF32 by default. ``deterministic``
        # (inference; training when the caller sets
        # ``torch.backends.cudnn.deterministic``, since it slows the
        # step) takes cuDNN's deterministic algorithms only: the
        # transposed convolutions' default one sums with atomics, and
        # two demixes of one block then differ in the last bits.
        # ``devices``: where the network runs (a mesh's), else its own
        # device
        if any(d.type == "cuda" for d in devices or (self.device,)):
            return torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                              deterministic=deterministic)
        return contextlib.nullcontext()

    def _demix_batch(self, traces, net=None):
        """Peak-normalise -> forward -> rescale (the monotone filter is
        the caller's). traces: [B, T] f32; ``net``: the network copy on
        the traces' device (the module's own by default)."""
        net = self.net if net is None else net
        tmax = torch.max(traces, dim=1, keepdim=True).values
        safe = torch.where(tmax != 0, tmax, torch.ones_like(tmax))
        net_dtype = next(net.parameters()).dtype
        x = (traces / safe)[:, None, :].to(net_dtype)
        return net(x)[:, 0, :].float() * tmax

    def _nets(self, mesh):
        """The network on each of the mesh's devices: the module itself
        on its own device, copies elsewhere. The copies are cached on
        the mesh (by equality) and on the weights' in-place versions, so
        training invalidates them."""
        import copy

        versions = tuple(p._version for p in self.net.parameters())
        cached = self._mesh_nets
        if cached is not None and cached[0] == mesh and \
                cached[1] == versions:
            return cached[2]
        nets = {d: self.net if d == self.device else
                copy.deepcopy(self.net).to(d).eval() for d in mesh.distinct}
        self._mesh_nets = (mesh, versions, nets)
        return nets

    @span("cm.demix")
    def __call__(self, traces, monotone_filter_start=500,
                 monotone_filter_inplace=True, verbose=True,
                 keep_on_device=False, chunk_size=4096,
                 transfer_dtype=None, mesh=None):
        """Demix a [K, T] (or [T]) trace block. Returns numpy, or the
        device tensor with ``keep_on_device=True`` (to feed a solver
        without a round trip through host memory).

        A ``PackedInt4Traces`` block (an int4 or int4d2 body as the fit
        server receives it) is not decoded on the host: each chunk's
        codes go up as they are and are unpacked on the device, which is
        what the matching ``transfer_dtype`` makes of the dense traces.
        Only "int4d2" asked of codes that were not pooled densifies and
        encodes again.

        ``mesh`` (a ``parallel.TrialMesh`` of this process that
        :func:`mesh_compatible` accepts) splits each chunk's rows over
        the mesh's shards, each demixed on its shard's device (rows are
        independent: the network runs in eval mode); the output is
        gathered on the mesh's first device."""
        del monotone_filter_inplace  # functional; kept for API parity
        nets, home = None, self.device
        if mesh is not None:
            from ..parallel.sharded import _require_local

            _require_local(mesh, "NeuralDemixer(mesh=)")
            if not mesh_compatible(mesh):
                raise ValueError(
                    f"mesh size {mesh.size} does not divide the demixer's "
                    "row buckets; use a power-of-two mesh (<= 1024 "
                    "devices)")
            nets, home = self._nets(mesh), mesh.devices[0]
        wire = _wire_name(transfer_dtype)
        if isinstance(traces, PackedInt4Traces):
            traces = traces.flat()
            if wire == "int4d2" and traces.decimate == 1:
                traces = traces.dense()
        squeeze = False
        if not isinstance(traces, PackedInt4Traces):
            traces = np.asarray(traces)
            squeeze = traces.ndim == 1
            if squeeze:
                traces = traces[None]
        K = traces.shape[0]
        self.net.eval()

        t0 = time.time()
        chunks = []
        with torch.inference_mode(), self._precision(deterministic=True):
            for k0 in range(0, K, chunk_size):
                k1 = min(K, k0 + chunk_size)
                if nets is None:
                    spans = [(k0, k1, self.device)]
                else:  # contiguous rows per shard, on its device
                    edges = [k0 + (k1 - k0) * s // mesh.n_local
                             for s in range(mesh.n_local + 1)]
                    spans = [(a, b, d) for a, b, d in zip(
                        edges[:-1], edges[1:], mesh.devices) if b > a]
                outs = []
                for a, b, dev in spans:
                    # encoded on the host, decoded (and upsampled) on
                    # the device
                    rows = (traces.rows(a, b)
                            if isinstance(traces, PackedInt4Traces)
                            else traces[a:b])
                    part = prepare_traces(rows, torch.float32, dev,
                                          trace_wire=wire)
                    with span("cm.demix.net"):
                        out = self._demix_batch(
                            part, None if nets is None else nets[dev])
                        out = monotone_decay_filter(
                            out, start=int(monotone_filter_start))
                    outs.append(out.to(home))
                chunks.append(outs[0] if len(outs) == 1 else
                              torch.cat(outs, dim=0))
        dev = chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=0)
        if verbose:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            print(f"Demixed {K} traces in {time.time() - t0:.3f}s.")
        out = dev if keep_on_device else dev.cpu().numpy()
        return out[0] if squeeze else out

    # -- training ----------------------------------------------------------

    def generate_training_data(self, save_path=None, **kwargs):
        """Simulate (inputs, targets) pairs on the host
        (``datagen.generate_psc_dataset``'s keywords); optionally saved
        to ``save_path`` in the JAX package's ``.npz`` layout."""
        self.training_data, self.test_data = generate_psc_dataset(**kwargs)
        if save_path is not None:
            np.savez(
                save_path,
                training_inputs=self.training_data[0],
                training_targets=self.training_data[1],
                test_inputs=self.test_data[0],
                test_targets=self.test_data[1],
            )
        return self.training_data, self.test_data

    def _loss(self, x, y, net=None):
        """Mean squared error of ``net`` (the module's own by default) on
        inputs x [B, T] against targets y [B, T], in its current mode."""
        net = self.net if net is None else net
        return torch.mean(torch.square(net(x[:, None, :])[:, 0, :] - y))

    def _mesh_loss(self, parts, shares, nets, x, y):
        """The mean squared error over a global batch x, y [B, T] (on the
        mesh's first device), split once per distinct device of the mesh
        (``parts``: a mesh of one shard per device): a device that holds
        ``shares[j]`` of the mesh's shards takes that many shards' rows,
        joined, and runs them through its replica ``nets[j]`` in train
        mode with the global batch's BatchNorm statistics. Shards on one
        device so share one forward."""
        rows = x.shape[0] // sum(shares)

        def split(a):
            return [c.to(d) for c, d in zip(
                torch.split(a, [rows * s for s in shares]), parts.devices)]

        outs = forward_shards(
            nets, [a[:, None, :] for a in split(x)],
            lambda name, hs: _global_batch_norm(parts, nets, name, hs))
        sq = [torch.sum(torch.square(o[:, 0, :] - b))
              for o, b in zip(outs, split(y))]
        return parts.psum(sq)[0] / y.numel()

    def _val_loss(self, x, y, chunk=4096, net=None):
        """Eval-mode MSE over a test set x, y [n, T] on the device, in
        chunks (BatchNorm reads its running statistics, so chunks do not
        change the value beyond the order of the sum) by ``net`` (the
        module's own by default); its mode is restored."""
        if x.shape[0] == 0:
            return 0.0
        net = self.net if net is None else net
        was_training = net.training
        net.eval()
        with torch.no_grad(), self._precision(deterministic=True,
                                              devices=(x.device,)):
            total = sum(torch.sum(torch.square(
                net(x[i:i + chunk, None, :])[:, 0, :] - y[i:i + chunk]))
                for i in range(0, x.shape[0], chunk))
        net.train(was_training)
        return float(total) / y.numel()

    def train(self, epochs=1000, batch_size=64, learning_rate=1e-2,
              data_path=None, save_every=50, save_path=None, seed=0,
              verbose=True, mesh=None, **_compat):
        """SGD on the mean squared error (the reference trainer's
        optimiser and loss), the JAX package's ``train`` on ``device``.

        Each epoch takes ``np.random.default_rng(seed)``'s next
        permutation of the training pairs in ``n // batch_size`` batches
        (the remainder dropped). The pairs (``generate_training_data``'s,
        or ``data_path``'s ``.npz``) are uploaded once as float32 and
        each batch gathered on the device. Returns the history, one
        ``{"epoch", "train_loss", "val_loss"}`` a epoch: the mean of the
        epoch's step losses and the eval-mode loss on the test set
        afterwards. With ``save_path`` the weights are written (in-repo
        ``.npz``) every ``save_every`` epochs and at the end.

        ``mesh`` (a ``parallel.TrialMesh`` of this process; its shards
        may share a device): data-parallel training. The pairs go to the
        mesh's first device; each batch splits along the batch axis over
        the shards (it must divide over them), and the shards on one
        device run their rows joined, as one forward (a mesh on one
        device so runs the one-device step). The weights are
        replicated once per device (this module's own network where the
        mesh holds its device), BatchNorm normalises with the global
        batch's statistics and the loss is the global batch's mean, so a
        step equals the one-device step up to the order of its sums.
        Replicas on distinct devices add their gradients before each
        step and so step alike; this module's network ends with the
        first shard's weights.

        With ``torch.backends.cudnn.deterministic`` set, training on the
        card repeats bit for bit (cuDNN's deterministic algorithms; the
        U-Net's resize then trains as a product, with no atomics).
        """
        if data_path is not None:
            data = np.load(data_path)
            train = (data["training_inputs"], data["training_targets"])
            test = (data["test_inputs"], data["test_targets"])
        else:
            if self.training_data is None:
                raise RuntimeError(
                    "no training data: call generate_training_data() or "
                    "pass data_path")
            train, test = self.training_data, self.test_data
        n = len(train[0])
        batch_size = min(batch_size, n)  # datasets smaller than one batch
        if mesh is None:
            home, nets = self.device, [self.net]
        else:
            from ..parallel.mesh import TrialMesh
            from ..parallel.sharded import _require_local

            _require_local(mesh, "NeuralDemixer.train(mesh=)")
            if batch_size % mesh.size:
                raise ValueError(
                    f"effective batch_size={batch_size} (dataset n={n}) "
                    f"must divide over the {mesh.size}-device mesh")
            home = mesh.devices[0]
            parts = TrialMesh(mesh.distinct)  # one batch part per device
            shares = [mesh.devices.count(d) for d in mesh.distinct]
            nets = [self.net if d == self.device else
                    copy.deepcopy(self.net).to(d) for d in mesh.distinct]

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(
                a, dtype=np.float32)).to(home)

        dtype = next(self.net.parameters()).dtype
        x_tr, y_tr, x_te, y_te = (up(a).to(dtype) for a in (*train, *test))
        steps = max(n // batch_size, 1)
        opts = [torch.optim.SGD(r.parameters(), lr=learning_rate)
                for r in nets]

        def step(idx):
            for opt in opts:
                opt.zero_grad(set_to_none=True)
            if len(nets) == 1:  # one device: its BatchNorm sees the batch
                loss = self._loss(x_tr[idx], y_tr[idx], nets[0])
            else:
                loss = self._mesh_loss(parts, shares, nets, x_tr[idx],
                                       y_tr[idx])
            loss.backward()
            if len(nets) > 1:
                _sum_grads(nets)
            for opt in opts:
                opt.step()
            return loss.detach()

        def sync():  # this module's network takes the first replica's weights
            if nets[0] is not self.net:
                self.net.load_state_dict(nets[0].state_dict())

        rng = np.random.default_rng(seed)
        t0 = time.time()
        history = []
        for r in nets:
            r.train()
        try:
            with self._precision(
                    deterministic=torch.backends.cudnn.deterministic,
                    devices=None if mesh is None else mesh.distinct), \
                    highest_matmul():  # the resize's product (unet._resize)
                for epoch in range(epochs):
                    perm = torch.from_numpy(
                        rng.permutation(n)[: steps * batch_size].reshape(
                            steps, batch_size)).to(home)
                    losses = [step(perm[s]) for s in range(steps)]
                    mean_loss = float(torch.mean(torch.stack(losses)))
                    val = self._val_loss(x_te, y_te, net=nets[0])
                    history.append({"epoch": epoch, "train_loss": mean_loss,
                                    "val_loss": val})
                    if verbose and (epoch % max(epochs // 10, 1) == 0
                                    or epoch == epochs - 1):
                        print(f"epoch {epoch}: train={mean_loss:.5f} "
                              f"val={val:.5f}")
                    if save_path is not None and (epoch + 1) % save_every == 0:
                        sync()
                        self.save(save_path)
        finally:
            sync()
            self.net.eval()
        if save_path is not None:
            self.save(save_path)
        if verbose:
            print(f"Training complete in {(time.time() - t0) / 60:.2f} min.")
        return history

    def save(self, path):
        """The weights in the in-repo ``.npz`` format (the JAX package's
        ``load_params`` reads it)."""
        convert.save_params(path, self.net.state_dict())
