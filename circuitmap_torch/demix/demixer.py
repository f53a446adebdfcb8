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
its running averages (momentum 0.1). Inference and training share one
``nn.Module``: ``__call__`` puts it in eval mode, ``train`` in train
mode. Convolutions run with cuDNN's TF32 off in both.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .._device import resolve_device, torch_dtype
from ..ops.monotone import monotone_decay_filter
from ..solvers._common import prepare_traces
from ..utils.quant import _pool2, _upsample2
from . import convert
from .datagen import generate_psc_dataset
from .unet import NWDUNet, init_nwd_params


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
        self.training_data = None
        self.test_data = None

    def _precision(self):
        # the JAX head runs at HIGHEST precision; cuDNN would run a
        # float32 convolution in TF32 by default
        if self.device.type == "cuda":
            return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)
        return contextlib.nullcontext()

    def _demix_batch(self, traces):
        """Peak-normalise -> forward -> rescale -> monotone filter
        (filter start is bound by the caller). traces: [B, T] f32."""
        tmax = torch.max(traces, dim=1, keepdim=True).values
        safe = torch.where(tmax != 0, tmax, torch.ones_like(tmax))
        net_dtype = next(self.net.parameters()).dtype
        x = (traces / safe)[:, None, :].to(net_dtype)
        return self.net(x)[:, 0, :].float() * tmax

    def __call__(self, traces, monotone_filter_start=500,
                 monotone_filter_inplace=True, verbose=True,
                 keep_on_device=False, chunk_size=4096,
                 transfer_dtype=None, mesh=None):
        """Demix a [K, T] (or [T]) trace block. Returns numpy, or the
        device tensor with ``keep_on_device=True`` (to feed a solver
        without a round trip through host memory)."""
        del monotone_filter_inplace  # functional; kept for API parity
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (multi-GPU demixing) is ROADMAP item A9 and not "
                "ported yet")
        traces = np.asarray(traces)
        squeeze = traces.ndim == 1
        if squeeze:
            traces = traces[None]
        K = traces.shape[0]
        wire = _wire_name(transfer_dtype)
        self.net.eval()

        t0 = time.time()
        chunks = []
        with torch.inference_mode(), self._precision():
            for k0 in range(0, K, chunk_size):
                # encoded on the host, decoded (and upsampled) on the device
                part = prepare_traces(traces[k0:k0 + chunk_size],
                                      torch.float32, self.device,
                                      trace_wire=wire)
                out = self._demix_batch(part)
                chunks.append(monotone_decay_filter(
                    out, start=int(monotone_filter_start)))
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

    def _loss(self, x, y):
        """Mean squared error of the network on inputs x [B, T] against
        targets y [B, T], in the module's current mode."""
        return torch.mean(torch.square(self.net(x[:, None, :])[:, 0, :] - y))

    def _val_loss(self, x, y, chunk=4096):
        """Eval-mode MSE over a test set x, y [n, T] on the device, in
        chunks (BatchNorm reads its running statistics, so chunks do not
        change the value beyond the order of the sum); the module's mode
        is restored."""
        if x.shape[0] == 0:
            return 0.0
        was_training = self.net.training
        self.net.eval()
        with torch.no_grad(), self._precision():
            total = sum(torch.sum(torch.square(
                self.net(x[i:i + chunk, None, :])[:, 0, :] - y[i:i + chunk]))
                for i in range(0, x.shape[0], chunk))
        self.net.train(was_training)
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
        ``.npz``) every ``save_every`` epochs and at the end. ``mesh=``
        (data-parallel multi-GPU training) is not ported yet.
        """
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (data-parallel multi-GPU training) is ROADMAP item "
                "A9 and not ported yet")
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

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(
                a, dtype=np.float32)).to(self.device)

        x_tr, y_tr, x_te, y_te = (up(a) for a in (*train, *test))
        dtype = next(self.net.parameters()).dtype
        x_tr, y_tr, x_te, y_te = (a.to(dtype) for a in (x_tr, y_tr, x_te,
                                                       y_te))
        n = x_tr.shape[0]
        batch_size = min(batch_size, n)  # datasets smaller than one batch
        steps = max(n // batch_size, 1)
        opt = torch.optim.SGD(self.net.parameters(), lr=learning_rate)
        rng = np.random.default_rng(seed)
        t0 = time.time()
        history = []
        self.net.train()
        try:
            with self._precision():
                for epoch in range(epochs):
                    perm = torch.from_numpy(
                        rng.permutation(n)[: steps * batch_size].reshape(
                            steps, batch_size)).to(self.device)
                    losses = []
                    for s in range(steps):
                        idx = perm[s]
                        opt.zero_grad(set_to_none=True)
                        loss = self._loss(x_tr[idx], y_tr[idx])
                        loss.backward()
                        opt.step()
                        losses.append(loss.detach())
                    mean_loss = float(torch.mean(torch.stack(losses)))
                    val = self._val_loss(x_te, y_te)
                    history.append({"epoch": epoch, "train_loss": mean_loss,
                                    "val_loss": val})
                    if verbose and (epoch % max(epochs // 10, 1) == 0
                                    or epoch == epochs - 1):
                        print(f"epoch {epoch}: train={mean_loss:.5f} "
                              f"val={val:.5f}")
                    if save_path is not None and (epoch + 1) % save_every == 0:
                        self.save(save_path)
        finally:
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
