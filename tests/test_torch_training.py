"""Demixer training in the port against the JAX package's.

The same weights (a JAX ``init_nwd_params`` carried across with
``convert.params_from_jax``) and the same numpy data go through both
packages' train steps and ``train`` loops, in float32 on the CPU. The
sums run in another order (convolutions, autograd against JAX's
transposed-convolution VJP), so the state is held at 1e-4 relative: the
largest difference over every parameter and running statistic against
the largest entry of the whole state (measured: ~2e-5 after three
steps). Not tensor by tensor: a BatchNorm bias starts at 0 and moves by
lr times a sum of ~30,000 terms that cancel, so after three steps its
float32 value differs between two orders of summation by ~5e-3 of its
own tiny size (~2e-6 absolute). A step's loss is held at 1e-4
relative; the per-epoch history of ``train`` at 1e-3: its validation
loss reads BatchNorm's running statistics, which after a few steps
amplify those differences (the port alone moves its epoch-2 validation
loss by 2e-4 between one host thread and several). The data generator,
the wire transform and the checkpoint formats are held exactly.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax
import jax.numpy as jnp

from circuitmap_tpu.demix import convert as jconvert
from circuitmap_tpu.demix import datagen as jdatagen
from circuitmap_tpu.demix import demixer as jdemixer
from circuitmap_tpu.demix.unet import init_nwd_params as jax_init
from circuitmap_torch.demix import convert, datagen, demixer
from circuitmap_torch.demix.demixer import NeuralDemixer
from circuitmap_torch.demix.unet import NWDUNet, init_nwd_params

PARAM_RTOL = 1e-4
LOSS_RTOL = 1e-4
HISTORY_RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_host_thread():
    """One torch and one BLAS thread while this file runs: the suite
    runs in parallel workers, and a pool of threads per worker
    oversubscribes the cores."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def data():
    np.random.seed(0)
    return jdatagen.generate_psc_dataset(size=256, seed=3)


def _worst_rel(sd, jparams):
    """max |port - JAX| over every floating entry of the state_dict
    (running statistics included) over max |JAX| of the same entries."""
    want = convert.params_from_jax(jparams)
    keys = [k for k in want if want[k].is_floating_point()]
    err = max(float((sd[k].double() - want[k].double()).abs().max())
              for k in keys)
    return err / max(float(want[k].double().abs().max()) for k in keys)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(jax_params, data, n_steps):
    (x, y), _ = data
    jp = jax.tree_util.tree_map(jnp.asarray, jax_params)
    dm = NeuralDemixer(params=jax_params, device="cpu")
    opt = torch.optim.SGD(dm.net.parameters(), lr=1e-2)
    dm.net.train()
    for s in range(n_steps):
        xb, yb = x[64 * s:64 * (s + 1)], y[64 * s:64 * (s + 1)]
        jp, jloss = jdemixer._train_step(jp, jnp.asarray(xb, jnp.float32),
                                          jnp.asarray(yb, jnp.float32),
                                          jnp.float32(1e-2))
        opt.zero_grad()
        loss = dm._loss(torch.from_numpy(xb.astype(np.float32)),
                        torch.from_numpy(yb.astype(np.float32)))
        loss.backward()
        opt.step()
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=LOSS_RTOL)
    worst = _worst_rel(dm.net.state_dict(),
                       jax.tree_util.tree_map(np.asarray, jp))
    assert worst < PARAM_RTOL, worst


def test_train_matches_jax_train(jax_params, data, tmp_path):
    train, test = data
    jd = jdemixer.NeuralDemixer(
        params=jax.tree_util.tree_map(jnp.asarray, jax_params))
    td = NeuralDemixer(params=jax_params, device="cpu")
    for d in (jd, td):
        d.training_data, d.test_data = train, test
    kw = dict(epochs=2, batch_size=64, learning_rate=1e-2, seed=0,
              verbose=False)
    hj = jd.train(**kw)
    ht = td.train(save_path=str(tmp_path / "w.npz"), save_every=1, **kw)
    assert [h["epoch"] for h in ht] == [0, 1]
    for a, b in zip(hj, ht):
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(b[key], a[key], rtol=HISTORY_RTOL)
    assert _worst_rel(td.net.state_dict(), jax.tree_util.tree_map(
        np.asarray, jd.params)) < PARAM_RTOL
    # the module is back in eval mode and the saved weights are its own
    assert not td.net.training
    saved = convert.load_params(tmp_path / "w.npz")
    for k, v in td.net.state_dict().items():
        if v.is_floating_point():
            torch.testing.assert_close(saved[k], v, rtol=0, atol=0)


def test_train_reads_data_path(jax_params, data, tmp_path):
    td = NeuralDemixer(params=jax_params, device="cpu")
    with pytest.raises(RuntimeError, match="no training data"):
        td.train(epochs=1, verbose=False)
    path = tmp_path / "d.npz"
    np.random.seed(1)
    td.generate_training_data(save_path=str(path), size=40, seed=2)
    other = NeuralDemixer(params=jax_params, device="cpu")
    h1 = td.train(epochs=1, batch_size=16, verbose=False)
    h2 = other.train(epochs=1, batch_size=16, data_path=str(path),
                     verbose=False)
    assert h1 == h2


# -- data-parallel training (train(mesh=)) -----------------------------------
# A mesh step splits the batch over the shards and normalises with the
# global batch's BatchNorm statistics, so it equals the one-device step
# up to the order of its sums: held per tensor at rtol 1e-5 / atol 1e-6
# (the JAX package's own mesh test, tests/test_demixer.py). "cpu" and
# "cpu:0" are distinct devices to the mesh: two replicas whose gradients
# are added before each step; the shards on one device run as one part
# of the batch ("2" and "4": the one-device step; "3+1" splits it 48/16
# over two replicas).
MESHES = {"2": ["cpu"] * 2, "4": ["cpu"] * 4,
          "2-replicas": ["cpu", "cpu:0", "cpu", "cpu:0"],
          "3+1": ["cpu", "cpu", "cpu", "cpu:0"]}


def _close_state(got, want):
    for k, v in want.items():
        if v.is_floating_point():
            torch.testing.assert_close(got[k], v, rtol=1e-5, atol=1e-6,
                                       msg=k)
        else:
            assert torch.equal(got[k], v), k


def _one_step(jax_params, batch, mesh=None):
    td = NeuralDemixer(params=jax_params, device="cpu")
    td.training_data = batch
    td.test_data = (batch[0][:0], batch[1][:0])
    hist = td.train(epochs=1, batch_size=len(batch[0]), learning_rate=1e-2,
                    seed=0, verbose=False, mesh=mesh)
    return td, hist


@pytest.mark.parametrize("devices", list(MESHES.values()), ids=list(MESHES))
def test_mesh_step_equals_the_single_step_and_jax(jax_params, data,
                                                  devices):
    from circuitmap_torch.parallel import trial_mesh

    (x, y), _ = data
    batch = (x[:64], y[:64])
    single, h1 = _one_step(jax_params, batch)
    meshed, h2 = _one_step(jax_params, batch, trial_mesh(devices=devices))
    _close_state(meshed.net.state_dict(), single.net.state_dict())
    np.testing.assert_allclose(h2[0]["train_loss"], h1[0]["train_loss"],
                               rtol=1e-5)
    # the JAX step on train's batch (its first permutation)
    perm = np.random.default_rng(0).permutation(64)
    jp, jloss = jdemixer._train_step(
        jax.tree_util.tree_map(jnp.asarray, jax_params),
        jnp.asarray(batch[0][perm], jnp.float32),
        jnp.asarray(batch[1][perm], jnp.float32), jnp.float32(1e-2))
    want = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    # (the JAX state counts no BatchNorm steps: floating entries only)
    _close_state(meshed.net.state_dict(),
                 {k: v for k, v in want.items() if v.is_floating_point()})
    np.testing.assert_allclose(h2[0]["train_loss"], float(jloss), rtol=1e-5)
    assert not meshed.net.training


def test_mesh_training_follows_the_single_device_trajectory(jax_params,
                                                            data, tmp_path):
    """3 epochs on a 4-shard mesh of two replicas against the one-device
    run: within 5% a epoch (the reduction-order noise grows through
    BatchNorm and SGD), as tests/test_demixer.py holds the JAX package's;
    save_path and save_every behave as without a mesh."""
    from circuitmap_torch.parallel import trial_mesh

    train, test = data
    runs = []
    for mesh in (None, trial_mesh(devices=MESHES["2-replicas"])):
        td = NeuralDemixer(params=jax_params, device="cpu")
        td.training_data, td.test_data = (train[0][:128], train[1][:128]), test
        path = tmp_path / f"w{0 if mesh is None else 1}.npz"
        hist = td.train(epochs=3, batch_size=32, learning_rate=1e-2,
                        verbose=False, mesh=mesh, save_path=str(path),
                        save_every=2)
        runs.append((td, hist, path))
    (_, ha, _), (tb, hb, path) = runs
    assert [h["epoch"] for h in hb] == [0, 1, 2]
    for a, b in zip(ha, hb):
        for key in ("train_loss", "val_loss"):
            assert abs(a[key] - b[key]) <= 0.05 * abs(a[key]), (key, a, b)
    assert hb[-1]["train_loss"] < hb[0]["train_loss"]
    saved = convert.load_params(path)
    for k, v in tb.net.state_dict().items():
        if v.is_floating_point():
            torch.testing.assert_close(saved[k], v, rtol=0, atol=0)


def test_mesh_training_refuses_what_it_cannot_split(jax_params, data):
    from circuitmap_torch.parallel import TrialMesh, trial_mesh

    (x, y), test = data
    td = NeuralDemixer(params=jax_params, device="cpu")
    td.training_data, td.test_data = (x[:60], y[:60]), test
    with pytest.raises(ValueError, match="must divide over the 4-device "
                                         "mesh"):
        td.train(epochs=1, batch_size=30, verbose=False,
                 mesh=trial_mesh(devices=["cpu"] * 4))
    # the effective batch is min(batch_size, n): 60 pairs over 8 shards
    with pytest.raises(ValueError, match="batch_size=60 .*8-device"):
        td.train(epochs=1, batch_size=64, verbose=False,
                 mesh=trial_mesh(devices=["cpu"] * 8))
    group_mesh = TrialMesh(["cpu"])
    group_mesh.group = object()  # a mesh over a process group
    with pytest.raises(ValueError, match="one process"):
        td.train(epochs=1, verbose=False, mesh=group_mesh)
    with pytest.raises(TypeError, match="TrialMesh"):
        td.train(epochs=1, verbose=False, mesh=object())


@pytest.mark.parametrize("length,size", [(7, 15), (112, 225), (10, 10)])
def test_training_resize_is_interpolates(length, size, monkeypatch):
    """The U-Net's resize (``unet._resize``) is ``F.interpolate``'s
    linear resize; with ``torch.backends.cudnn.deterministic`` set and
    autograd recording it is the product with the resize's weights
    (which repeats on the card), equal to interpolate to the last bits,
    with interpolate's gradient."""
    from circuitmap_torch.demix.unet import _resize

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 4, length, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    grad = torch.randn(3, 4, size, dtype=torch.float64, generator=gen)
    want = F.interpolate(x, size=size, mode="linear", align_corners=False)
    (gw,) = torch.autograd.grad(want, x, grad)
    for flag in (False, True):
        monkeypatch.setattr(torch.backends.cudnn, "deterministic", flag)
        with torch.no_grad():
            assert torch.equal(_resize(x, size), want)
        got = _resize(x, size)
        assert (got.grad_fn.name() == "UpsampleLinear1DBackward0") != flag
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
        (gg,) = torch.autograd.grad(got, x, grad)
        torch.testing.assert_close(gg, gw, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("flag", [False, True])
def test_train_takes_cudnn_determinism_from_the_caller(jax_params, data,
                                                       monkeypatch, flag):
    """Training asks for cuDNN's deterministic algorithms exactly when
    the caller set ``torch.backends.cudnn.deterministic`` (they slow a
    step on the card); the test set's loss always takes them, as the
    demixer's inference does."""
    (x, y), test = data
    td = NeuralDemixer(params=jax_params, device="cpu")
    td.training_data, td.test_data = (x[:32], y[:32]), (x[:8], y[:8])
    asked = []
    precision = td._precision

    def recording(deterministic=False, devices=None):
        asked.append(deterministic)
        return precision(deterministic, devices)

    monkeypatch.setattr(td, "_precision", recording)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", flag)
    td.train(epochs=1, batch_size=32, verbose=False)
    assert asked == [flag, True]  # the epochs, then the test set's loss


def test_generate_psc_dataset_equals_jax():
    kw = dict(size=300, seed=5, templates=np.random.default_rng(1).normal(
        size=(4, 900)), template_prob=0.2)
    np.random.seed(11)
    want = jdatagen.generate_psc_dataset(**kw)
    np.random.seed(11)
    got = datagen.generate_psc_dataset(**kw)
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            np.testing.assert_array_equal(b, a)
    np.random.seed(3)
    dm = NeuralDemixer(device="cpu")
    got = dm.generate_training_data(size=50, seed=4)
    np.random.seed(3)
    want = jdatagen.generate_psc_dataset(size=50, seed=4)
    np.testing.assert_array_equal(got[1][0], want[1][0])


@pytest.mark.parametrize("bits,decimate", [(4, 1), (4, 2), (8, 1), (4, 2)])
def test_wire_transform_equals_jax(bits, decimate):
    rng = np.random.default_rng(bits + decimate)
    x = rng.normal(size=(7, 901 if decimate == 2 else 900)) * 3.0
    x[0] = 0.0
    np.testing.assert_array_equal(
        demixer.wire_transform(x, bits=bits, decimate=decimate),
        jdemixer.wire_transform(x, bits=bits, decimate=decimate))
    with pytest.raises(ValueError, match="decimate"):
        demixer.wire_transform(x, decimate=3)


def test_checkpoints_cross_between_the_packages(jax_params, tmp_path):
    """``.npz`` and Lightning ``.ckpt`` written by each package and read
    by the other: equal bit for bit, and the same forward."""
    x = np.random.default_rng(0).normal(size=(5, 900)).astype(np.float32)
    td = NeuralDemixer(params=jax_params, device="cpu")
    sd = td.net.state_dict()
    # port -> JAX
    td.save(str(tmp_path / "p.npz"))
    convert.save_lightning_checkpoint(str(tmp_path / "p.ckpt"), sd,
                                      epoch=3, global_step=12)
    for name in ("p.npz", "p.ckpt"):
        back = jconvert.load_params(str(tmp_path / name))
        for k, v in convert.params_from_jax(
                jax.tree_util.tree_map(np.asarray, back)).items():
            if v.is_floating_point():
                torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    ck = torch.load(str(tmp_path / "p.ckpt"), weights_only=False)
    assert set(ck) == {"epoch", "global_step", "pytorch-lightning_version",
                       "state_dict", "callbacks", "optimizer_states",
                       "lr_schedulers"}
    assert len(ck["state_dict"]) == 63 and ck["epoch"] == 3
    # JAX -> port, through NeuralDemixer(path=...)
    jp = jax.tree_util.tree_map(jnp.asarray, jax_params)
    jconvert.save_params(str(tmp_path / "j.npz"), jp)
    jconvert.save_lightning_checkpoint(str(tmp_path / "j.ckpt"), jp)
    want = np.asarray(jdemixer.NeuralDemixer(params=jp)(x, verbose=False))
    for name in ("j.npz", "j.ckpt"):
        dm = NeuralDemixer(path=str(tmp_path / name), device="cpu")
        for k, v in dm.net.state_dict().items():
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
        np.testing.assert_allclose(dm(x, verbose=False), want, rtol=1e-4,
                                   atol=1e-5)
    assert len(convert.state_dict_from_params(jax_params)) == 63


def test_fresh_network_follows_the_jax_init_rule():
    """A fresh network from a ``torch.Generator``: every conv weight and
    bias within the JAX package's fan-in bound, spread across it, and
    reproducible from the seed; BatchNorm at its identity."""
    sd = init_nwd_params(torch.Generator().manual_seed(7))
    jp = jax_init(jax.random.PRNGKey(7))
    same = init_nwd_params(torch.Generator().manual_seed(7))
    for block, groups in jp.items():
        for group, leaves in groups.items():
            for leaf, val in leaves.items():
                key = f"{block}.{group}.{convert._LEAF[leaf]}"
                got = sd[key]
                assert got.shape == tuple(val.shape)
                torch.testing.assert_close(got, same[key], rtol=0, atol=0)
                if group == "bn":
                    torch.testing.assert_close(
                        got, torch.as_tensor(np.array(val)), rtol=0,
                        atol=0)
                else:
                    # fan-in I*K of Conv1d [O, I, K], O*K of
                    # ConvTranspose1d [I, O, K]
                    w_shape = jp[block][group]["w"].shape
                    bound = 1.0 / np.sqrt(w_shape[1] * w_shape[2])
                    assert got.abs().max() <= 1.0001 * bound
                    if got.numel() > 100:
                        assert got.abs().max() > 0.9 * bound
    NWDUNet().load_state_dict(sd)
    dm = NeuralDemixer(device="cpu", seed=7)
    for k, v in dm.net.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
