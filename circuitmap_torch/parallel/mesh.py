"""The trial mesh (port of ``circuitmap_tpu/parallel/mesh.py``).

One logical axis, ``trial``: the K (trial) dimension of every [.., K]
array shards across it. Neuron-axis quantities (mu, beta, phi) stay
replicated: they are O(N) and every shard needs all of them each sweep
step.

JAX's mesh is one controller over many devices; here a
:class:`TrialMesh` is this process's ordered list of ``torch.device``s,
one per trial shard, and optionally a ``torch.distributed`` process
group that joins the same lists of other processes (``distributed.py``).
A device may repeat: ``["cuda:0"] * 2`` on one card or ``["cpu"] * 4``
are meshes of shards that share a device, the counterparts of JAX's
virtual CPU mesh.

The solvers keep two kinds of per-shard lists, one entry per local
shard: a shard's own slice of a trial-sharded array, and a replicated
value, whose entries for shards on one device are one tensor.
:meth:`TrialMesh.map` runs a function on each shard,
:meth:`TrialMesh.rep` once per distinct device, and
:meth:`TrialMesh.psum` sums per-shard partials in a fixed order (shard
0 first) into a replicated value.
"""

from __future__ import annotations

import time

import torch


TRIAL_AXIS = "trial"  # the mesh's one axis, as the JAX package names it


def _device(d):
    d = torch.device(d)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _transpose(outs):
    """[per-shard results] -> the list, or a tuple of lists when each
    result is a tuple."""
    if outs and isinstance(outs[0], tuple):
        return tuple(list(x) for x in zip(*outs))
    return outs


class TrialMesh:
    """This process's trial shards: ``devices`` (one per shard, in trial
    order; a device may repeat) and ``group``, a ``torch.distributed``
    process group whose ranks hold the following shards (rank r's local
    shard s is global shard ``r * len(devices) + s``), or None for one
    process.

    Meshes compare and hash by their device list and group, so caches
    keyed on a mesh (the demixer's network copies) hit for an equal
    mesh built anew. ``psums``, ``all_reduces`` and ``all_reduce_s``
    count the collectives since :meth:`reset_counts`.
    """

    def __init__(self, devices, group=None):
        self.devices = tuple(_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a trial mesh needs at least one device")
        self.group = group
        self.distinct = tuple(dict.fromkeys(self.devices))
        self._home = [self.distinct.index(d) for d in self.devices]
        # the first shard on each distinct device
        self._first = [self._home.index(j) for j in range(len(self.distinct))]
        if group is None:
            self.world, self.rank = 1, 0
        else:
            import torch.distributed as dist

            self.world = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
        self.reset_counts()

    @property
    def n_local(self):
        """Shards in this process."""
        return len(self.devices)

    @property
    def size(self):
        """Shards over every process of the group."""
        return self.n_local * self.world

    def reset_counts(self):
        self.psums = 0
        self.all_reduces = 0
        self.all_reduce_s = 0.0

    def __eq__(self, other):
        return (isinstance(other, TrialMesh) and self.devices == other.devices
                and self.group is other.group)

    def __hash__(self):
        return hash((self.devices, id(self.group)))

    def __repr__(self):
        where = "" if self.group is None else \
            f", rank {self.rank} of {self.world}"
        return f"TrialMesh({[str(d) for d in self.devices]}{where})"

    # -- per-shard lists ---------------------------------------------------

    def map(self, fn, *args):
        """``fn`` on each shard: list arguments give the shard's entry,
        others pass as they are. Returns a per-shard list (a tuple of
        lists when ``fn`` returns a tuple)."""
        return _transpose([fn(*(a[s] if isinstance(a, list) else a
                                for a in args))
                           for s in range(self.n_local)])

    def rep(self, fn, *args):
        """``fn`` once per distinct device, on the arguments of the first
        shard there: the replicated computation. Returns a per-shard
        list whose shards on one device share the result."""
        outs = [fn(*(a[s] if isinstance(a, list) else a for a in args))
                for s in self._first]
        return _transpose([outs[self._home[s]]
                           for s in range(self.n_local)])

    def replicate(self, value):
        """A tensor (on any device) as a replicated per-shard list: one
        copy per distinct device."""
        copies = [value.to(d) for d in self.distinct]
        return [copies[j] for j in self._home]

    def psum(self, parts):
        """Sum the per-shard ``parts`` over every shard of the mesh, in
        shard order, and give each shard its copy: a replicated list.
        Across devices of this process the partials are copied to the
        first device and added there; with a group one
        ``dist.all_reduce`` then sums the processes' totals."""
        self.psums += 1
        d0 = self.distinct[0]
        acc = parts[0].to(d0)
        for p in parts[1:]:
            acc = acc + p.to(d0)
        if self.group is not None:
            import torch.distributed as dist

            if acc is parts[0]:  # all_reduce is in place
                acc = acc.clone()
            t0 = time.perf_counter()
            dist.all_reduce(acc, group=self.group)
            self.all_reduce_s += time.perf_counter() - t0
            self.all_reduces += 1
        return self.replicate(acc)

    def split(self, value):
        """A tensor whose last axis is this process's trials (a multiple
        of the local shard count) as a per-shard list of contiguous
        slices, each on its shard's device."""
        chunks = torch.chunk(value, self.n_local, dim=-1)
        if len({c.shape[-1] for c in chunks}) != 1 or \
                len(chunks) != self.n_local:
            raise ValueError(
                f"{value.shape[-1]} trials do not split evenly over "
                f"{self.n_local} shards")
        return [c.to(d).contiguous() for c, d in zip(chunks, self.devices)]

    def gather(self, shards):
        """This process's shards concatenated along the trial (last) axis
        on the first shard's device."""
        return torch.cat([s.to(self.devices[0]) for s in shards], dim=-1)


def trial_mesh(n_devices=None, devices=None, group=None):
    """A 1-D mesh over the trial axis.

    ``devices`` lists one device per shard and may repeat one (a mesh of
    shards that share a card, or of CPU shards). Without it the mesh
    takes every visible CUDA device, or the first ``n_devices`` of them,
    and raises when there are fewer. ``group``: the process group of a
    multi-process mesh (see ``distributed.global_trial_mesh``).
    """
    if devices is None:
        from .._device import resolve_device

        resolve_device(None)  # no GPU: the package's device rule raises
        visible = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            if len(visible) < n_devices:
                raise ValueError(
                    f"trial_mesh({n_devices}) needs {n_devices} devices but "
                    f"the cuda platform only exposes {len(visible)}; pass "
                    "devices= for a mesh whose shards share a device "
                    "(e.g. ['cuda:0'] * 2, or ['cpu'] * 4)")
            visible = visible[:n_devices]
        devices = visible
    return TrialMesh(devices, group=group)
