"""Device meshes (counterpart of ``ssqueeze_rs_tpu/parallel/mesh.py``): an
array of devices with two named axes,
  'data': batch / channel parallelism,
  'time': long-signal segments with halo exchange.

Design. JAX's `Mesh` is driven by one controller that sees every device;
PyTorch has no such controller, and its `DeviceMesh` needs one process a
device (NCCL puts no two ranks on one card), so it cannot list one card
four times or eight CPU entries in one process. The port's `Mesh` is its
own: an ndarray of `torch.device` of the mesh's shape, the axis names,
the process (rank) that holds each entry and the process group, or None
in one process. An entry may repeat a device: a mesh whose 'time' axis
lists one card four times runs four shard programs on that card. The
transforms of `chunked.py` run the shard program of each entry this
process holds, one after another on its device, and exchange the halos
and the rows of the hybrid CWT between entries: by copies between the
entries of one process, by `torch.distributed` point-to-point transfers
between processes (`distributed.py`).

`Sharded` is the port's counterpart of a JAX array placed over a mesh:
the blocks of a value that this process holds, by mesh entry, with the
`PartitionSpec` that laid them out. `shard_batch` and
`distributed.global_from_local` make one; the `chunked_*` transforms take
one wherever they take an array, and return whole tensors.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["make_mesh", "shard_batch", "Mesh", "PartitionSpec", "Sharded"]


class PartitionSpec(tuple):
    """The mesh axis name (or None: not split) of each dimension of a value,
    as `jax.sharding.PartitionSpec`; trailing dimensions it leaves out are
    not split."""

    def __new__(cls, *names):
        return super().__new__(cls, names)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


class Mesh:
    """Devices on named axes. `devices`: an ndarray of `torch.device`;
    `axis_names`: one name an axis; `ranks`: the process holding each entry
    (default: all this process's); `group`: the `torch.distributed` process
    group the entries' processes share, or None in one process."""

    def __init__(self, devices, axis_names, ranks=None, group=None):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axis names "
                             f"{tuple(axis_names)}")
        flat = np.empty(devices.size, dtype=object)
        for i, d in enumerate(devices.reshape(-1)):
            flat[i] = torch.device(d)
        self.devices = flat.reshape(devices.shape)
        self.axis_names = tuple(axis_names)
        me = _rank(group)
        self.ranks = (np.full(devices.shape, me, dtype=np.int64)
                      if ranks is None else
                      np.asarray(ranks, dtype=np.int64).reshape(devices.shape))
        self.group = group
        self.rank = me

    @property
    def shape(self):
        """{axis name: size}, in axis order (as the JAX mesh's `shape`)."""
        return dict(zip(self.axis_names, self.devices.shape))

    def axis(self, name):
        """The position of axis `name`."""
        if name not in self.axis_names:
            raise ValueError(f"no mesh axis {name!r} (axes "
                             f"{self.axis_names})")
        return self.axis_names.index(name)

    def entries(self):
        """Every entry's index, in mesh (row-major) order."""
        return list(np.ndindex(*self.devices.shape))

    def local(self):
        """The entries this process holds, in mesh order."""
        return [i for i in self.entries() if self.ranks[i] == self.rank]

    def first_local_device(self):
        """The device results come back on: the mesh's first entry in one
        process, this process's first entry across processes."""
        return self.devices[self.local()[0]]

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, devices={self.devices.tolist()}, "
                f"processes={sorted(set(self.ranks.reshape(-1).tolist()))})")


def _rank(group):
    if group is None:
        return 0
    import torch.distributed as dist
    return dist.get_rank(group)


def _cuda_devices():
    """Every local CUDA device; none raises (the CPU is asked for)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device for the mesh: pass `devices` "
                           "(for example ['cpu'] * 8) to run on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(shape=None, axis_names=("data", "time"), devices=None) -> Mesh:
    """Create a mesh over `devices` (default: every local CUDA device).

    `shape`: tuple matching `axis_names`; default puts all devices on
    'data'. Example: make_mesh((2, 4)) -> 2-way batch x 4-way time. A
    device may be listed more than once (its entries then take turns on
    it). The mesh belongs to this process alone: a mesh across processes
    comes from `distributed.make_host_chip_mesh`."""
    devices = list(devices) if devices is not None else _cuda_devices()
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    need = int(np.prod(shape))
    if need > n:
        raise ValueError(f"mesh shape {shape} needs {need} devices, "
                         f"only {n} available")
    arr = np.empty(need, dtype=object)
    for i, d in enumerate(devices[:need]):
        arr[i] = torch.device(d)
    return Mesh(arr.reshape(shape), axis_names)


class Sharded:
    """A value laid out over `mesh` by `spec` (a `PartitionSpec`): its
    global `shape` and `blocks`, {mesh entry: tensor on the entry's
    device}, for the entries this process holds. Dimension d of a block is
    shape[d] / mesh.shape[spec[d]] long where spec[d] names an axis (the
    entry's position on that axis picks the slice), else whole."""

    def __init__(self, mesh, spec, shape, blocks):
        self.mesh, self.spec = mesh, PartitionSpec(*spec)
        self.shape, self.blocks = tuple(shape), dict(blocks)

    @property
    def ndim(self):
        return len(self.shape)

    def __repr__(self):
        return (f"Sharded(shape={self.shape}, spec={self.spec!r}, "
                f"{len(self.blocks)} local blocks)")


def split_spec(mesh, spec, shape):
    """[(dim, axis position, parts)] of the dimensions `spec` splits, each
    checked to divide."""
    out = []
    for d, name in enumerate(spec):
        if name is None:
            continue
        ax = mesh.axis(name)
        parts = mesh.devices.shape[ax]
        if shape[d] % parts:
            raise ValueError(f"dimension {d} ({shape[d]}) does not split "
                             f"into the {parts} entries of mesh axis "
                             f"{name!r}")
        out.append((d, ax, parts))
    return out


def block_of(x, mesh, spec, idx):
    """Entry idx's block of the whole tensor x under `spec` (a view)."""
    for d, ax, parts in split_spec(mesh, spec, x.shape):
        size = x.shape[d] // parts
        x = x.narrow(d, idx[ax] * size, size)
    return x


def shard_batch(x, mesh: Mesh, axis_name: str = "data", batch_dim: int = 0):
    """Place `x` with its batch dim sharded over `axis_name`: a `Sharded`
    whose blocks sit on their entries' devices (array input goes to the
    devices as it is; a tensor keeps its dtype)."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    spec = [None] * x.ndim
    spec[batch_dim] = axis_name
    spec = PartitionSpec(*spec)
    return Sharded(mesh, spec, x.shape, {
        i: block_of(x, mesh, spec, i).to(mesh.devices[i])
        for i in mesh.local()})
