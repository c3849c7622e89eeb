"""Multi-process runtime glue (counterpart of
``ssqueeze_rs_tpu/parallel/distributed.py``): `torch.distributed` in
place of the JAX multi-host runtime.

A multi-card or multi-host job starts one process a card with `torchrun`
(or any launcher that sets MASTER_ADDR, MASTER_PORT, WORLD_SIZE and
RANK), calls `initialize()` once in each, builds a host-by-card mesh with
`make_host_chip_mesh()`, and feeds each process's part of the signal
through `global_from_local`. The `chunked_*` transforms then run each
process's shard programs on its cards and exchange halos and rows between
processes by point-to-point transfers (`exchange`); each process gets the
whole result back.

Single-process fallback: with no coordinator given and none in the
environment, `initialize()` does nothing and the mesh spans this
process's devices, so the same script runs on one card, one host or
many.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .mesh import Mesh, PartitionSpec as P, Sharded, split_spec

__all__ = ["initialize", "make_host_chip_mesh", "global_from_local",
           "is_distributed"]


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() else None


def _runtime_initialized() -> bool:
    """Is a default process group up (set up here or by the launcher)?"""
    dist = _dist()
    return bool(dist and dist.is_initialized())


def is_distributed() -> bool:
    """True when a process group of more than one process is up
    (initialized by this module OR externally, e.g. by a launcher
    script)."""
    return _runtime_initialized() and _dist().get_world_size() > 1


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               **kw):
    """Initialize the multi-process runtime (idempotent).

    `coordinator_address` ('host:port'), `num_processes` and `process_id`
    default to torchrun's environment (MASTER_ADDR:MASTER_PORT, WORLD_SIZE,
    RANK). With neither present this is a no-op and the process runs
    alone. The backend is NCCL where CUDA is available and gloo
    otherwise (`backend=` overrides); with NCCL each process takes the
    card LOCAL_RANK names (default: its rank modulo the cards it sees).
    Other keywords go to `torch.distributed.init_process_group`."""
    if _runtime_initialized():
        return
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") and \
            env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if coordinator_address is None:
        return  # single-process run
    n = num_processes if num_processes is not None else int(
        env.get("WORLD_SIZE", 1))
    rank = process_id if process_id is not None else int(env.get("RANK", 0))
    backend = kw.pop("backend", None) or (
        "nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    _dist().init_process_group(backend, init_method=f"tcp://"
                               f"{coordinator_address}", world_size=n,
                               rank=rank, **kw)


def _local_devices(device):
    """This process's mesh entries: `device` (one, or a list), else its
    card (with a process group up) or every card it sees."""
    if device is not None:
        return ([torch.device(d) for d in device]
                if isinstance(device, (list, tuple)) else
                [torch.device(device)])
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError("no CUDA device for the mesh: pass `device` "
                           "(for example ['cpu'] * 4) to run on the CPU")
    if _runtime_initialized():
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_host_chip_mesh(axis_names=("data", "time"), time_parallel=None,
                        device=None) -> Mesh:
    """Mesh over ALL processes' devices, laid out process-major.

    By default processes map to 'data' (each one's recordings stay local)
    and each process's devices to 'time'. `time_parallel` overrides the
    size of the 'time' axis (must divide the global device count).
    `device`: this process's entries (a device or a list; default: its
    card under a process group, else every card it sees)."""
    local = _local_devices(device)
    if is_distributed():
        dist = _dist()
        lists = [None] * dist.get_world_size()
        dist.all_gather_object(lists, [str(d) for d in local])
        devs = [(r, torch.device(d)) for r, ds in enumerate(lists)
                for d in ds]
        group = dist.group.WORLD
    else:
        devs, group = [(0, d) for d in local], None
    n = len(devs)
    tp = time_parallel if time_parallel is not None else len(local)
    if n % tp:
        raise ValueError(f"time_parallel={tp} must divide {n} devices")
    arr = np.empty(n, dtype=object)
    for i, (_, d) in enumerate(devs):
        arr[i] = d
    ranks = np.asarray([r for r, _ in devs]).reshape(n // tp, tp)
    return Mesh(arr.reshape(n // tp, tp), axis_names, ranks=ranks,
                group=group)


def global_from_local(x_local, mesh: Mesh, spec: P):
    """Assemble a global value from per-process local parts.

    `x_local`: this process's part (numpy or tensor): along each
    dimension `spec` splits, the blocks of this process's entries in
    mesh order, which must be consecutive on that axis; `spec`: the
    GLOBAL `PartitionSpec`. Returns a `Sharded`. Single-process: the
    blocks of x_local over the mesh."""
    x = (x_local if isinstance(x_local, torch.Tensor) else
         torch.as_tensor(np.asarray(x_local)))
    spec = P(*spec)
    local = mesh.local()
    splits = split_spec(mesh, spec, [0] * len(spec))
    shape = list(x.shape)
    first = {}
    for d, ax, parts in splits:
        held = sorted({i[ax] for i in local})
        if held != list(range(held[0], held[-1] + 1)):
            raise ValueError(f"this process's entries on axis "
                             f"{mesh.axis_names[ax]!r} are not consecutive")
        if x.shape[d] % len(held):
            raise ValueError(f"local dimension {d} ({x.shape[d]}) does not "
                             f"split into {len(held)} entries")
        shape[d] = x.shape[d] // len(held) * parts
        first[d] = held[0]
    blocks = {}
    for i in local:
        b = x
        for d, ax, parts in splits:
            size = shape[d] // parts
            b = b.narrow(d, (i[ax] - first[d]) * size, size)
        blocks[i] = b.to(mesh.devices[i])
    return Sharded(mesh, spec, shape, blocks)


def exchange(mesh: Mesh, pairs, send, like):
    """Move tensors between mesh entries: for each (src, dst) of `pairs`
    (the same list, in the same order, in every process), `send(src,
    dst)` is what src gives dst (called where this process holds src) and
    `like(src, dst)` its (shape, dtype) (where it holds dst). Returns
    {(src, dst): tensor on dst's device} for the pairs whose dst this
    process holds. Between entries of one process the tensor is copied to
    dst's device; between processes it travels by one batch of
    `torch.distributed` isend / irecv (tagged by the pair's place in
    `pairs`; a complex tensor travels as its real view)."""
    out, ops = {}, []
    mine = mesh.rank
    for tag, (src, dst) in enumerate(pairs):
        s_local = mesh.ranks[src] == mine
        d_local = mesh.ranks[dst] == mine
        if s_local and d_local:
            out[(src, dst)] = send(src, dst).to(mesh.devices[dst])
        elif s_local:
            t = send(src, dst).contiguous()
            ops.append(("send", torch.view_as_real(t) if t.is_complex()
                        else t, int(mesh.ranks[dst]), tag))
        elif d_local:
            shape, dtype = like(src, dst)
            buf = torch.empty(shape, dtype=dtype, device=mesh.devices[dst])
            out[(src, dst)] = buf
            ops.append(("recv", torch.view_as_real(buf) if buf.is_complex()
                        else buf, int(mesh.ranks[src]), tag))
    if ops:
        dist = _dist()
        p2p = [dist.P2POp(dist.isend if kind == "send" else dist.irecv, t,
                          peer, mesh.group, tag)
               for kind, t, peer, tag in ops]
        for req in dist.batch_isend_irecv(p2p):
            req.wait()
    return out
