"""Process groups, device meshes and batch sharding: the port's communication
layer.

The PyTorch counterpart of `humaniflow_tpu/parallel/mesh.py`.  JAX runs one
controller over a `Mesh` and lets GSPMD insert the collectives from sharding
annotations.  PyTorch's idiom is one process per device, so here:

* `spawn` starts one process (a rank) per device and `init_distributed` joins
  them through a `file://` rendezvous: NCCL on CUDA, gloo on the CPU (gloo
  may also put several ranks on one card, when asked for by name);
* `make_mesh` is a 1-D `DeviceMesh` over the ranks with JAX's axis name
  "data" (parallel/sample_parallel.py adds the 2-D ("data", "sample") mesh);
* a rank holds its block of a batch as a plain tensor (`shard_batch`, in the
  layout of `NamedSharding(P("data"))`), and replicated parameters are a
  broadcast from rank 0 (`replicate`);
* the collectives that XLA inserted from shardings are explicit
  (`all_reduce_sum`, `all_gather_cat`, `all_gather_tree`, and `AllReduceSum`
  where a gradient flows through the sum).

JAX's `batch_sharding` and `replicated` return `jax.sharding` objects, which
have no counterpart here.
"""

import os
import tempfile
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..utils.device import resolve_device

DATA_AXIS = "data"

_rank_device: Optional[torch.device] = None  # this process's device, set by init_distributed


def init_distributed(rank: int, world_size: int, init_method: str, device="cuda",
                     backend: Optional[str] = None) -> torch.device:
    """Join the process group as `rank` of `world_size`; returns this rank's
    device.  The backend is NCCL on CUDA and gloo on the CPU unless named:
    NCCL takes one card a rank (cuda:rank) and raises ValueError when there
    are fewer cards than ranks; gloo on CUDA puts rank r on card
    r % device_count, so that several ranks may share one card."""
    global _rank_device
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        if backend == "nccl" and world_size > n_cards:
            raise ValueError(f"{world_size} NCCL ranks need {world_size} CUDA devices; this host has {n_cards}")
        dev = torch.device("cuda", rank % n_cards)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    _rank_device = dev
    return dev


def _mesh_device_type() -> str:
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the ranks with parallel.spawn or init_distributed")
    return _rank_device.type if _rank_device is not None else "cpu"


def make_mesh(n_devices: Optional[int] = None, axis_name: str = DATA_AXIS) -> DeviceMesh:
    """A 1-D data-parallel mesh over every rank of the process group
    (n_devices, if given, must be the world size)."""
    world = dist.get_world_size() if dist.is_initialized() else None
    if n_devices is not None and world is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices over a process group of {world} ranks")
    return init_device_mesh(_mesh_device_type(), (world,), mesh_dim_names=(axis_name,))


def axis_size(mesh: DeviceMesh, axis_name: str) -> int:
    """The mesh's extent along `axis_name` (1 for an axis it lacks)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis_name)) if axis_name in names else 1


def axis_rank(mesh: DeviceMesh, axis_name: str) -> int:
    """This rank's coordinate along `axis_name` (0 for an axis it lacks)."""
    return mesh.get_local_rank(axis_name) if axis_name in (mesh.mesh_dim_names or ()) else 0


def axis_group(mesh: DeviceMesh, axis_name: str):
    """The process group of this rank's line along `axis_name` (None for an
    axis the mesh lacks: the collectives below are then the identity)."""
    return mesh.get_group(axis_name) if axis_name in (mesh.mesh_dim_names or ()) else None


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _tree_leaves(v)]
    return [tree]


def _block(mesh: DeviceMesh, axis_names: Union[str, Sequence[str]]) -> Tuple[int, int]:
    """(this rank's block index, block count) over one axis or several,
    data-major, as a PartitionSpec of those axes lays the blocks out."""
    names = (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)
    index, count = 0, 1
    for name in names:
        size = axis_size(mesh, name)
        index, count = index * size + axis_rank(mesh, name), count * size
    return index, count


def shard_batch(batch, mesh: DeviceMesh, axis_name: Union[str, Sequence[str]] = DATA_AXIS):
    """This rank's contiguous block of the leading axis of every array of a
    pytree (tensors or numpy arrays), over `axis_name` or, for a tuple of
    axes, over their product in data-major order.  Raises ValueError if the
    leading axis does not divide."""
    index, count = _block(mesh, axis_name)

    def take(x):
        b = x.shape[0]
        if b % count:
            raise ValueError(f"a leading axis of {b} does not divide over {count} devices of {axis_name!r}")
        step = b // count
        return x[index * step:(index + 1) * step]

    return _tree_map(take, batch)


def replicate(module_or_tree, mesh: Optional[DeviceMesh] = None):
    """Broadcast every parameter and buffer of a module, every state tensor
    of an optimizer, or every tensor of a pytree from rank 0, in place;
    returns its argument.  The mesh spans the process group."""
    if isinstance(module_or_tree, torch.nn.Module):
        tensors = [t.data for t in module_or_tree.parameters()] + list(module_or_tree.buffers())
    elif isinstance(module_or_tree, torch.optim.Optimizer):
        tensors = [v for state in module_or_tree.state.values() for v in state.values()
                   if isinstance(v, torch.Tensor)]
    else:
        tensors = [t for t in _tree_leaves(module_or_tree) if isinstance(t, torch.Tensor)]
    with torch.no_grad():
        for t in tensors:
            if t.device.type == "cpu" and dist.get_backend() == "nccl":
                # NCCL moves device memory only: a host tensor (Adam's step count) goes by the card
                staged = t.to(_rank_device)
                dist.broadcast(staged, src=0)
                t.copy_(staged)
            else:
                dist.broadcast(t, src=0)
    return module_or_tree


def pad_batch_to_devices(batch, n_devices: int):
    """Pad the leading axis of every array of a pytree with zeros to a
    multiple of the device count (eval tails); returns (padded batch, valid
    mask (padded b,) bool)."""
    leaves = _tree_leaves(batch)
    b = leaves[0].shape[0]
    padded_b = -(-b // n_devices) * n_devices
    pad = padded_b - b

    def pad_leaf(x):
        if pad == 0:
            return x
        if isinstance(x, np.ndarray):
            return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

    first = leaves[0]
    mask = (np.arange(padded_b) < b) if isinstance(first, np.ndarray) else (
        torch.arange(padded_b, device=first.device) < b)
    return _tree_map(pad_leaf, batch), mask


# ------------------------------------------------------------- collectives


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum x over the ranks of `group`, in place (no-op without a group)."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


class AllReduceSum(torch.autograd.Function):
    """A sum over the ranks of a group whose gradient is the sum of the
    ranks' gradients: what a statistic over the whole batch needs, as each
    rank's loss reaches it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.clone(memory_format=torch.contiguous_format), ctx.group), None


def all_gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' blocks of `group`, concatenated along the leading axis in
    rank order (x itself without a group)."""
    if group is None:
        return x
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def all_gather_tree(tree, group):
    """all_gather_cat of every tensor of a pytree, one collective per dtype
    (bool travels as uint8): each leaf's blocks concatenated along its
    leading axis in rank order."""
    if group is None:
        return tree
    world = dist.get_world_size(group)
    leaves = [t for t in _tree_leaves(tree) if isinstance(t, torch.Tensor)]
    by_dtype = {}
    for t in leaves:
        by_dtype.setdefault(torch.uint8 if t.dtype == torch.bool else t.dtype, []).append(t)
    gathered = {}
    for dtype, ts in by_dtype.items():
        flat = torch.cat([t.reshape(-1).to(dtype) for t in ts])
        full = all_gather_cat(flat, group).reshape(world, -1)
        off = 0
        for t in ts:
            n = t.numel()
            part = full[:, off:off + n].reshape((world * t.shape[0],) + tuple(t.shape[1:]))
            gathered[id(t)] = part.to(t.dtype)
            off += n
    return _tree_map(lambda t: gathered[id(t)] if isinstance(t, torch.Tensor) else t, tree)


# ------------------------------------------------------------------ ranks


def _rank_main(rank, fn, world_size, init_method, device, backend, args, result_path):
    dev = init_distributed(rank, world_size, init_method, device, backend)
    try:
        out = fn(rank, dev, *args)
        if rank == 0:
            torch.save(out, result_path)
    finally:
        dist.destroy_process_group()


def spawn(fn, n: int, device, *args, backend: Optional[str] = None):
    """Run fn(rank, device, *args) on n ranks, each a process started with
    torch.multiprocessing's "spawn" method that has joined the process group
    (`init_distributed`, through a fresh `file://` rendezvous in a temporary
    directory); returns rank 0's return value (through a file there).  fn
    must be importable by name.  If a rank raises, the others are stopped
    and the error is raised here."""
    with tempfile.TemporaryDirectory(prefix="hf_ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        result_path = os.path.join(tmp, "rank0_result.pt")
        mp.spawn(_rank_main, args=(fn, n, init_method, str(device), backend, args, result_path), nprocs=n,
                 join=True, start_method="spawn")
        return torch.load(result_path, weights_only=False)
