"""Multi-process runtime: process init, the hosts x chips mesh, sharded batches.

Port of ``ndtpso_slam_tpu/parallel/runtime.py`` on ``torch.distributed``.
One process (a rank) drives one device.  A :class:`Mesh` lays the ranks out
hosts-major, ``rank = host · chips + chip``: the outer axis
(:data:`DCN_AXIS`) crosses hosts, the inner one (:data:`ICI_AXIS`) stays
within a host's devices, as the JAX package's hierarchical mesh does.  A
flat mesh (``parallel/mesh.py:make_mesh``) has the one axis ``"solves"``.

Process bootstrap is the JAX package's, through the same variables, or
torchrun's:

    NDTPSO_COORDINATOR=host:port   rank 0's address (``init_method`` tcp://)
    NDTPSO_NUM_PROCESSES=N         world size
    NDTPSO_PROCESS_ID=i            this process's rank

or ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.  With
nothing configured the process stays alone: every mesh is one rank and
every sharded call is the unsharded call.

Backends: NCCL when the rank's device is a GPU, gloo on the CPU, unless the
caller names one.  NCCL refuses two ranks on one GPU, so ranks that share a
card run gloo.  Both take the rank's CUDA tensors as they are for the
collectives used here (``all_reduce``, ``all_gather``; gloo stages them in
host memory itself), so no collective copies through the host; each mesh
counts its calls by (collective, backend, the tensor's device) in
:attr:`Mesh.routes`.

Rows: a batch of B sharded over D ranks gives rank r rows
``[r·B/D, (r+1)·B/D)`` (:func:`shard_rows`; D must divide B).  Sharded entry
points take a rank's rows and return its rows; :func:`gather_global` reads
the whole batch on every rank, in rank order.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ndtpso_slam_tpu_torch.config import DEFAULT_DEVICE, resolve_device

DCN_AXIS = "hosts"
ICI_AXIS = "chips"
SOLVE_AXES: Tuple[str, str] = (DCN_AXIS, ICI_AXIS)


def distributed_config(coordinator_address=None, num_processes=None, process_id=None):
    """(address, world size, rank) by precedence: the arguments, then
    ``NDTPSO_COORDINATOR`` / ``NDTPSO_NUM_PROCESSES`` / ``NDTPSO_PROCESS_ID``,
    then torchrun's ``MASTER_ADDR:MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``.
    None when no address and no world size is configured."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("NDTPSO_COORDINATOR")
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    for name in ("NDTPSO_NUM_PROCESSES", "WORLD_SIZE"):
        if num_processes is None and name in env:
            num_processes = int(env[name])
    for name in ("NDTPSO_PROCESS_ID", "RANK"):
        if process_id is None and name in env:
            process_id = int(env[name])
    if coordinator_address is None and num_processes is None:
        return None
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            f"incomplete distributed configuration: address {coordinator_address!r}, "
            f"world size {num_processes!r}, rank {process_id!r}"
        )
    return coordinator_address, int(num_processes), int(process_id)


def rank_device(device=DEFAULT_DEVICE, local_rank: Optional[int] = None) -> torch.device:
    """This rank's device.  A CUDA device without an index becomes
    ``cuda:(local rank % device count)`` (``LOCAL_RANK``, else the rank), so
    on one card every rank uses ``cuda:0``; the CPU only when asked; a CUDA
    device with no GPU raises."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=DEFAULT_DEVICE,
) -> bool:
    """Join the world of ranks.  Returns True if a multi-process runtime is
    up (idempotent: True again once initialized), False when nothing is
    configured (the single-process path).  ``backend`` defaults to "nccl"
    when this rank's device (:func:`rank_device`) is a GPU and "gloo" on
    the CPU."""
    if dist.is_initialized():
        return True
    found = distributed_config(coordinator_address, num_processes, process_id)
    if found is None:
        return False
    address, world, rank = found
    dev = rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world, rank=rank)
    return True


@dataclasses.dataclass(eq=False)
class Mesh:
    """Ranks laid out over named axes, outermost first (rank = the
    row-major index of its coordinates), with a process group for every
    set of axes.  At world 1 (nothing initialized) every group is None and
    every collective returns its input."""

    axes: Tuple[str, ...]
    shape: Tuple[int, ...]
    device: torch.device
    rank: int = 0
    groups: Dict[frozenset, object] = dataclasses.field(default_factory=dict)
    routes: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def coords(self, rank: int) -> Dict[str, int]:
        return dict(zip(self.axes, np.unravel_index(rank, self.shape)))

    def axis_names(self, axes) -> Tuple[str, ...]:
        """``axes`` (one name or a sequence) as a tuple of this mesh's axes."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in names if a not in self.axes]
        if unknown or len(set(names)) != len(names) or not names:
            raise ValueError(f"axes {axes!r} are not distinct axes of the mesh {self.axes}")
        return names

    def members(self, axes) -> list:
        """The ranks that share this rank's coordinates off ``axes``, in the
        order of a gather over ``axes`` (the first axis named outermost), as
        ``jax.lax.all_gather`` orders a tuple of axes."""
        names = self.axis_names(axes)
        mine = self.coords(self.rank)
        same = [r for r in range(self.size)
                if all(c == mine[a] for a, c in self.coords(r).items() if a not in names)]
        return sorted(same, key=lambda r: tuple(self.coords(r)[a] for a in names))

    def index(self, axes) -> Tuple[int, int]:
        """(this rank's position along ``axes``, the ranks along them)."""
        members = self.members(axes)
        return members.index(self.rank), len(members)


def world_size() -> int:
    """The ranks of the world: 1 when nothing is initialized."""
    return dist.get_world_size() if dist.is_initialized() else 1


def mesh_over(axes, shape, device=DEFAULT_DEVICE) -> Mesh:
    """A mesh of the world's ranks over ``axes`` of ``shape`` (their product
    the world size), every rank calling ``new_group`` for every group in
    one order."""
    world = world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {int(np.prod(shape))} "
                         f"ranks; the world has {world}")
    mesh = Mesh(tuple(axes), tuple(int(s) for s in shape), rank_device(device),
                dist.get_rank() if dist.is_initialized() else 0)
    if not dist.is_initialized():
        return mesh
    for k in range(1, len(axes) + 1):
        for names in itertools.combinations(axes, k):
            classes = {}
            for r in range(world):
                off = tuple(c for a, c in mesh.coords(r).items() if a not in names)
                classes.setdefault(off, []).append(r)
            for ranks in classes.values():
                group = dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)
                if mesh.rank in ranks:
                    mesh.groups[frozenset(names)] = group
    return mesh


def make_hier_mesh(n_hosts: Optional[int] = None, chips_per_host: Optional[int] = None,
                   device=DEFAULT_DEVICE) -> Mesh:
    """The ``(hosts, chips)`` mesh: ranks ``h·chips … h·chips + chips - 1``
    are host h's.  With neither count given the world is one host; with one
    given the other follows; the product must be the world size."""
    world = world_size()
    if n_hosts is None and chips_per_host is None:
        n_hosts = 1
    if n_hosts is None:
        n_hosts = world // chips_per_host
    if chips_per_host is None:
        chips_per_host = world // n_hosts
    return mesh_over(SOLVE_AXES, (n_hosts, chips_per_host), device)


def _count(mesh: Mesh, group, op: str, tensor: torch.Tensor) -> None:
    mesh.routes[(op, dist.get_backend(group), tensor.device.type)] += 1


def all_reduce(mesh: Mesh, tensor: torch.Tensor, axes) -> torch.Tensor:
    """The sum of ``tensor`` over the ranks along ``axes``, the same bits on
    each (a new tensor; the input is left as it is)."""
    group = mesh.groups.get(frozenset(mesh.axis_names(axes)))
    out = tensor.clone()
    if group is not None:
        _count(mesh, group, "all_reduce", out)
        dist.all_reduce(out, group=group)
    return out


def all_gather(mesh: Mesh, tensor: torch.Tensor, axes) -> torch.Tensor:
    """[D, ...]: ``tensor`` of each of the D ranks along ``axes``, in the
    order of :meth:`Mesh.members`."""
    names = mesh.axis_names(axes)
    group = mesh.groups.get(frozenset(names))
    if group is None:
        return tensor[None].clone()
    src = tensor.contiguous()
    _count(mesh, group, "all_gather", src)
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    # The group's ranks in ascending order; the gather's order may differ.
    ascending = sorted(mesh.members(names))
    return torch.stack([parts[ascending.index(r)] for r in mesh.members(names)])


def _tree_map(fn, tree):
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    return tree


def _on(device):
    def put(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x.astype(np.int64) if x.dtype == np.uint32 else x)
        return x.to(device)

    return put


def shard_rows(mesh: Mesh, batch, axes=None):
    """This rank's rows of a whole batch (a tensor, array or tree of them,
    leading axis B) sharded over ``axes`` (default: every mesh axis): rows
    ``[i·B/D, (i+1)·B/D)`` for the rank's position i of D along them.  D
    must divide B."""
    i, d = mesh.index(mesh.axes if axes is None else axes)

    def rows(x):
        b = x.shape[0]
        if b % d:
            raise ValueError(f"a batch of {b} rows does not divide over {d} ranks")
        return x[i * (b // d):(i + 1) * (b // d)]

    return _tree_map(rows, batch)


def shard_global(mesh: Mesh, spec, local_batch):
    """This rank's rows of a batch sharded over the axes ``spec`` names, on
    the rank's device: what the sharded entry points take (JAX: a global
    array from each process's local data).  ``spec`` is only validated: the
    caller cuts its rows with :func:`shard_rows`, so this is
    :func:`replicate_global` of them."""
    mesh.axis_names(spec)
    return replicate_global(mesh, local_batch)


def replicate_global(mesh: Mesh, value):
    """``value`` (every rank passes the same, e.g. a shared map snapshot) on
    the rank's device."""
    return _tree_map(_on(mesh.device), value)


def gather_global(mesh: Mesh, local, axes=None):
    """The whole batch on every rank: the ranks' rows along ``axes``
    (default: every mesh axis, in rank order) concatenated in the order of
    their positions."""
    axes = mesh.axes if axes is None else axes
    return _tree_map(lambda x: all_gather(mesh, x, axes).flatten(0, 1), local)


def make_hier_solver(mesh: Mesh, map_cfg, pso_cfg, cost_mode: str = "fast",
                     shared_map: bool = False):
    """``parallel/mesh.py:make_sharded_solver`` over both mesh axes: the
    batch split over hosts x chips.  Independent solves need no
    collective."""
    from ndtpso_slam_tpu_torch.parallel import mesh as mesh_mod

    return mesh_mod.make_sharded_solver(mesh, map_cfg, pso_cfg, cost_mode=cost_mode,
                                        shared_map=shared_map, axes=SOLVE_AXES)
