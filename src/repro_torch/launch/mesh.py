"""Mesh builders, the torch twin of ``repro.launch.mesh``.

:func:`make_production_mesh` describes the reference's production meshes
(sizes and axis names, no process group): what the dry run takes.
:func:`make_test_mesh` builds a real mesh over the ranks of an initialised
``torch.distributed`` process group with ``init_device_mesh``, its
``mesh_dim_names`` the reference's axis names.  :func:`init_distributed`
starts that group with the backend chosen explicitly (:func:`backend_for`).
"""
from __future__ import annotations

import itertools
from typing import Optional, Sequence

import torch

from repro_torch.distributed.ctx import Mesh, replica_axis


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single pod (256 chips) or 2x16x16 two-pod (512 chips) mesh,
    described (a dry mesh: no process group).

    Axes: ``data`` is the batch/FSDP axis, ``model`` the tensor/expert
    parallel axis; ``pod`` (multi-pod only) is pure data parallelism.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape, dry=True)


def backend_for(device, world_size: int) -> str:
    """``nccl`` when each rank has a card of its own, ``gloo`` on the CPU
    or when ranks share a card (NCCL refuses two ranks on one device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(rank: int, world_size: int, port: int, device,
                     backend: Optional[str] = None) -> str:
    """Join the process group at ``tcp://localhost:<port>`` as ``rank`` of
    ``world_size``; returns the backend."""
    import torch.distributed as dist
    backend = backend or backend_for(device, world_size)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world_size)
    return backend


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A real mesh of ``shape`` over the initialised process group (its
    world size the shape's product), with the group of every set of axes
    and of every run of ``r`` consecutive ``model`` ranks, ``r`` a proper
    divisor of its size (``ctx.replica_axis``; all ranks create every
    group, in one order)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    backend = dist.get_backend()
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu",
                          tuple(shape), mesh_dim_names=tuple(axis_names))
    mesh = Mesh(axis_names, shape, dry=False, device_mesh=dm,
                backend=backend)
    mesh.coords = mesh.coords_of(dist.get_rank())
    names = tuple(axis_names)
    for r in range(1, len(names) + 1):
        for axes in itertools.combinations(names, r):
            rest = [a for a in names if a not in axes]
            others = itertools.product(*[range(mesh.sizes[a]) for a in rest])
            for fixed in others:
                pos = dict(zip(rest, fixed))
                ranks = sorted(mesh.rank_of(c) for c in itertools.product(
                    *[range(mesh.sizes[a]) if a in axes else (pos[a],)
                      for a in names]))
                grp = (dm.get_group(axes[0]) if len(axes) == 1
                       else dist.new_group(ranks, backend=backend))
                if mesh.rank in ranks:
                    mesh.groups[frozenset(axes)] = grp
    # the runs of r consecutive ``model`` ranks (a replicated KV head's)
    m = mesh.sizes.get("model", 1)
    for r in (r for r in range(2, m) if m % r == 0):
        for c in itertools.product(*[range(s) for s in mesh.shape]):
            at = dict(zip(names, c))
            if at["model"] % r:
                continue
            ranks = [mesh.rank_of(tuple(at[a] + (i if a == "model" else 0)
                                        for a in names)) for i in range(r)]
            grp = dist.new_group(ranks, backend=backend)
            if mesh.rank in ranks:
                mesh.groups[frozenset((replica_axis(r),))] = grp
    return mesh


def make_test_mesh(n_data: int = 2, n_model: int = 4) -> Mesh:
    """A (``data``, ``model``) mesh over the initialised process group."""
    return make_mesh((n_data, n_model), ("data", "model"))
