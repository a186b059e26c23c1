"""Device meshes (port of ``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
world's ranks, built by ``init_device_mesh`` on the card unless the CPU
is asked for; its axes carry the reference's names (``pod``, ``data``,
``model``, ``pipe``). Nothing here runs at import: the process group is
the caller's (``torch.distributed.init_process_group``), or, for the dry
run, ``fake_world``'s.

``axis_group(mesh, axes)`` is the process group over one or several
axes: a mesh axis's own, or, for several, a group made once a mesh for
every coordinate of the other axes (all ranks make the same groups in
the same order, as ``torch.distributed.new_group`` asks).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device

#: the reference's production meshes: one pod of 16 x 16, two of them
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device=None):
    """A DeviceMesh of ``shape`` named ``axes`` over the world's ranks, on
    the card unless ``device`` says otherwise (the CPU for gloo on the
    host and for the dry run)."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    return init_device_mesh(dev.type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape, axes = PRODUCTION[multi_pod]
    return make_mesh(shape, axes, device)


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes the batch/FSDP dimension shards over: ('pod','data') when a pod
    axis exists, else ('data',)."""
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names) or (names[0],)


def fsdp_axis(mesh):
    da = data_axes(mesh)
    return da if len(da) > 1 else da[0]


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


#: groups over several axes, by (id of the mesh, axes): (mesh, group)
_GROUPS: Dict[tuple, tuple] = {}


def axis_group(mesh, axes: Tuple[str, ...]):
    """The process group of this rank over ``axes`` (one or more of the
    mesh's), its ranks ordered major axis first as ``spec_for`` orders a
    dim's axes. A group over several axes is made at the first call
    (every rank must make that call, in the same order)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        names = mesh.mesh_dim_names
        t = mesh.mesh.permute(
            [names.index(a) for a in names if a not in axes]
            + [names.index(a) for a in axes])
        ranks = t.reshape(-1, t[(0,) * (len(names) - len(axes))].numel())
        mine, _ = dist.new_subgroups_by_enumeration(ranks.tolist())
        _GROUPS[key] = (mesh, mine)    # the mesh kept: its id stays its own
    return _GROUPS[key][1]


def forget_groups() -> None:
    """Drop the cached groups (the world they were made in has ended)."""
    _GROUPS.clear()


def fake_world(n: int, rank: int = 0) -> None:
    """Start a process group of ``n`` ranks in which this process is
    ``rank`` and no other exists: every collective returns at once and
    moves nothing. The dry run traces one rank's step in it. The one
    place that touches torch's private ``fake_pg`` module."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already running")
    forget_groups()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)


def end_world() -> None:
    """Destroy the default process group and the groups made from it."""
    forget_groups()
    if dist.is_initialized():
        dist.destroy_process_group()


def mesh_from_spec(mesh_spec: str, device="cpu"):
    """``pod`` | ``multipod`` | ``AxB`` | ``AxBxC`` as the reference's
    dry run names meshes."""
    if mesh_spec in ("pod", "multipod"):
        return make_production_mesh(multi_pod=mesh_spec == "multipod",
                                    device=device)
    dims = tuple(int(x) for x in mesh_spec.split("x"))
    names = (("data", "model")[:len(dims)] if len(dims) <= 2
             else ("pod", "data", "model"))
    return make_mesh(dims, names, device)


def mesh_size(mesh_spec: str) -> int:
    if mesh_spec in ("pod", "multipod"):
        shape = PRODUCTION[mesh_spec == "multipod"][0]
    else:
        shape = tuple(int(x) for x in mesh_spec.split("x"))
    n = 1
    for s in shape:
        n *= s
    return n


def local_device(device=None) -> torch.device:
    """The device this rank computes on: the card (every rank of one host
    on the card ``LOCAL_RANK`` modulo the host's cards) unless
    ``device`` says otherwise."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        import os
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                           % torch.cuda.device_count())
    return dev
