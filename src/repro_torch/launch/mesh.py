"""The production meshes on ``torch.distributed`` (port of
``repro/launch/mesh.py``).

Functions, never module-level meshes: importing this module starts no
process group. A mesh is a ``torch.distributed.device_mesh.DeviceMesh``
with the reference's axis names, ``("data", "model")`` on one pod and
``("pod", "data", "model")`` across two.

The production meshes span 256 or 512 ranks that one machine does not
have. Where the reference forces that many placeholder XLA host devices,
the port starts torch's fake process group (``start_fake_world``): a world
of that size in one process, whose collectives move nothing. Its meshes
describe placements (``sharding.specs``) and local shapes; no tensor lives
on them. ``make_host_mesh`` builds a mesh over the real world instead.
"""
from __future__ import annotations

SINGLE_POD_AXES = ("data", "model")
MULTI_POD_AXES = ("pod", "data", "model")


def production_mesh_shape(*, multi_pod: bool = False) -> tuple:
    """The reference's production layout: a 16x16 pod of 256 chips; two
    pods of them, 512 chips, multi-pod."""
    return (2, 16, 16) if multi_pod else (16, 16)


def production_chip_count(*, multi_pod: bool = False) -> int:
    n = 1
    for v in production_mesh_shape(multi_pod=multi_pod):
        n *= v
    return n


def start_fake_world(world_size: int) -> None:
    """Start torch's fake process group of ``world_size`` ranks in this
    process, as rank 0 (the counterpart of XLA's forced host devices).
    Stop it with ``stop_world``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already running in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def stop_world() -> None:
    """Destroy the default process group (and every mesh's subgroups)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) or (2, 16, 16) mesh over a world of exactly that many
    ranks (``start_fake_world(production_chip_count(...))``). Its device
    type is ``cpu``: the fake world computes nothing, on any device."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = production_mesh_shape(multi_pod=multi_pod)
    n = production_chip_count(multi_pod=multi_pod)
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else "no"
        raise RuntimeError(f"make_production_mesh needs a world of {n} ranks ({have} "
                           f"running): start_fake_world({n}) first")
    axes = MULTI_POD_AXES if multi_pod else SINGLE_POD_AXES
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_host_mesh(model_axis: int = 1, device=None):
    """A (world / model_axis, model_axis) ``("data", "model")`` mesh over
    the ranks of the running process group (``sharding.ranks``,
    ``torchrun``). ``device=None`` is the card (NCCL); ``device="cpu"`` a
    gloo world's CPU ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.device import resolve_device

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs a process group: start the ranks with "
                           "repro_torch.sharding.ranks or torchrun")
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"{n} ranks do not split into a model axis of {model_axis}")
    return init_device_mesh(resolve_device(device).type, (n // model_axis, model_axis),
                            mesh_dim_names=SINGLE_POD_AXES)


def axis_sizes(mesh) -> dict:
    """{axis name: size}, the reference's ``mesh.shape``. A ``DeviceMesh``
    keeps its names and sizes apart; any object whose ``shape`` is already
    such a dict (a mesh described without ranks) is read as it is."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, (int(v) for v in mesh.shape)))


def mesh_chips(mesh) -> int:
    n = 1
    for v in axis_sizes(mesh).values():
        n *= v
    return n


def mesh_label(mesh) -> str:
    return "x".join(str(v) for v in axis_sizes(mesh).values())
