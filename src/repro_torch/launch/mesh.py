"""Device meshes over ``torch.distributed`` (the port's twin of
``repro.launch.mesh.make_cpu_mesh`` and of ``repro.compat``'s
``make_mesh``/``set_mesh``/``use_mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
(``("data", "model")``, or ``("pod", "data", "model")``), one rank a
device. It is built over a default process group that the caller made
(:func:`init_world`, or ``torch.distributed.init_process_group`` with its
own address, rank, world size and a timeout): nothing here reads the
environment or starts a group by itself.

The ambient mesh (:func:`set_mesh`, :func:`use_mesh`) is what the model's
activation hints (``models.layers.constrain``/``axis_size``) resolve
against, as the reference's hints resolve against JAX's ambient mesh. No
ambient mesh means no hints.

The production meshes keep the reference's shapes and dim names: one pod
of 256 devices as (16, 16) ``("data", "model")``, two pods as
(2, 16, 16) ``("pod", "data", "model")``. :func:`init_fake_world` opens a
``fake`` process group of that size in one process (it communicates
nothing: a collective returns its output buffer unfilled), which is what
the dry-run lays its ``meta`` tensors out on. :func:`make_production_mesh`
is a function, never a module constant: importing this module builds no
mesh and opens no group.
"""

from __future__ import annotations

import contextlib
import datetime
from collections.abc import Mapping

import torch
import torch.distributed as dist

from repro_torch import device as device_lib

__all__ = ["init_world", "init_fake_world", "make_mesh",
           "make_production_mesh", "make_cpu_mesh", "SINGLE_POD_SHAPE",
           "MULTI_POD_SHAPE", "set_mesh", "get_mesh", "use_mesh",
           "mesh_shape", "MAX_TIMEOUT_S"]

SINGLE_POD_SHAPE = (16, 16)              # 256 devices (one pod)
MULTI_POD_SHAPE = (2, 16, 16)            # 2 pods = 512 devices

#: The longest a collective may wait before it fails (seconds): a hung
#: collective raises instead of stalling its caller.
MAX_TIMEOUT_S = 60.0


def _device_type(device_type: str | None) -> str:
    """``None`` -> ``"cuda"`` (raises without a card), else as given."""
    return device_lib.resolve(device_type).type


def init_world(init_method: str, rank: int, world_size: int, *,
               device_type: str | None = None,
               timeout_s: float = MAX_TIMEOUT_S) -> None:
    """The default process group of one rank: ``nccl`` on the card (bound
    to the current card), ``gloo`` on the CPU. ``init_method`` is an
    explicit address (``file://...`` or ``tcp://localhost:<port>``);
    ``timeout_s`` is at most :data:`MAX_TIMEOUT_S`."""
    if not 0 < timeout_s <= MAX_TIMEOUT_S:
        raise ValueError(f"timeout_s {timeout_s} must be in (0, "
                         f"{MAX_TIMEOUT_S}]")
    kind = _device_type(device_type)
    kwargs = {}
    if kind == "cuda":
        kwargs["device_id"] = torch.device("cuda",
                                           torch.cuda.current_device())
    dist.init_process_group(
        "nccl" if kind == "cuda" else "gloo", init_method=init_method,
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)


def init_fake_world(world_size: int) -> None:
    """The default process group as a ``fake`` group of ``world_size``
    ranks, this process being rank 0: a one-process stand-in for a
    cluster (``torch.testing``'s ``FakeStore``). Collectives run no
    communication. Destroy it with
    ``torch.distributed.destroy_process_group()``."""
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _production(multi_pod: bool) -> tuple[tuple[int, ...], tuple[str, ...]]:
    if multi_pod:
        return MULTI_POD_SHAPE, ("pod", "data", "model")
    return SINGLE_POD_SHAPE, ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """The production mesh — (16, 16) ``("data", "model")``, or (2, 16, 16)
    ``("pod", "data", "model")`` with ``multi_pod`` — over the default
    process group, whose world must be 256 (512) ranks: a real cluster's,
    or :func:`init_fake_world`'s."""
    return make_mesh(*_production(multi_pod), device_type=device_type)


def make_cpu_mesh(shape: tuple[int, ...], names: tuple[str, ...]):
    """A small mesh of CPU ranks (gloo, or a fake group) for tests."""
    return make_mesh(shape, names, device_type="cpu")


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...], *,
              device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` with dims ``names`` over the default
    process group (``device_type`` None -> the card). The mesh's size must
    be the world's."""
    from torch.distributed.device_mesh import init_device_mesh
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in "
                         f"length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a default process group: call "
                           "init_world (or init_process_group) first")
    size = 1
    for n in shape:
        size *= n
    if size != dist.get_world_size():
        raise ValueError(f"mesh shape {shape} holds {size} ranks; the "
                         f"world has {dist.get_world_size()}")
    return init_device_mesh(_device_type(device_type), tuple(shape),
                            mesh_dim_names=tuple(names))


def mesh_shape(mesh) -> dict[str, int]:
    """``{name: size}`` of a ``DeviceMesh`` (or of a ``{name: size}``
    mapping, returned as a dict)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


_AMBIENT = None


def set_mesh(mesh) -> None:
    """Make ``mesh`` (or None) the ambient mesh."""
    global _AMBIENT
    _AMBIENT = mesh


def get_mesh():
    """The ambient mesh, or None."""
    return _AMBIENT


@contextlib.contextmanager
def use_mesh(mesh):
    """``mesh`` as the ambient mesh inside the block; the previous one
    after it."""
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)
