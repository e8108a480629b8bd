"""Device meshes over the ranks (the port's ``parallel/mesh.py``).

A JAX ``Mesh`` is a grid of devices with named axes; here it is a grid of
RANKS (one process per device, ``parallel/dist.py``) with the same axis
names, ``client``, ``data``, ``model``, ``pipe`` and ``seq``, so one word
names one axis in both packages. Inside a process group the mesh holds a
``torch.distributed.device_mesh.DeviceMesh`` over that grid and one process
group per axis (``group(axis)``: the ranks that differ only along it); outside
one it is the layout alone, which the tests hold against JAX's.

  * ``client``: federated clients; each ``client`` coordinate trains its
    share of the round's sampled clients and the FedAvg sums are
    all-reduced over this axis;
  * ``data``: batch rows inside a client (or the Trainer), with one gradient
    all-reduce per step.

``make_multislice_mesh`` keeps each client's ``data`` ranks inside one slice.
On GPUs a slice is a node (NVLink inside it, the network between nodes);
membership comes from ``LOCAL_WORLD_SIZE`` (the ranks per node), and
``num_slices`` overrides it, as in JAX.

``shard_leading_axis(mesh, axis)`` and ``replicated(mesh)`` answer which of
``n`` rows or clients this rank holds: a contiguous block along ``axis``
(uneven counts give the first ``n % size`` coordinates one more), or all.
"""

from __future__ import annotations

import os

import numpy as np

from . import dist as pdist


class Mesh:
    """A grid of ranks with named axes (``devices``, ``axis_names``,
    ``shape`` as JAX's ``Mesh``). ``bind()`` makes its process groups; it is
    collective over the world, whose size must be the mesh's."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.device_mesh = None

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def bind(self, device_type: str = "cpu") -> "Mesh":
        import torch
        from torch.distributed.device_mesh import DeviceMesh

        if self.device_mesh is None:
            if self.size != pdist.world_size():
                raise ValueError(f"mesh of {self.size} ranks in a world of "
                                 f"{pdist.world_size()}")
            self.device_mesh = DeviceMesh(device_type, torch.as_tensor(self.devices),
                                          mesh_dim_names=self.axis_names)
        return self

    def axis_size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def group(self, axis: str):
        """The process group along ``axis`` (None for an absent axis)."""
        if axis not in self.shape:
            return None
        if self.device_mesh is None:
            raise RuntimeError("Mesh.bind() first: the mesh has no process groups")
        return self.device_mesh.get_group(axis)

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 for an absent axis)."""
        if axis not in self.shape:
            return 0
        where = np.argwhere(self.devices == pdist.rank())
        return int(where[0][self.axis_names.index(axis)])

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_mesh(client: int = 1, data: int | None = None, devices=None,
              model: int = 1) -> Mesh:
    """A (client, data) mesh, or (client, data, model) when ``model > 1``.
    ``data=None`` uses all remaining ranks; ``devices`` defaults to the
    world's ranks (or the device count outside a process group)."""
    devices = list(devices if devices is not None else _default_devices())
    if data is None:
        data = max(len(devices) // (client * model), 1)
    n = client * data * model
    if n > len(devices):
        raise ValueError(
            f"mesh {client}x{data}" + (f"x{model}" if model > 1 else "")
            + f" needs {n} devices, have {len(devices)}")
    if model > 1:
        return Mesh(np.array(devices[:n]).reshape(client, data, model),
                    ("client", "data", "model"))
    return Mesh(np.array(devices[:n]).reshape(client, data), ("client", "data"))


def make_multislice_mesh(client: int = 1, data: int = 1, num_slices: int | None = None,
                         devices=None) -> Mesh:
    """A (client, data) mesh laid out slice-aware: each client's ``data``
    ranks inside one slice, clients spread over the slices (client axis
    slice-major), so the per-step gradient all-reduce stays inside a node and
    only the round's FedAvg sums cross nodes. Slices are ``LOCAL_WORLD_SIZE``
    consecutive ranks (all ranks when unset); ``num_slices`` overrides them
    with equal contiguous groups."""
    devices = list(devices if devices is not None else _default_devices())
    if num_slices is None:
        per = int(os.environ.get("LOCAL_WORLD_SIZE", len(devices)))
        groups = [devices[i:i + per] for i in range(0, len(devices), per)]
    else:
        if len(devices) % num_slices:
            raise ValueError(
                f"{len(devices)} devices do not split into {num_slices} slices")
        per = len(devices) // num_slices
        groups = [devices[i * per:(i + 1) * per] for i in range(num_slices)]
    n_slices = len(groups)
    if client % n_slices:
        raise ValueError(
            f"client axis ({client}) must be a multiple of the slice count "
            f"({n_slices}) so clients divide evenly across slices")
    per_slice_clients = client // n_slices
    need = per_slice_clients * data
    rows = []
    for g in groups:
        if need > len(g):
            raise ValueError(
                f"each slice must hold {per_slice_clients} clients x {data} "
                f"data devices = {need}, slice has {len(g)}")
        rows.append(np.array(g[:need]).reshape(per_slice_clients, data))
    return Mesh(np.concatenate(rows, axis=0), ("client", "data"))


def _default_devices() -> list[int]:
    """The world's ranks, or outside a process group the devices a layout
    may place ranks on."""
    import torch

    if pdist.is_parallel():
        return list(range(pdist.world_size()))
    return list(range(pdist.device_count("cuda" if torch.cuda.is_available() else "cpu")))


def block(n: int, size: int, index: int) -> range:
    """Index ``index``'s contiguous block of ``n`` items split over ``size``
    (the first ``n % size`` blocks one longer)."""
    q, r = divmod(n, size)
    start = index * q + min(index, r)
    return range(start, start + q + (index < r))


def shard_leading_axis(mesh: Mesh, axis: str = "client"):
    """``fn(n) -> range``: the leading-axis rows this rank holds along ``axis``."""
    return lambda n: block(n, mesh.axis_size(axis), mesh.coord(axis))


def replicated(mesh: Mesh):
    """``fn(n) -> range``: every row (replicated on every rank)."""
    return lambda n: range(n)
