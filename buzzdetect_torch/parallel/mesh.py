"""Device mesh and sharding helpers for scale-out within one process and
across hosts.

Copy of ``buzzdetect_tpu/parallel/mesh.py``. Edits:

* ``Mesh`` is the port's own: an ndarray of ``torch.device``s with
  ``axis_names``, as ``jax.sharding.Mesh`` holds them, and no ambient
  context manager (the mesh is always passed explicitly). ``make_mesh``
  takes the JAX forms (1-D over ``axis``; ``shape``/``axes`` for the
  trainer's 2-D mesh) plus ``device``, the device type an int counts; an
  explicit list may name one device more than once (a mesh that repeats
  one card); an int larger than the attached devices raises where JAX
  builds a smaller mesh; a mesh of mixed device types raises;
* ``data_sharding`` and ``replicated_sharding`` return a ``Sharding``
  ``(mesh, spec)`` descriptor; the port's classifier runs a sharding
  exactly as its mesh;
* ``split`` and ``gather`` are the port's one way to spread a tensor over a
  mesh axis and bring it back (GSPMD does it inside the JAX graph);
* ``resolve_replica_devices`` resolves torch devices: an int or ``'all'``
  counts the devices of the caller's ``device`` type (the CUDA cards, or
  the one CPU), and an explicit list may name one device more than once;
* ``shard_files`` takes its default ``(host_id, n_hosts)`` from
  ``process_rank()``, the ``torch.distributed`` rank and world size where a
  process group is up, else ``(0, 1)``, as JAX answers in one process.

Design: inference is pure data parallelism. Within a process, ``mesh=``
splits one chunk's patch axis over the mesh's ``'data'`` axis (one process
drives every device of the mesh, as JAX's single controller does; no
process group, so a mesh may repeat one card), and ``devices=`` gives each
device a replica fed whole chunks. Across hosts, *files* shard by a stable
hash, so hosts share one output folder and need no communication
(completion state is the filesystem).
"""

import hashlib
import os
from typing import NamedTuple

import numpy as np
import torch


def process_rank():
    """``(rank, world_size)`` of this process: ``torch.distributed``'s where
    a process group is initialized, else ``(0, 1)``."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _local_devices(kind: str):
    if kind == 'cuda':
        return [torch.device('cuda', i)
                for i in range(torch.cuda.device_count())]
    if kind == 'cpu':
        return [torch.device('cpu')]
    raise ValueError(f"device must be 'cuda' or 'cpu', got {kind!r}")


def _as_device(d) -> torch.device:
    """One entry of an explicit device list as a torch device; a CUDA index
    past the attached cards raises rather than failing at the first copy."""
    try:
        dev = torch.device(d)
    except (RuntimeError, TypeError):
        raise ValueError(f'not a device: {d!r}') from None
    if dev.type == 'cuda' and dev.index is not None \
            and dev.index >= torch.cuda.device_count():
        raise ValueError(f'{dev} but only {torch.cuda.device_count()} CUDA '
                         f'device(s) are attached')
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f"devices must be CUDA devices or 'cpu', got {dev}")
    return dev


def _indexed(dev: torch.device) -> torch.device:
    """A CUDA device with its index (``'cuda'`` is the current card), so
    that two names of one card compare equal; CUDA without a card raises."""
    if dev.type != 'cuda':
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f'a mesh on {dev} but torch finds no CUDA device; '
                           f"pass device='cpu' and a mesh of 'cpu'")
    return torch.device('cuda', torch.cuda.current_device()
                        if dev.index is None else dev.index)


class Mesh:
    """A grid of torch devices with named axes: ``devices`` is an ndarray of
    ``torch.device`` whose dimensions ``axis_names`` name, as in
    ``jax.sharding.Mesh``. Every device is of one type; one device may
    appear more than once."""

    def __init__(self, devices, axis_names):
        src = np.asarray(devices, dtype=object)
        grid = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = _indexed(_as_device(src[idx]))
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names) or grid.size == 0:
            raise ValueError(f'a mesh of shape {grid.shape} needs one name '
                             f'per dimension, got {axis_names}')
        kinds = {d.type for d in grid.flat}
        if len(kinds) != 1:
            raise ValueError(f'a mesh holds devices of one type, got '
                             f'{sorted(kinds)}')
        self.devices = grid
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    def axis_size(self, axis: str) -> int:
        """The number of devices along ``axis``; an axis the mesh lacks
        raises ValueError naming it."""
        return self.devices.shape[self._axis(axis)]

    def first(self) -> torch.device:
        """The device that holds what the mesh does not split: the wire,
        the frontend, the gathered rows, the master parameters."""
        return self.devices.flat[0]

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis``, every other axis at index 0."""
        index = [0] * self.devices.ndim
        index[self._axis(axis)] = slice(None)
        return list(self.devices[tuple(index)])

    def take(self, axis: str, i: int) -> 'Mesh':
        """The mesh of the other axes at index ``i`` of ``axis``."""
        k = self._axis(axis)
        return Mesh(np.take(self.devices, i, axis=k),
                    self.axis_names[:k] + self.axis_names[k + 1:])

    def _axis(self, axis):
        if axis not in self.axis_names:
            raise ValueError(f'the mesh has no {axis!r} axis (axes '
                             f'{self.axis_names}); build one with '
                             f'make_mesh(shape=..., axes=(..., {axis!r}))')
        return self.axis_names.index(axis)

    def __repr__(self):
        return (f'Mesh({self.shape}, '
                f'{[str(d) for d in self.devices.flat]})')


class Sharding(NamedTuple):
    """A tensor layout over a mesh: ``spec`` names, per dimension, the mesh
    axis it is split over, or None (``jax.sharding.NamedSharding``'s
    ``(mesh, PartitionSpec)``)."""
    mesh: Mesh
    spec: tuple


def make_mesh(n_devices: int = None, axis: str = 'data', devices=None,
              shape=None, axes=None, device='cuda') -> Mesh:
    """A device mesh over the attached (or given) devices.

    Default: 1-D data-parallel over ``axis``. For the trainer's DPxTP
    sharding pass a 2-D layout, e.g.
    ``make_mesh(shape=(4, 2), axes=('data', 'model'))``.

    ``devices`` None takes the attached devices of ``device``'s type (the
    CUDA cards, or the one CPU), the first ``n_devices`` of them or the
    first ``prod(shape)``; asking for more than are attached raises (JAX
    quietly builds a smaller mesh). An explicit list of ``'cuda:i'``,
    ``'cpu'`` or ``torch.device`` may repeat a device, e.g.
    ``['cuda:0'] * 4`` on one card or ``['cpu'] * 8`` on the CPU; it must
    hold at least ``prod(shape)`` devices. CUDA without a card raises.
    """
    want = int(np.prod(shape)) if shape is not None else n_devices
    if devices is None:
        devices = _local_devices(torch.device(device).type)
        if want is not None and want > len(devices):
            raise ValueError(
                f'a mesh of {want} devices but only {len(devices)} local '
                f'{device} device(s) are attached; pass devices= to repeat '
                f'one')
        if not devices:
            raise RuntimeError(f'no {device} device is attached')
    devices = [_as_device(d) for d in devices]
    if shape is not None:
        if axes is None or len(axes) != len(shape):
            raise ValueError('axes must name every dim of shape')
        if want > len(devices):
            raise ValueError(f'shape {tuple(shape)} needs {want} devices, '
                             f'got {len(devices)}')
        grid = np.empty(len(devices), dtype=object)
        grid[:] = devices
        return Mesh(grid[:want].reshape(shape), tuple(axes))
    if n_devices is not None:
        devices = devices[:n_devices]
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid, (axis,))


def mesh_device(mesh: Mesh, device) -> torch.device:
    """The mesh's first device, where the caller's ``device`` argument is
    of the same type; a mesh on one device type and a ``device=`` on
    another raise."""
    if torch.device(device).type != mesh.device_type:
        raise ValueError(f'device={str(device)!r} but the mesh holds '
                         f'{mesh.device_type} devices; pass '
                         f'device={mesh.device_type!r}')
    return mesh.first()


def data_sharding(mesh: Mesh, ndim: int = 1, axis: str = 'data',
                  sharded_dim: int = 0) -> Sharding:
    """Shard dimension ``sharded_dim`` of an ndim-array over the data axis."""
    spec = [None] * ndim
    spec[sharded_dim] = axis
    return Sharding(mesh, tuple(spec))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def split(x: torch.Tensor, mesh: Mesh, axis: str = 'data', dim: int = 0):
    """``x`` cut along ``dim`` into one contiguous slice per device along
    ``axis`` (every other axis at index 0), each copied to its device: the
    first ``ceil(n / size)`` rows to the first device and so on, as GSPMD
    pads a ragged axis, so the last slices may be short or empty. Returns
    the list of slices in axis order.

    A copy between two cards is ordered by torch on the current streams of
    both (the destination's stream waits for the copy, which waits for the
    source's stream), so work queued later on the destination's current
    stream reads the finished slice. A slice on its source's device is a
    view, not a copy. Autograd carries gradients back through the copies."""
    devs = mesh.axis_devices(axis)
    n = x.shape[dim]
    step = -(-n // len(devs))
    return [x.narrow(dim, min(i * step, n),
                     max(0, min(step, n - i * step))).to(d)
            for i, d in enumerate(devs)]


def gather(parts, dim: int, device) -> torch.Tensor:
    """The slices ``parts`` copied to ``device`` and joined along ``dim`` in
    order (``split``'s inverse); the copies are ordered as ``split``'s."""
    return torch.cat([p.to(device) for p in parts], dim)


def resolve_replica_devices(devices, device='cuda'):
    """Normalize ``analyze(devices=...)`` to a list of torch devices.

    Replica data parallelism (the reference's "multiple GPU analyzers"):
    each listed device gets its OWN classifier replica and dispatch thread,
    fed independent chunks, with no collective.

    Accepts an int N (the first N devices of ``device``'s type), ``'all'``
    (every such device) or an explicit list of ``'cuda:i'``, ``'cpu'`` or
    ``torch.device``, which may repeat a device (two replicas on one card).
    Returns a list, always; raises on requests the hardware can't honor
    rather than silently shrinking the fleet.
    """
    local = _local_devices(torch.device(device).type)
    if devices == 'all':
        if not local:
            raise ValueError(f"devices='all' but no {device} device is "
                             f"attached")
        devices = len(local)
    if isinstance(devices, bool) or devices is None or \
            isinstance(devices, str):
        # a stray string like '4' must not fall through to list('4')
        raise ValueError("devices must be an int >= 1, 'all', or a device list")
    if isinstance(devices, int):
        if devices < 1:
            raise ValueError(f'devices must be >= 1, got {devices}')
        if devices > len(local):
            raise ValueError(
                f'devices={devices} but only {len(local)} local {device} '
                f'device(s) are attached')
        return list(local[:devices])
    devices = [_as_device(d) for d in devices]
    if not devices:
        raise ValueError('devices list is empty')
    return devices


def shard_files(paths, host_id: int = None, n_hosts: int = None,
                root: str = None):
    """Deterministically assign files to this host (multi-host DP).

    Stable across runs and independent of listing order, so interrupted
    multi-host jobs resume with the same assignment. Hosts need no
    communication: completion state lives in the shared output directory.

    Pass ``root`` (the audio directory) so the hash covers the path
    RELATIVE to it: hosts that mount or spell the corpus directory
    differently (/data/audio vs /mnt/shared/audio) then still agree on
    every file's owner. Hashing absolute paths would silently assign some
    files to no host at all when spellings differ.
    """
    if host_id is None or n_hosts is None:
        rank, world = process_rank()
        host_id = rank if host_id is None else host_id
        n_hosts = world if n_hosts is None else n_hosts
    if n_hosts <= 1:
        return list(paths)
    mine = []
    for p in paths:
        key = os.path.relpath(str(p), root) if root else str(p)
        digest = hashlib.sha1(key.encode()).digest()
        if int.from_bytes(digest[:4], 'big') % n_hosts == host_id:
            mine.append(p)
    return mine
