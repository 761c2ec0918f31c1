"""Scale-out helpers that need no collective: per-device replicas and the
multi-host file shard.

Copy of the JAX-free parts of ``buzzdetect_tpu/parallel/mesh.py``. Edits:

* ``resolve_replica_devices`` resolves torch devices: an int or ``'all'``
  counts the devices of the caller's ``device`` type (the CUDA cards, or
  the one CPU), and an explicit list may name one device more than once;
* ``shard_files`` takes its default ``(host_id, n_hosts)`` from
  ``process_rank()``, the ``torch.distributed`` rank and world size where a
  process group is up, else ``(0, 1)``, as JAX answers in one process;
* no ``Mesh`` and no sharding: ``mesh=`` (one chunk split across devices)
  is not ported (ROADMAP, "Multi-GPU layouts, part 2").

Inference is pure data parallelism: within a host each replica takes whole
chunks, and across hosts *files* shard by a stable hash, so hosts share one
output folder and need no communication (completion state is the
filesystem).
"""

import hashlib
import os

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
