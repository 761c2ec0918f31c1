from buzzdetect_torch.parallel.mesh import (  # noqa: F401
    process_rank, resolve_replica_devices, shard_files)
