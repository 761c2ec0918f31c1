from buzzdetect_torch.parallel.mesh import (  # noqa: F401
    Mesh, Sharding, data_sharding, gather, make_mesh, mesh_device,
    process_rank, replicated_sharding, resolve_replica_devices, shard_files,
    split)
