"""Scale-out over ``torch.distributed``: meshes of ranks, sharded batches,
spatially sharded volumes, and the fused train steps on one GPU or
data-parallel over a mesh."""

from advchain_tpu_torch.parallel.mesh import (make_mesh, shard_batch,
                                              replicate_to_mesh,
                                              initialize_distributed,
                                              shard_process_local_batch)
from advchain_tpu_torch.parallel.spatial import (make_spatial_mesh,
                                                 volume_sharding,
                                                 grid_sharding, shard_volume,
                                                 shard_batch_spatial,
                                                 halo_exchange,
                                                 sharded_gaussian_smooth,
                                                 sharded_grid_sample,
                                                 chain_displacement_bound)
from advchain_tpu_torch.parallel.train import (TrainState,
                                               make_adversarial_train_step,
                                               make_supervised_train_step)

__all__ = [
    "make_mesh", "shard_batch", "replicate_to_mesh",
    "initialize_distributed", "shard_process_local_batch",
    "TrainState", "make_adversarial_train_step",
    "make_supervised_train_step",
    "make_spatial_mesh", "volume_sharding", "grid_sharding",
    "shard_volume", "shard_batch_spatial", "halo_exchange",
    "sharded_gaussian_smooth", "sharded_grid_sample",
    "chain_displacement_bound",
]
