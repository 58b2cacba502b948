"""Device meshes, tile-parallel serving, data-parallel training and the
row-sharded forward (counterpart of ``terrain_diffusion_tpu.parallel``)."""
from terrain_diffusion_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    replicate,
    shard_batch,
)
from terrain_diffusion_tpu_torch.parallel.spatial import (  # noqa: F401
    shard_spatial,
    spatial_model,
)
