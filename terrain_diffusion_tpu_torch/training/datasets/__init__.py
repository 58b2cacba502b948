"""Dataset registry entries (counterpart of
``terrain_diffusion_tpu/training/datasets/__init__.py``): every dataset the
JAX package registers.  The HDF5 datasets import ``h5py`` only where they
open a file, and the others their modules only when they are built."""
from terrain_diffusion_tpu_torch.training.datasets.h5_datasets import (  # noqa: F401
    H5AutoencoderDataset,
    H5DecoderTerrainDataset,
    H5LatentsDataset,
    LongDataset,
    batch_iterator,
    collate,
)
from terrain_diffusion_tpu_torch.training.registry import dataset_registry


@dataset_registry.register("h5_latents")
def _make_latents(**kw):
    return H5LatentsDataset(**kw)


@dataset_registry.register("h5_decoder_terrain")
def _make_decoder(**kw):
    return H5DecoderTerrainDataset(**kw)


@dataset_registry.register("h5_autoencoder")
def _make_autoencoder(**kw):
    return H5AutoencoderDataset(**kw)


@dataset_registry.register("h5_superres_terrain")
def _make_superres(**kw):
    from terrain_diffusion_tpu_torch.training.datasets.superres_dataset import (
        H5SuperresTerrainDataset,
    )
    return H5SuperresTerrainDataset(**kw)


@dataset_registry.register("coarse")
def _make_coarse(**kw):
    from terrain_diffusion_tpu_torch.training.datasets.coarse_dataset import CoarseDataset
    return CoarseDataset(**kw)


@dataset_registry.register("biome")
def _make_biome(**kw):
    from terrain_diffusion_tpu_torch.training.datasets.biome_dataset import BiomeDataset
    return BiomeDataset(**kw)


@dataset_registry.register("file_gan")
def _make_file_gan(**kw):
    from terrain_diffusion_tpu_torch.training.datasets.file_gan_dataset import FileGANDataset
    return FileGANDataset(**kw)
