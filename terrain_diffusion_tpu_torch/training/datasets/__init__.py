"""Dataset registry entries (counterpart of
``terrain_diffusion_tpu/training/datasets/__init__.py``): ``h5_latents`` and
``h5_decoder_terrain``; the other datasets raise NotImplementedError."""
from terrain_diffusion_tpu_torch.training.datasets.h5_datasets import (  # noqa: F401
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


def _not_ported(name):
    def factory(**_kw):
        raise NotImplementedError(f"the {name} dataset is not ported yet (ROADMAP.md section 1)")
    return factory


for _name in ("h5_autoencoder", "h5_superres_terrain", "coarse", "biome", "file_gan"):
    dataset_registry.register(_name)(_not_ported(_name))
