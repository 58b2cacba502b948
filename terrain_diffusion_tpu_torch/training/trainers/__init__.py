"""Trainer registry entries (counterpart of
``terrain_diffusion_tpu/training/trainers/__init__.py``): the diffusion and
consistency trainers; the autoencoder, GAN and perceptron trainers raise
NotImplementedError."""
from terrain_diffusion_tpu_torch.training.registry import trainer_registry
from terrain_diffusion_tpu_torch.training.trainers.base import TrainerBase  # noqa: F401
from terrain_diffusion_tpu_torch.training.trainers.consistency import ConsistencyTrainer
from terrain_diffusion_tpu_torch.training.trainers.diffusion import DiffusionTrainer


@trainer_registry.register("diffusion")
def _diffusion():
    return DiffusionTrainer


@trainer_registry.register("consistency")
def _consistency():
    return ConsistencyTrainer


def _not_ported(name):
    def factory():
        raise NotImplementedError(f"the {name} trainer is not ported yet (ROADMAP.md section 1)")
    return factory


for _name in ("autoencoder", "gan", "perceptron"):
    trainer_registry.register(_name)(_not_ported(_name))
