"""Trainer registry entries (counterpart of
``terrain_diffusion_tpu/training/trainers/__init__.py``): the diffusion,
consistency, autoencoder, GAN and perceptron trainers."""
from terrain_diffusion_tpu_torch.training.registry import trainer_registry
from terrain_diffusion_tpu_torch.training.trainers.autoencoder import AutoencoderTrainer
from terrain_diffusion_tpu_torch.training.trainers.base import TrainerBase  # noqa: F401
from terrain_diffusion_tpu_torch.training.trainers.consistency import ConsistencyTrainer
from terrain_diffusion_tpu_torch.training.trainers.diffusion import DiffusionTrainer


@trainer_registry.register("diffusion")
def _diffusion():
    return DiffusionTrainer


@trainer_registry.register("consistency")
def _consistency():
    return ConsistencyTrainer


@trainer_registry.register("autoencoder")
def _autoencoder():
    return AutoencoderTrainer


@trainer_registry.register("gan")
def _gan():
    from terrain_diffusion_tpu_torch.training.trainers.gan import GANTrainer
    return GANTrainer


@trainer_registry.register("perceptron")
def _perceptron():
    from terrain_diffusion_tpu_torch.training.trainers.perceptron import PerceptronTrainer
    return PerceptronTrainer
