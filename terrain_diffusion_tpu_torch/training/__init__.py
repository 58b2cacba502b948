"""Training on one device (counterpart of ``terrain_diffusion_tpu/training/``):
EDM diffusion, sCM/TrigFlow consistency distillation, the VAE, the GAN and
the perceptron.

Entry point: ``python -m terrain_diffusion_tpu_torch.training.train --config
cfg.cfg [-o key.path=value ...] [--device cpu]`` (``train.run_training``).
Ported: ``lr_sched``, ``phema``, ``utils``, ``registry``, ``diffusion_core``,
every trainer and dataset of the JAX registry, ``save_model``, the
hyperparameter sweeps (``sweeps/sweep.py``) and the dev visualization
harness (``dev_utils/``, ``dev-viz`` in the command group).  Data
parallelism is not ported (ROADMAP.md section 1).
"""
