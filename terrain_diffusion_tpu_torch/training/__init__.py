"""Training: EDM diffusion and sCM/TrigFlow consistency distillation of
``EDMUnet2D`` on one device (counterpart of ``terrain_diffusion_tpu/training/``).

Entry point: ``python -m terrain_diffusion_tpu_torch.training.train --config
cfg.cfg [-o key.path=value ...] [--device cpu]`` (``train.run_training``).
Ported: ``lr_sched``, ``phema``, ``utils``, ``registry``, ``diffusion_core``,
the diffusion and consistency trainers, the HDF5 decoder and latents
datasets, ``save_model``.  The autoencoder, GAN and perceptron trainers,
KID evaluation, sweeps, dev_utils, the other datasets and data parallelism
are not ported (ROADMAP.md section 1).
"""
