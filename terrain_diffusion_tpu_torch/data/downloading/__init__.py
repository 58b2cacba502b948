"""DEM acquisition: the Earth Engine downloader (``downloader``) and the
equal-area cell extractor (``extract``), counterparts of
``terrain_diffusion_tpu.data.downloading``.  Host tools: neither touches a
device, and the command group registers neither, as in JAX; each runs with
``python -m terrain_diffusion_tpu_torch.data.downloading.<module>``."""
