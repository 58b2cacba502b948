"""WorldPipeline: 3-stage lazy hierarchical terrain generation in PyTorch.

Counterpart of ``terrain_diffusion_tpu.pipeline.world`` (serving path):

- coarse stage: 64-px tiles / stride 48, 20-step DPM-Solver++ over the
  coarse U-Net, conditioned on the synthetic map mixed with deterministic
  noise via TrigFlow cos/sin at per-channel SNR;
- latent stage: 64-px latent tiles / stride 32, TrigFlow consistency steps
  (init + one intermediate step; T=2 blends the init across tiles before
  the step, T=1 chains both inside one window function; onestep_latent
  drops the step), each tile conditioned on a 58-dim vector built from its
  4x4 coarse context window.  ``latent_sampler="dpm"`` serves the
  undistilled base instead: one stage tensor whose window runs
  ``latent_steps`` DPM-Solver++ steps (the coarse stage's schedule) from
  ``sigma_max`` times the noise at offset 5819, each step's denoiser the
  AutoGuidance combination ``g + guidance_scale * (m - g)`` of the base
  model ``m`` and the guide model ``g`` (``set_models(..., guide=)``) on
  the same input; at ``guidance_scale`` 1, which alone needs no guide, one
  forward a step.  All steps run inside the window, and the windows are
  blended once, as the coarse stage does;
- decoder stage: 512-px tiles / stride 384, one consistency step on the
  x8-nearest-upsampled latents; its residual blocks and in/out convs run
  through the hand-written CUDA kernels on the card;
- output composition: Laplacian denoise + decode + signed square for
  elevation; windowed temperature regression + bilinear grid-sample for
  climate.

``dtype="bf16"`` (or ``"fp16"``) runs the three stage models in bfloat16
(float16), as the JAX package's ``dtype`` does: each stage casts its model
input, noise labels and conditioning to that type, the U-Nets cast their
float32 parameters per forward and run the kernels' 16-bit forms on the
card, and each model output goes back to float32 before the scheduler
arithmetic.  Sampling, composition, noise and wire packing stay float32.

Every stage evaluates a whole padded tile batch as one tensor with a real
batch dimension.  Stochastic inputs come from a tiled noise field keyed on
(seed + stage offset, tile): the threefry field (the default), generated on
the pipeline's device one batch per call, or the portable PCG64 host field.
Either way any tile is identical regardless of batch composition or
evaluation order.

``block_impl="pallas"`` (the default, as in JAX) lets the stage models'
blocks and in / out 3x3 convs take the hand-written kernels where they are
eligible; ``"xla"`` sends them to the plain path (``with_block_impl``; the
world's models are then copies that share the given models' weights).
Attention follows each model's ``attention_impl`` either way.

``mesh=`` (a one-process ``parallel.Mesh``) serves tile-parallel: every
stage's batch buckets become multiples of the slot count
(``_mesh_buckets``), and each model forward splits its batch over the
slots, runs each chunk on its slot's replica of the model and gathers the
results on the world's device in order.  Noise, conditioning, blending and
composition stay on the world's device, keyed by tile position, so no tile
changes; there is no collective, as in JAX.

``caching_strategy="indirect"`` keeps the stage windows in an HDF5 world
file (``bind(hdf5_file)``; ``"TEMP"`` makes a temporary one that ``close``
removes) in the JAX package's layout, so a world written by either package
opens in the other.  It needs ``h5py``.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import tempfile
import time

import numpy as np
import torch

from terrain_diffusion_tpu_torch import use_full_f32
from terrain_diffusion_tpu_torch.common.spans import StageClock, span
from terrain_diffusion_tpu_torch.evaluation.samplers import _with_guidance
from terrain_diffusion_tpu_torch.nn import torch_compat
from terrain_diffusion_tpu_torch.nn.layers import BLOCK_IMPLS, with_block_impl
from terrain_diffusion_tpu_torch.ops import mp
from terrain_diffusion_tpu_torch.ops.image import (avg_pool, grid_sample_bilinear,
                                                   max_pool, min_pool, signed_square,
                                                   upsample_nearest)
from terrain_diffusion_tpu_torch.ops.laplacian import laplacian_decode, laplacian_denoise
from terrain_diffusion_tpu_torch.ops.noise_field import (gaussian_noise_patch,
                                                        threefry_noise_batch)
from terrain_diffusion_tpu_torch.ops.rng_portable import next_seed
from terrain_diffusion_tpu_torch.ops.windows import linear_weight_window
from terrain_diffusion_tpu_torch.parallel.mesh import Mesh, replicate, shard_batch
from terrain_diffusion_tpu_torch.pipeline.postprocessing import local_baseline_temperature
from terrain_diffusion_tpu_torch.pipeline.synthetic_map import make_synthetic_map_factory
from terrain_diffusion_tpu_torch.runtime.cuda_graphs import ForwardGraphs
from terrain_diffusion_tpu_torch.runtime.infinite_tensor import (InfiniteTensor,
                                                                 _traced_geometry,
                                                                 assemble_from_atlas,
                                                                 ensure_regions_multi,
                                                                 new_counts)
from terrain_diffusion_tpu_torch.runtime.tile_store import HDF5TileStore, MemoryTileStore
from terrain_diffusion_tpu_torch.runtime.window import TensorWindow
from terrain_diffusion_tpu_torch.scheduler.dpmsolver import (EDMSchedulerConfig,
                                                             compute_sigmas, sample_dpm,
                                                             trigflow_precondition_noise)

# Channel statistics the reference bakes into the pipeline.
DEFAULT_COARSE_MEANS = [-37.67916460232751, 2.22578822145657, 18.030293275011356,
                        333.8442390481231, 1350.1259248456176, 52.444339366764396]
DEFAULT_COARSE_STDS = [39.68515115440358, 3.0981253981231522, 8.940333096712806,
                       322.25238547630295, 856.3430083394657, 30.982620765341043]
COND_INPUT_MEAN = np.array([14.99, 11.65, 15.87, 619.26, 833.12, 69.40, 0.66], np.float32)
COND_INPUT_STD = np.array([21.72, 21.78, 10.40, 452.29, 738.09, 34.59, 0.47], np.float32)
LOWFREQ_MEAN = -31.4
LOWFREQ_STD = 38.6
SCHED = EDMSchedulerConfig(sigma_min=0.002, sigma_max=80, sigma_data=0.5)
SD = SCHED.sigma_data
# dtype= values the port serves -> the stage models' compute type
COMPUTE_DTYPES = {None: torch.float32, "fp32": torch.float32, "bf16": torch.bfloat16,
                  "fp16": torch.float16}
LATENT_SAMPLERS = ("consistency", "dpm")


_TEMP_FILES = set()


def resolve_hdf5_path(hdf5_file: str) -> str:
    """The world file's path; ``"TEMP"`` makes a new temporary file."""
    if hdf5_file.upper() == "TEMP":
        f = tempfile.NamedTemporaryFile(delete=False, suffix=".h5", prefix="terrain_")
        f.close()
        _TEMP_FILES.add(f.name)
        return f.name
    return hdf5_file


def _ceil_div(a, b):
    return -((-a) // b)


def _write_rows(out_atlas: torch.Tensor, out_slots, out: torch.Tensor):
    """A fused stage's write: output rows ``out[:len(out_slots)]`` into
    ``out_atlas[out_slots]``, in place (bucket padding rows are dropped)."""
    out_atlas.index_copy_(0, torch.as_tensor(np.asarray(out_slots, np.int64),
                                             device=out_atlas.device),
                          out[:len(out_slots)].float())


def _pack_elev_i16(elev: torch.Tensor) -> torch.Tensor:
    """The wire's elevation: floor, then clip to int16."""
    return torch.clamp(torch.floor(elev), -32768, 32767).to(torch.int16)


def _host_copy(t: torch.Tensor | None):
    """(host tensor, event): a card tensor's copy into pinned host memory,
    started without waiting (ready once the event has completed); a CPU
    tensor as it is."""
    if t is None or t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    return host, event


class WorldPipeline:
    """Multi-scale terrain generation pipeline (PyTorch)."""

    COARSE_MODEL_FOLDER = "coarse_model"
    BASE_MODEL_FOLDER = "base_model"
    DECODER_MODEL_FOLDER = "decoder_model"
    GUIDE_MODEL_FOLDER = "guide_model"
    CONFIG_NAME = "config.json"

    def __init__(self, seed: int | None = None,
                 latents_batch_size=(1, 2, 4, 8, 16, 32, 64),
                 native_resolution: float = 90.0, *, T: int = 2,
                 log_mode: str = "info", dtype: str | None = None,
                 latent_compression: int = 8, frequency_mult=None,
                 drop_water_pct: float = 0.5, cond_snr=None, coarse_pooling: int = 1,
                 elev_coarse_pool_mode: str = "avg", p5_coarse_pool_mode: str = "avg",
                 residual_mean: float = 0.0, residual_std: float = 1.1678,
                 coarse_means=None, coarse_stds=None,
                 caching_strategy: str = "direct",
                 cache_limit: int | None = 100 * 1024 * 1024,
                 onestep_latent: bool = False, decoder_tile_size: int = 512,
                 decoder_tile_stride: int = 384, noise_mode: str = "threefry",
                 block_impl: str = "pallas", mesh: Mesh | None = None,
                 latent_sampler: str = "consistency", latent_steps: int = 15,
                 guidance_scale: float = 1.5, device="cuda", **deprecated_kwargs):
        if T not in (1, 2):
            raise ValueError(f"T must be 1 or 2, got {T}")
        if latent_sampler not in LATENT_SAMPLERS:
            raise ValueError(f"latent_sampler must be one of {LATENT_SAMPLERS}, "
                             f"got {latent_sampler!r}")
        if latent_sampler == "dpm" and (T != 2 or onestep_latent):
            raise ValueError("latent_sampler='dpm' runs its steps inside one window: it takes "
                             "neither T=1 nor onestep_latent")
        if int(latent_steps) < 1:
            raise ValueError(f"latent_steps must be at least 1, got {latent_steps}")
        if block_impl not in BLOCK_IMPLS:
            raise ValueError(f"block_impl must be one of {BLOCK_IMPLS}, got {block_impl!r}")
        if mesh is not None and (not isinstance(mesh, Mesh) or mesh.group):
            raise TypeError("mesh must be a one-process parallel.Mesh (Mesh.from_devices or "
                            f"make_mesh outside a process group), got {mesh!r}")
        if noise_mode not in ("threefry", "portable"):
            raise ValueError(f"unknown noise mode {noise_mode!r}")
        if dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown dtype {dtype!r}: 'fp32', 'bf16' or 'fp16'")
        use_full_f32()
        self.T = T
        self.seed = (int(seed) & 0xFFFFFFFFFFFFFFFF) if seed is not None else next_seed(None)
        self._batch_sizes = ([latents_batch_size] if isinstance(latents_batch_size, int)
                             else sorted(latents_batch_size))
        self.native_resolution = native_resolution
        self.latent_compression = latent_compression
        self.log_mode = log_mode
        self.caching_strategy = caching_strategy
        self.cache_limit = cache_limit
        self.onestep_latent = onestep_latent
        self.decoder_tile_size = decoder_tile_size
        self.decoder_tile_stride = decoder_tile_stride
        self.noise_mode = noise_mode
        self.block_impl = block_impl
        self.latent_sampler = latent_sampler
        self.latent_steps = int(latent_steps)
        self.guidance_scale = float(guidance_scale)
        self.mesh = mesh
        self._replicas = {}  # id(model) -> the model's replica on each mesh slot
        self._graphs = ForwardGraphs()  # the stage forwards' CUDA graphs (_forward)
        self.compute_dtype = COMPUTE_DTYPES[dtype]
        self.device = torch.device(device)
        self.kwargs = {
            "latent_compression": latent_compression,
            "frequency_mult": list(frequency_mult) if frequency_mult is not None else [1.5, 3, 3, 3, 3],
            "drop_water_pct": drop_water_pct,
            "cond_snr": list(cond_snr) if cond_snr is not None else [0.3, 0.1, 1.0, 0.1, 1.0],
            "coarse_pooling": coarse_pooling,
            "elev_coarse_pool_mode": elev_coarse_pool_mode,
            "p5_coarse_pool_mode": p5_coarse_pool_mode,
            "histogram_raw": deprecated_kwargs.get("histogram_raw") or [0.0] * 5,
            "residual_mean": residual_mean,
            "residual_std": residual_std,
            "coarse_means": list(coarse_means) if coarse_means is not None else list(DEFAULT_COARSE_MEANS),
            "coarse_stds": list(coarse_stds) if coarse_stds is not None else list(DEFAULT_COARSE_STDS),
        }
        self.coarse_model = self.base_model = self.decoder_model = self.guide_model = None
        self.tile_store = None
        self._hdf5_file_path = None
        self._is_temp_file = False
        self.synthetic_map_factory = None
        self.coarse = self.latents = self.residual = None
        self.custom_conditioning_imports = {}
        self.custom_conditioning_import_origins = {}
        self.custom_conditioning_default_values = {}
        self.stage_timings = {}
        self._clock = StageClock(self.stage_timings, self.device)
        self._counts = {}    # stage -> its stage tensor's counters (runtime/infinite_tensor.py)
        self._stage_of = {}  # id(model) -> the stage model's name in forward ranges

    # ==================================================================
    # Model IO
    # ==================================================================
    @classmethod
    def from_pretrained(cls, path: str, **kwargs) -> "WorldPipeline":
        with open(os.path.join(path, cls.CONFIG_NAME)) as f:
            config = json.load(f)
        config.pop("_class_name", None)
        config.update(kwargs)
        guide = os.path.join(path, cls.GUIDE_MODEL_FOLDER)
        return cls.from_local_models(
            *(os.path.join(path, folder) for folder in (cls.COARSE_MODEL_FOLDER,
                                                        cls.BASE_MODEL_FOLDER,
                                                        cls.DECODER_MODEL_FOLDER)),
            guide_model_path=guide if os.path.isdir(guide) else None, **config)

    @classmethod
    def from_local_models(cls, coarse_model_path=None, base_model_path=None,
                          decoder_model_path=None, guide_model_path=None,
                          **kwargs) -> "WorldPipeline":
        """A pipeline over the model directories given one by one (the guide
        model's only for a guided ``latent_sampler="dpm"`` world)."""
        pipe = cls(**kwargs)
        load = functools.partial(torch_compat.load_model, device=pipe.device)
        return pipe.set_models(load(coarse_model_path), load(base_model_path),
                               load(decoder_model_path),
                               guide=load(guide_model_path) if guide_model_path else None)

    def get_config(self) -> dict:
        """The world's config.json (the JAX package's keys; a ``"dpm"``
        world adds its sampler's three, which the JAX package does not
        serve)."""
        config = {"_class_name": "WorldPipeline", "native_resolution": self.native_resolution,
                  "T": self.T, **self.kwargs, "onestep_latent": self.onestep_latent,
                  "decoder_tile_size": self.decoder_tile_size,
                  "decoder_tile_stride": self.decoder_tile_stride}
        if self.latent_sampler == "dpm":
            config.update(latent_sampler=self.latent_sampler, latent_steps=self.latent_steps,
                          guidance_scale=self.guidance_scale)
        return config

    def save_pretrained(self, save_directory: str):
        """Write the world directory ``from_pretrained`` reads."""
        os.makedirs(save_directory, exist_ok=True)
        with open(os.path.join(save_directory, self.CONFIG_NAME), "w") as f:
            json.dump(self.get_config(), f, indent=2)
        for folder, model in ((self.COARSE_MODEL_FOLDER, self.coarse_model),
                              (self.BASE_MODEL_FOLDER, self.base_model),
                              (self.DECODER_MODEL_FOLDER, self.decoder_model),
                              (self.GUIDE_MODEL_FOLDER, self.guide_model)):
            if model is not None:
                torch_compat.save_model(model, os.path.join(save_directory, folder))

    def set_models(self, coarse, base, decoder, guide=None):
        """Attach the stage models (``EDMUnet2D`` modules), with the world's
        ``block_impl``: the three stages' and, for ``latent_sampler="dpm"``,
        the base model's AutoGuidance guide, which such a world needs unless
        its ``guidance_scale`` is 1."""
        if guide is None and self.latent_sampler == "dpm" and self.guidance_scale != 1.0:
            raise ValueError(f"a latent_sampler='dpm' world at guidance_scale "
                             f"{self.guidance_scale} needs its guide model: "
                             f"set_models(..., guide=), or a guide_model/ folder")
        self.coarse_model, self.base_model, self.decoder_model = (
            with_block_impl(m.to(self.device).eval(), self.block_impl)
            for m in (coarse, base, decoder))
        self.guide_model = (with_block_impl(guide.to(self.device).eval(), self.block_impl)
                            if guide is not None else None)
        self._stage_of = {id(self.coarse_model): "coarse", id(self.base_model): "base",
                          id(self.decoder_model): "decoder"}
        if self.guide_model is not None:
            self._stage_of[id(self.guide_model)] = "guide"
        self._replicas = {}
        self._graphs.clear()  # graphs and replicas hold the old weights
        if self.tile_store is not None:
            self._build_hierarchy()  # window fns must see the new models
        return self

    # ==================================================================
    # Bind / lifecycle
    # ==================================================================
    def bind(self, hdf5_file=None, mode="a", compression="gzip", compression_opts=4):
        """Create the tile store and the stage tensors.  In indirect mode the
        windows go to `hdf5_file` ("TEMP" for a temporary file), whose stored
        world parameters win over this pipeline's."""
        self._compression = compression
        self._compression_opts = compression_opts
        if self.caching_strategy == "direct":
            self.tile_store = MemoryTileStore(cache_size_bytes=self.cache_limit)
        else:
            if hdf5_file is None:
                raise ValueError("hdf5_file is required when caching_strategy='indirect'")
            original = hdf5_file
            hdf5_file = resolve_hdf5_path(hdf5_file)
            self._is_temp_file = original.upper() == "TEMP"
            self._hdf5_file_path = hdf5_file
            store = HDF5TileStore(hdf5_file, mode=mode, compression=compression,
                                  compression_opts=compression_opts)
            self._reconcile_params(store)
            self.tile_store = store
        self._init_conditioning()
        self._build_hierarchy()
        return self

    def _reconcile_params(self, store: HDF5TileStore):
        """Stored world parameters win on a mismatch; ``log_mode`` is a
        runtime knob and is neither compared nor adopted."""

        def persisted(kw):
            return {k: v for k, v in kw.items() if k != "log_mode"}

        current = {"seed": self.seed, "kwargs": persisted(self.kwargs)}
        stored = store.get_params()
        if stored is None:
            store.set_params(current)
            return
        stored_cmp = {"seed": stored["seed"], "kwargs": persisted(stored["kwargs"])}
        if stored_cmp != current:
            print("[WorldPipeline] stored world params differ; using stored "
                  "(pass a fresh file or call rebuild() to regenerate)")
            self.seed = stored["seed"]
            self.kwargs = persisted(stored["kwargs"])
            # attributes read outside self.kwargs follow the adopted parameters
            self.latent_compression = self.kwargs.get("latent_compression",
                                                      self.latent_compression)

    def _init_conditioning(self):
        self.synthetic_map_factory = make_synthetic_map_factory(
            seed=self.seed, frequency_mult=self.kwargs["frequency_mult"],
            drop_water_pct=self.kwargs["drop_water_pct"])

    def _build_hierarchy(self):
        self.coarse = self._build_coarse_stage()
        self.latents = self._build_latent_stage()
        self.residual = self._build_decoder_stage()

    def rebuild(self):
        """Drop every cached window (in indirect mode, start the world file
        afresh) and build the stage tensors again."""
        if self.tile_store is None:
            return
        if self.caching_strategy == "direct":
            self.tile_store = MemoryTileStore(cache_size_bytes=self.cache_limit)
        else:
            self.tile_store.close()
            os.unlink(self._hdf5_file_path)
            store = HDF5TileStore(self._hdf5_file_path, mode="a",
                                  compression=self._compression,
                                  compression_opts=self._compression_opts)
            store.set_params({"seed": self.seed, "kwargs": self.kwargs})
            self.tile_store = store
        self._replicas = {}
        self._graphs.clear()
        self._init_conditioning()
        self._build_hierarchy()

    def change_seed(self, seed: int | None = None) -> bool:
        new_seed = (int(seed) & 0xFFFFFFFFFFFFFFFF) if seed is not None else next_seed(None)
        if new_seed == self.seed:
            return False
        self.seed = new_seed
        self.rebuild()
        return True

    def set_cond_snr(self, cond_snr) -> None:
        """Per-channel SNR of the coarse stage's conditioning; drops the
        cached windows."""
        if len(cond_snr) != 5:
            raise ValueError("cond_snr must contain exactly 5 values.")
        self.kwargs["cond_snr"] = [float(x) for x in cond_snr]
        self.rebuild()

    # ==================================================================
    # Custom conditioning imports (replace synthetic-map channels)
    # ==================================================================
    def set_custom_conditioning_import(self, channel: int, values: np.ndarray,
                                       origin_i: int, origin_j: int,
                                       default_value: float | None = None) -> None:
        """Replace raw synthetic-map channel `channel` by `values` (a 2-D
        array placed at world cell (origin_i, origin_j)) and, outside it, by
        `default_value` when one is given; drops the cached windows."""
        values = np.asarray(values, dtype=np.float32)
        if values.ndim != 2:
            raise ValueError("Custom conditioning import must be a 2-D array.")
        channel = int(channel)
        self.custom_conditioning_imports[channel] = values.copy()
        self.custom_conditioning_import_origins[channel] = (int(origin_i), int(origin_j))
        if default_value is None:
            self.custom_conditioning_default_values.pop(channel, None)
        else:
            self.custom_conditioning_default_values[channel] = float(default_value)
        self.rebuild()

    def _sample_custom_conditioning_channel(self, channel, ci0, ci1, cj0, cj1):
        """(values, mask) of the imports for `channel` over [ci0, ci1) x
        [cj0, cj1), or (None, None) where nothing is imported there."""
        import_values = self.custom_conditioning_imports.get(channel)
        default_value = self.custom_conditioning_default_values.get(channel)
        if import_values is None and default_value is None:
            return None, None
        h, w = ci1 - ci0, cj1 - cj0
        if default_value is None:
            values = np.zeros((h, w), dtype=np.float32)
            mask = np.zeros((h, w), dtype=bool)
        else:
            values = np.full((h, w), float(default_value), dtype=np.float32)
            mask = np.ones((h, w), dtype=bool)
        if import_values is not None:
            src_i0, src_j0 = self.custom_conditioning_import_origins[channel]
            src_i1 = src_i0 + import_values.shape[0]
            src_j1 = src_j0 + import_values.shape[1]
            oi0, oi1 = max(ci0, src_i0), min(ci1, src_i1)
            oj0, oj1 = max(cj0, src_j0), min(cj1, src_j1)
            if oi0 < oi1 and oj0 < oj1:
                values[oi0 - ci0:oi1 - ci0, oj0 - cj0:oj1 - cj0] = import_values[
                    oi0 - src_i0:oi1 - src_i0, oj0 - src_j0:oj1 - src_j0]
                mask[oi0 - ci0:oi1 - ci0, oj0 - cj0:oj1 - cj0] = True
        if not mask.any():
            return None, None
        return values, mask

    def _conditioning_model_input(self, ci0, ci1, cj0, cj1) -> np.ndarray:
        """(5, H, W) float32 conditioning for the coarse U-Net: the synthetic
        map, with any imported channels written over its raw values."""
        if not self.custom_conditioning_imports:
            return self.synthetic_map_factory(ci0, cj0, ci1, cj1)
        raw = np.asarray(self.synthetic_map_factory.sample_raw(ci0, cj0, ci1, cj1),
                         dtype=np.float32)
        for channel in range(raw.shape[0]):
            values, mask = self._sample_custom_conditioning_channel(
                channel, ci0, ci1, cj0, cj1)
            if values is not None:
                raw[channel][mask] = values[mask]
        raw[0] = np.sign(raw[0]) * np.sqrt(np.abs(raw[0]))
        return raw

    # ==================================================================
    # Observability
    # ==================================================================
    def _timed(self, stage: str, fn):
        """Run fn as one call of `stage` in `stage_timings` ([calls,
        seconds]), under a ``td.<stage>`` profiler range.  The call counts at
        once.  On the CPU the seconds are its wall time; on a card they are
        the stage's span on the device, from its first queued work to its
        last (``common/spans.py::StageClock``), taken from CUDA events
        without waiting for the device, and added by the end of the
        ``get`` or ``get_many`` that ran the stage."""
        return self._clock.timed(stage, fn, self.log_mode == "verbose")

    def _settle_timings(self):
        self._clock.settle(self.log_mode == "verbose")

    def timing_summary(self) -> dict:
        self._settle_timings()
        return {k: {"calls": v[0], "total_s": v[1], "mean_ms": v[1] / max(v[0], 1) * 1000}
                for k, v in self.stage_timings.items()}

    def counters(self) -> dict:
        """{stage: {windows, padded, lookups, hits, forwards, captures,
        replays}} since the world was made (a rebuild keeps them): per stage
        tensor (``coarse``, ``latent_init``, ``latent_step``, or
        ``latent_t1`` at T=1, or ``latent_dpm`` with ``latent_sampler="dpm"``,
        whose forwards are the base model's and the guide's, ``decoder``),
        the windows its stage computed, the rows that bucket padding added
        to them, the windows that planning looked up and found resident, its
        model forwards, and the CUDA graphs of them captured and replayed
        (``_forward``)."""
        return {k: dict(v) for k, v in self._counts.items()}

    def _stage_counts(self, stage: str) -> dict:
        return self._counts.setdefault(stage, new_counts())

    @contextlib.contextmanager
    def profile(self, log_dir: str):
        """``torch.profiler`` trace of everything inside the block, the card's
        kernels included, written to ``log_dir/trace.json`` (Chrome trace)."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        with torch.profiler.profile(activities=activities) as prof:
            yield self
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

    # ==================================================================
    # Mesh (tile-parallel serving)
    # ==================================================================
    def _mesh_buckets(self, buckets) -> tuple:
        """Batch buckets scaled to multiples of the mesh's slot count."""
        n = self.mesh.size if self.mesh is not None else 1
        if n == 1:
            return tuple(buckets)
        return tuple(sorted({max(b, 1) * n for b in buckets}))

    def _forward(self, model, x, noise_labels, cond, counts: dict):
        """``model(x, noise_labels, cond)`` on the world's device, counted in
        the stage's ``counts``.  On a card, without autograd, it runs
        through the world's CUDA graphs (``runtime/cuda_graphs.py``): the
        first forward of a model and input signature eagerly, every later
        one as a replay of its graph.  With a mesh, each slot's replica
        takes its chunk of the batch (a padded bucket, a multiple of the
        slots; all chunks are launched before any is gathered), eagerly,
        and the outputs are joined in order.  Runs under a
        ``td.fwd.<model>.<batch>.<h>.<w>`` profiler range."""
        counts["forwards"] += 1
        with span("fwd", self._stage_of.get(id(model), "model"), *x.shape[:3]):
            if self.mesh is None:
                if x.is_cuda and not torch.is_grad_enabled():
                    return model(x, noise_labels, cond, graphs=functools.partial(
                        self._graphs, counts=counts))
                return model(x, noise_labels, cond)
            if id(model) not in self._replicas:  # set_models and rebuild drop them
                self._replicas[id(model)] = replicate(self.mesh, model)
            outs = [rep(*shard) for rep, shard in zip(
                self._replicas[id(model)], shard_batch(self.mesh, (x, noise_labels, cond)))]
            return torch.cat([o.to(self.device) for o in outs])

    # ==================================================================
    # Helpers
    # ==================================================================
    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _noise(self, seed, y0s, x0s, h, w, channels, tile) -> torch.Tensor:
        """(B, C, h, w) noise crops at corners (y0s[b], x0s[b]) on the
        pipeline's device: threefry generates the whole batch there in one
        call; the portable field is drawn on the host and uploaded."""
        if self.noise_mode == "threefry":
            return threefry_noise_batch(seed, y0s, x0s, h, w, channels, tile, tile,
                                        self.device)
        return self._tensor(np.stack([
            gaussian_noise_patch(seed, int(y0), int(x0), h, w, channels, tile, tile)
            for y0, x0 in zip(y0s, x0s)]))

    # ==================================================================
    # Coarse stage
    # ==================================================================
    @property
    def _defer_host(self) -> bool:
        """Stage windows stay in the device caches until a host-side read
        needs them, in direct mode only: the HDF5 store must see every
        window to keep it."""
        return self.caching_strategy == "direct"

    def _build_coarse_stage(self):
        TILE, STRIDE = 64, 48
        pool = self.kwargs["coarse_pooling"]
        if TILE % pool or STRIDE % pool:
            raise ValueError(f"coarse_pooling {pool} must divide {TILE} and {STRIDE}")
        sigmas0 = float(compute_sigmas(SCHED, 20)[0])
        means = np.asarray(self.kwargs["coarse_means"], np.float32)
        stds = np.asarray(self.kwargs["coarse_stds"], np.float32)
        cond_means = means[[0, 2, 3, 4, 5]]
        cond_stds = stds[[0, 2, 3, 4, 5]]
        t_cond = np.arctan(np.asarray(self.kwargs["cond_snr"], np.float32))
        cond_scalar_vals = np.log(np.tan(t_cond) / 8.0)
        wwin = self._tensor(linear_weight_window(TILE // pool))
        tc = self._tensor(t_cond).reshape(1, -1, 1, 1)
        means_t = self._tensor(means).reshape(1, -1, 1, 1)
        stds_t = self._tensor(stds).reshape(1, -1, 1, 1)
        pool_fns = [{"max": max_pool, "min": min_pool}.get(m, avg_pool)
                    for m in (self.kwargs["elev_coarse_pool_mode"],
                              self.kwargs["p5_coarse_pool_mode"])]
        model = self.coarse_model
        dt = self.compute_dtype
        counts = self._stage_counts("coarse")
        buckets = self._mesh_buckets((1, 2, 4, 8, 16, 32))
        self._graphs.reserve(model, buckets[-1])

        def core(ctxs):
            seed = self.seed
            i1s = [(int(i) * (STRIDE // pool)) * pool for i in ctxs[:, 1]]
            j1s = [(int(j) * (STRIDE // pool)) * pool for j in ctxs[:, 2]]
            conds = [(self._conditioning_model_input(i1, i1 + TILE, j1, j1 + TILE)
                      - cond_means[:, None, None]) / cond_stds[:, None, None]
                     for i1, j1 in zip(i1s, j1s)]
            B = len(ctxs)
            cond = self._tensor(np.stack(conds))
            cond_noise = self._noise(seed, i1s, j1s, TILE, TILE, 5, TILE)
            cond_img = torch.cos(tc) * cond + torch.sin(tc) * cond_noise
            x = self._noise(seed + 1, i1s, j1s, TILE, TILE, 6, TILE) * sigmas0
            cond_scalars = [torch.full((B,), float(v), device=self.device, dtype=dt)
                            for v in cond_scalar_vals]

            def model_fn(scaled, sigma):
                label = float(trigflow_precondition_noise(sigma, SD))
                x_in = torch.cat([scaled, cond_img], dim=1).permute(0, 2, 3, 1).to(dt)
                out = self._forward(model, x_in,
                                    torch.full((B,), label, device=self.device, dtype=dt),
                                    cond_scalars, counts)
                return out.permute(0, 3, 1, 2).float()

            sample = sample_dpm(model_fn, x, SCHED, 20) / SD
            sample = sample * stds_t + means_t
            sample = torch.cat([sample[:, :1], sample[:, :1] - sample[:, 1:2],
                                sample[:, 2:]], dim=1)
            if pool > 1:
                sample = torch.cat([pool_fns[0](sample[:, 0:1], pool),
                                    pool_fns[1](sample[:, 1:2], pool),
                                    avg_pool(sample[:, 2:], pool)], dim=1)
            return torch.cat([sample * wwin, wwin.expand(B, 1, *wwin.shape)], dim=1)

        def f_fused(ctxs, out_atlas, out_slots, arg_views):
            self._timed("coarse", lambda: _write_rows(out_atlas, out_slots, core(ctxs)))

        return InfiniteTensor(
            lambda ctxs: self._timed("coarse", lambda: core(ctxs)),
            TensorWindow((7, TILE // pool, TILE // pool), (7, STRIDE // pool, STRIDE // pool)),
            batch_buckets=buckets, tile_store=self.tile_store,
            tensor_id="base_coarse_map", device=self.device, shape=(7, None, None),
            device_cache_tiles=256, defer_host=self._defer_host,
            f_fused=f_fused if self.mesh is None else None,
            counts=counts)

    # ==================================================================
    # Latent stage
    # ==================================================================
    def _build_cond(self, coarse_regions):
        """(B, 58) conditioning vectors from (B, 7, 4, 4) coarse windows.

        Every NaN (in every channel) is filled with COND_INPUT_MEAN[0] in
        normalized space - the reference's production behaviour."""
        B = coarse_regions.shape[0]
        vals = coarse_regions[:, :-1] / coarse_regions[:, -1:]
        cond = torch.cat([vals, torch.ones((B, 1, 4, 4), device=self.device)], dim=1)
        cond = ((cond - self._tensor(COND_INPUT_MEAN).reshape(1, 7, 1, 1))
                / self._tensor(COND_INPUT_STD).reshape(1, 7, 1, 1))
        cond = torch.nan_to_num(cond, nan=float(COND_INPUT_MEAN[0]))
        hist = self._tensor(self.kwargs["histogram_raw"]).expand(B, -1)
        noise_level = torch.full((B, 1), (0.0 - 0.5) * np.sqrt(12), device=self.device)
        return mp.mp_concat(
            [cond[:, 0].reshape(B, -1), cond[:, 1].reshape(B, -1),
             cond[:, 2:6, 1:3, 1:3].mean(dim=(2, 3)), cond[:, 6].reshape(B, -1),
             hist, noise_level], dim=1)

    def _latent_core(self, t_value: float, seed_offset: int, with_prev: bool, counts: dict):
        """One TrigFlow consistency step on a batch of latent tiles:
        ``core(ctxs, coarses, prevs)`` with the (B, 7, 4, 4) coarse windows
        and, with ``with_prev``, the (B, 6, 64, 64) previous phase's regions;
        shared by the staged and the fused calls and the T=1 chain.  Its
        forwards count in ``counts``, its stage tensor's."""
        TILE, STRIDE = 64, 32
        model = self.base_model
        dt = self.compute_dtype
        wwin = self._tensor(linear_weight_window(TILE))
        t = torch.tensor(t_value, dtype=torch.float32, device=self.device)

        def core(ctxs, coarses, prevs=None):
            B = len(ctxs)
            z = self._noise(self.seed + seed_offset, ctxs[:, 1] * STRIDE,
                            ctxs[:, 2] * STRIDE, TILE, TILE, 5, TILE)
            prev = (prevs[:, :-1] / prevs[:, -1:] * SD if with_prev
                    else torch.zeros((B, 5, TILE, TILE), device=self.device))
            x_t = torch.cos(t) * prev + torch.sin(t) * (z * SD)
            x_in = (x_t / SD).permute(0, 2, 3, 1).to(dt)
            pred = -self._forward(model, x_in, t.expand(B).to(dt),
                                  [self._build_cond(coarses).to(dt)], counts)
            pred = pred.permute(0, 3, 1, 2).float()
            sample = (torch.cos(t) * x_t - torch.sin(t) * SD * pred) / SD
            return torch.cat([sample * wwin, wwin.expand(B, 1, TILE, TILE)], dim=1)

        return core

    def _latent_program(self, t_value: float, seed_offset: int, with_prev: bool,
                        counts: dict | None = None):
        """(f, f_fused) of one latent phase tensor; its parents are the
        previous phase (with ``with_prev``) and the coarse map.  Its
        forwards count in ``counts``, by default its own stage's."""
        TILE = 64
        stage = "latent_step" if with_prev else "latent_init"
        core = self._latent_core(t_value, seed_offset, with_prev,
                                 counts if counts is not None else self._stage_counts(stage))

        def f(ctxs, *regions):
            prevs, coarses = regions if with_prev else (None, regions[0])
            return self._timed(stage, lambda: core(ctxs, coarses, prevs))

        def fused(ctxs, out_atlas, out_slots, arg_views):
            prevs = (assemble_from_atlas(*arg_views[0], (6, TILE, TILE)) if with_prev
                     else None)
            coarses = assemble_from_atlas(*arg_views[-1], (7, 4, 4))
            _write_rows(out_atlas, out_slots, core(ctxs, coarses, prevs))

        def f_fused(ctxs, out_atlas, out_slots, arg_views):
            self._timed(stage, lambda: fused(ctxs, out_atlas, out_slots, arg_views))

        return f, (f_fused if self.mesh is None else None)

    def _latent_t1_fused(self, t_init: float, steps):
        """The T=1 chain's fused call: the coarse windows assembled from
        their pool, init and every intermediate step (their latents are not
        blended across tiles, as in the staged chain) and the write, timed
        as one ``latent_t1`` call."""
        if self.mesh is not None:
            return None
        counts = self._stage_counts("latent_t1")
        cores = [self._latent_core(t_init, 5819, False, counts)] + [
            self._latent_core(t, 5820 + i, True, counts) for i, t in enumerate(steps)]

        def fused(ctxs, out_atlas, out_slots, arg_views):
            coarses = assemble_from_atlas(*arg_views[0], (7, 4, 4))
            out = cores[0](ctxs, coarses)
            for core in cores[1:]:
                out = core(ctxs, coarses, out)
            _write_rows(out_atlas, out_slots, out)

        def f_fused(ctxs, out_atlas, out_slots, arg_views):
            self._timed("latent_t1", lambda: fused(ctxs, out_atlas, out_slots, arg_views))

        return f_fused

    def _dpm_latent_core(self, counts: dict):
        """The guided DPM-Solver++ window of ``latent_sampler="dpm"``:
        ``core(ctxs, coarses)`` with the (B, 7, 4, 4) coarse windows, shared
        by the staged and the fused calls.  ``latent_steps`` steps of the
        coarse stage's schedule from ``sigma_max`` times the noise at offset
        5819; each step's denoiser is ``g + guidance_scale * (m - g)`` of the
        base model ``m`` and the guide ``g`` on the same input
        (``evaluation/samplers.py::_with_guidance``; the base alone at scale
        1), in float32 once out of the models.  Its forwards count in ``counts``."""
        TILE, STRIDE = 64, 32
        steps = self.latent_steps
        sigma0 = float(compute_sigmas(SCHED, steps)[0])
        dt = self.compute_dtype
        wwin = self._tensor(linear_weight_window(TILE))

        def stage_model(model):
            return (None if model is None else
                    lambda x, label, cond: self._forward(model, x, label, cond, counts).float())

        denoiser = _with_guidance(stage_model(self.base_model), stage_model(self.guide_model),
                                  self.guidance_scale)

        def core(ctxs, coarses):
            B = len(ctxs)
            x = self._noise(self.seed + 5819, ctxs[:, 1] * STRIDE, ctxs[:, 2] * STRIDE,
                            TILE, TILE, 5, TILE) * sigma0
            cond = [self._build_cond(coarses).to(dt)]

            def model_fn(scaled, sigma):
                label = torch.full((B,), float(trigflow_precondition_noise(sigma, SD)),
                                   device=self.device, dtype=dt)
                return denoiser(scaled.permute(0, 2, 3, 1).to(dt), label, cond).permute(0, 3, 1, 2)

            sample = sample_dpm(model_fn, x, SCHED, steps) / SD
            return torch.cat([sample * wwin, wwin.expand(B, 1, TILE, TILE)], dim=1)

        return core

    def _build_dpm_latent_stage(self, out_win, coarse_win, kw):
        """The one latent stage tensor of ``latent_sampler="dpm"``, on the
        coarse map alone, timed and counted as ``latent_dpm``."""
        counts = self._stage_counts("latent_dpm")
        core = self._dpm_latent_core(counts)
        if self.guide_model is not None:
            self._graphs.reserve(self.guide_model, kw["batch_buckets"][-1])

        def fused(ctxs, out_atlas, out_slots, arg_views):
            coarses = assemble_from_atlas(*arg_views[0], (7, 4, 4))
            _write_rows(out_atlas, out_slots, core(ctxs, coarses))

        def f_fused(ctxs, out_atlas, out_slots, arg_views):
            self._timed("latent_dpm", lambda: fused(ctxs, out_atlas, out_slots, arg_views))

        return InfiniteTensor(
            lambda ctxs, coarses: self._timed("latent_dpm", lambda: core(ctxs, coarses)),
            out_win, args=(self.coarse,), args_windows=(coarse_win,),
            tensor_id="dpm_latent_map", f_fused=f_fused if self.mesh is None else None,
            counts=counts, **kw)

    def _build_latent_stage(self):
        TILE, STRIDE = 64, 32
        sigmas0 = float(compute_sigmas(SCHED, 20)[0])
        t_init = float(np.arctan(sigmas0 / SD))
        t_inter = [] if self.onestep_latent else [float(np.arctan(0.35 / 0.5))]
        out_win = TensorWindow((6, TILE, TILE), (6, STRIDE, STRIDE))
        coarse_win = TensorWindow((7, 4, 4), (7, 1, 1), offset=(0, -1, -1))
        buckets = self._mesh_buckets(self._batch_sizes)
        self._graphs.reserve(self.base_model, buckets[-1])
        kw = dict(batch_buckets=buckets, tile_store=self.tile_store, device=self.device,
                  shape=(6, None, None), device_cache_tiles=256, defer_host=self._defer_host)
        if self.latent_sampler == "dpm":
            return self._build_dpm_latent_stage(out_win, coarse_win, kw)
        if self.T == 1:
            t1_counts = self._stage_counts("latent_t1")
            init_f = self._latent_program(t_init, 5819, False, t1_counts)[0]
            step_fs = [self._latent_program(t, 5820 + i, True, t1_counts)[0]
                       for i, t in enumerate(t_inter)]

            # init and steps chained inside one window fn: the intermediate
            # latents of a tile are never blended with its neighbours'
            def f_t1(ctxs, coarses):
                out = init_f(ctxs, coarses)
                for step_f in step_fs:
                    out = step_f(ctxs, out, coarses)
                return out

            return InfiniteTensor(f_t1, out_win, args=(self.coarse,),
                                  args_windows=(coarse_win,), tensor_id="latent_map_T1",
                                  f_fused=self._latent_t1_fused(t_init, t_inter),
                                  counts=t1_counts, **kw)
        init_f, init_fused = self._latent_program(t_init, 5819, with_prev=False)
        tensor = InfiniteTensor(init_f, out_win, args=(self.coarse,),
                                args_windows=(coarse_win,), tensor_id="init_latent_map",
                                f_fused=init_fused, counts=self._stage_counts("latent_init"),
                                **kw)
        for i, t in enumerate(t_inter):
            step_f, step_fused = self._latent_program(t, 5820 + i, with_prev=True)
            tensor = InfiniteTensor(
                step_f, out_win, args=(tensor, self.coarse),
                args_windows=(out_win, coarse_win),
                tensor_id=f"step_latent_map_{i}", f_fused=step_fused,
                counts=self._stage_counts("latent_step"), **kw)
        return tensor

    # ==================================================================
    # Decoder stage
    # ==================================================================
    def _build_decoder_stage(self):
        TILE = self.decoder_tile_size
        STRIDE = self.decoder_tile_stride
        lc = self.latent_compression
        sigmas0 = float(compute_sigmas(SCHED, 20)[0])
        t_list = [float(np.arctan(sigmas0 / SD))]
        wwin = self._tensor(linear_weight_window(TILE))
        model = self.decoder_model
        dt = self.compute_dtype
        counts = self._stage_counts("decoder")
        buckets = self._mesh_buckets((1, 2, 4, 8, 16))
        self._graphs.reserve(model, buckets[-1])

        # The portable field reuses the latent stage's offsets 5819 + step, as
        # the reference does: the decoder tile index hr // 512 equals the
        # latent tile index lat // 64, so the two streams collide.  Threefry
        # draws from a separate offset family, as the JAX package does.
        dec_off = 15819 if self.noise_mode == "threefry" else 5819

        def core(ctxs, latents_regions):
            B = len(ctxs)
            lat = (latents_regions[:, :-1] / latents_regions[:, -1:])[:, :4]
            up = upsample_nearest(lat, lc)  # (B, 4, TILE, TILE)
            sample = torch.zeros((B, 1, TILE, TILE), device=self.device)
            for step, t_val in enumerate(t_list):
                z = self._noise(self.seed + dec_off + step, ctxs[:, 1] * STRIDE,
                                ctxs[:, 2] * STRIDE, TILE, TILE, 1, TILE)
                t = torch.tensor(t_val, dtype=torch.float32, device=self.device)
                x_t = torch.cos(t) * sample + torch.sin(t) * (z * SD)
                x_in = torch.cat([x_t / SD, up], dim=1).permute(0, 2, 3, 1).to(dt).contiguous()
                pred = -self._forward(model, x_in, t.expand(B).to(dt), [], counts)
                pred = pred.permute(0, 3, 1, 2).float()
                sample = torch.cos(t) * x_t - torch.sin(t) * SD * pred
            sample = sample / SD
            return torch.cat([sample * wwin, wwin.expand(B, 1, TILE, TILE)], dim=1)

        def fused(ctxs, out_atlas, out_slots, arg_views):
            regions = assemble_from_atlas(*arg_views[0], (6, TILE // lc, TILE // lc))
            _write_rows(out_atlas, out_slots, core(ctxs, regions))

        def f_fused(ctxs, out_atlas, out_slots, arg_views):
            self._timed("decoder", lambda: fused(ctxs, out_atlas, out_slots, arg_views))

        return InfiniteTensor(
            lambda ctxs, regions: self._timed("decoder", lambda: core(ctxs, regions)),
            TensorWindow((2, TILE, TILE), (2, STRIDE, STRIDE)),
            args=(self.latents,),
            args_windows=(TensorWindow((6, TILE // lc, TILE // lc),
                                       (6, STRIDE // lc, STRIDE // lc)),),
            batch_buckets=buckets, tile_store=self.tile_store,
            tensor_id="init_residual_map", device=self.device, shape=(2, None, None),
            device_cache_tiles=96, defer_host=self._defer_host,
            f_fused=f_fused if self.mesh is None else None,
            counts=counts)

    # ==================================================================
    # Output composition
    # ==================================================================
    @staticmethod
    def _elev_ranges(i1, j1, i2, j2, scale: int):
        """(residual_ranges, latents_ranges, pi1, pj1) read regions for an
        elevation query; the region size depends only on the query size."""
        sigma = 5
        kernel_size = (int(sigma * 2) // 2) * 2 + 1
        pad_hr = (kernel_size // 2 + 1) * scale
        pi1 = ((i1 - pad_hr) // scale) * scale
        pj1 = ((j1 - pad_hr) // scale) * scale
        pi2 = pi1 + _ceil_div(i2 - i1 + 2 * pad_hr + scale - 1, scale) * scale
        pj2 = pj1 + _ceil_div(j2 - j1 + 2 * pad_hr + scale - 1, scale) * scale
        return ([(0, 2), (pi1, pi2), (pj1, pj2)],
                [(0, 6), (pi1 // scale, pi2 // scale), (pj1 // scale, pj2 // scale)],
                pi1, pj1)

    @staticmethod
    def _climate_ranges(i1, j1, i2, j2, scale: int):
        """Coarse read region for a climate query; its size depends only on
        the query size."""
        S = 32 * scale
        ci1, cj1 = i1 // S, j1 // S
        ci2 = ci1 + _ceil_div(i2 - i1 + S - 1, S)
        cj2 = cj1 + _ceil_div(j2 - j1 + S - 1, S)
        pad = (15 - 1) // 2 + 1
        return [(0, 7), (ci1 - pad, ci2 + pad), (cj1 - pad, cj2 + pad)]

    def _elev_core(self, residual, latents, oi, oj, h: int, w: int) -> torch.Tensor:
        """(B, h, w) elevation in meters from (B, 2, ...) residual and
        (B, 6, ...) latent regions, each cropped at its (oi[b], oj[b]).

        The Laplacian denoise and decode run one query at a time: their
        convs and matmuls pick their kernels by batch size (on the card and
        in oneDNN alike), so a batched call could round a query otherwise
        than its one-query call does.  Everything else runs on the batch."""
        residual_p = ((residual[:, 0] / residual[:, 1]) * self.kwargs["residual_std"]
                      + self.kwargs["residual_mean"])
        lowfreq_p = (latents[:, :-1] / latents[:, -1:])[:, 4] * LOWFREQ_STD + LOWFREQ_MEAN
        elev_p = torch.cat([
            laplacian_decode(*laplacian_denoise(residual_p[b:b + 1], lowfreq_p[b:b + 1],
                                                sigma=5))
            for b in range(residual_p.shape[0])])
        rows = torch.as_tensor(oi, device=self.device)[:, None] + torch.arange(h, device=self.device)
        cols = torch.as_tensor(oj, device=self.device)[:, None] + torch.arange(w, device=self.device)
        b = torch.arange(len(rows), device=self.device)[:, None, None]
        return signed_square(elev_p[b, rows[:, :, None], cols[:, None, :]])

    def _climate_core(self, coarse, elev, di, dj, S: int) -> torch.Tensor:
        """(B, 5, h, w) climate [temp, t_season, precip, p_cv, beta] from
        (B, 7, ...) coarse regions and (B, h, w) elevation.  The sampling
        grid is built on the device from di = i1 - ci1 * S and dj (small
        integers, so float32 holds them exactly at any world coordinate)."""
        win = 15
        B, h, w = elev.shape
        coarse_map = coarse[:, :-1] / coarse[:, -1:]
        coarse_elev = (torch.sign(coarse_map[:, 0])
                       * torch.square(torch.clamp(coarse_map[:, 0], min=0.0)))
        temp_baseline, beta = local_baseline_temperature(
            coarse_map[:, 2], coarse_elev, win=win, fallback_threshold=0.02)
        central = coarse_map[:, :, win // 2:-(win // 2), win // 2:-(win // 2)]
        H_src, W_src = temp_baseline.shape[-2:]
        f32 = dict(device=self.device, dtype=torch.float32)
        ii = (torch.as_tensor(di, **f32)[:, None] + torch.arange(h, **f32))[:, :, None]
        jj = (torch.as_tensor(dj, **f32)[:, None] + torch.arange(w, **f32))[:, None, :]
        u = ((ii + 0.5) / S + 0.5).expand(B, h, w)
        v = ((jj + 0.5) / S + 0.5).expand(B, h, w)
        grid = torch.stack([(v + 0.5) * 2 / W_src - 1, (u + 0.5) * 2 / H_src - 1], dim=-1)
        features = torch.cat([temp_baseline[:, None], beta[:, None], central], dim=1)
        feats_up = grid_sample_bilinear(features, grid)
        temp_realistic = feats_up[:, 0] + feats_up[:, 1] * torch.clamp(elev, min=0.0)
        return torch.stack([temp_realistic, feats_up[:, 5], feats_up[:, 6], feats_up[:, 7],
                            feats_up[:, 1]], dim=1)

    def _compute_elev(self, i1, j1, i2, j2, scale: int) -> torch.Tensor:
        """Elevation in meters for [i1:i2) x [j1:j2), the regions read
        through ``read_device``."""
        res_ranges, lat_ranges, pi1, pj1 = self._elev_ranges(i1, j1, i2, j2, scale)
        residual = self.residual.read_device(res_ranges)
        latents = self.latents.read_device(lat_ranges)
        return self._elev_core(residual[None], latents[None], [i1 - pi1], [j1 - pj1],
                               i2 - i1, j2 - j1)[0]

    def _compute_climate(self, i1, j1, i2, j2, elev: torch.Tensor, scale: int) -> torch.Tensor:
        """(5, H, W) climate [temp, t_season, precip, p_cv, beta]."""
        S = 32 * scale
        coarse = self.coarse.read_device(self._climate_ranges(i1, j1, i2, j2, scale))
        return self._climate_core(coarse[None], elev[None], [i1 - (i1 // S) * S],
                                  [j1 - (j1 // S) * S], S)[0]

    def _compose_query_plan(self, i1, j1, i2, j2, with_climate: bool):
        """(tensors with their read ranges, (oi, oj, di, dj), region shapes,
        S) of one query's fused compose."""
        scale = self.latent_compression
        res_ranges, lat_ranges, pi1, pj1 = self._elev_ranges(i1, j1, i2, j2, scale)
        S = 32 * scale
        needed = [(self.residual, res_ranges), (self.latents, lat_ranges)]
        if with_climate:
            needed.append((self.coarse, self._climate_ranges(i1, j1, i2, j2, scale)))
        shapes = tuple(tuple(b - a for a, b in r) for _, r in needed)
        scalars = (i1 - pi1, j1 - pj1, i1 - (i1 // S) * S, j1 - (j1 // S) * S)
        return needed, scalars, shapes, S

    def _compose_fused_core(self, views, scalars: np.ndarray, shapes, h: int, w: int, S: int,
                            with_climate: bool, pack_wire: bool = False):
        """The whole output composition of B queries in one call: the
        residual, latent [and coarse] regions assembled from the stage
        caches (``views``: (atlas, slots, offs, valid) per tensor), the
        Laplacian denoise and decode with the signed square, the windowed
        temperature regression and the grid-sample, and with ``pack_wire``
        the wire types.  Returns (elev (B, h, w), climate (B, 5, h, w) or
        None) on the device."""
        oi, oj, di, dj = (scalars[:, k] for k in range(4))
        residual = assemble_from_atlas(*views[0], shapes[0])
        latents = assemble_from_atlas(*views[1], shapes[1])
        elev = self._elev_core(residual, latents, oi, oj, h, w)
        climate = None
        if with_climate:
            coarse = assemble_from_atlas(*views[2], shapes[2])
            climate = self._climate_core(coarse, elev, di, dj, S)
        if pack_wire:
            return _pack_elev_i16(elev), (climate.half() if climate is not None else None)
        return elev, climate

    def _compose_fused_batch(self, queries, with_climate: bool, pack_wire: bool = False,
                             plans=None):
        """Compose all `queries` (one output size and one region shape each)
        in one call; (elev (B, ...), climate (B, ...) or None) on the
        device, or None when their geometries differ or a window is not in
        its stage's device cache (the caller composes them staged).  JAX
        pads the batch to a power of two so that recurring rows hit a
        bounded set of compiled programs; eager PyTorch compiles none."""
        (i1, j1, i2, j2) = queries[0]
        h, w = i2 - i1, j2 - j1
        if any((b2 - b1, c2 - c1) != (h, w) for (b1, c1, b2, c2) in queries):
            return None
        if plans is None:
            plans = [self._compose_query_plan(*q, with_climate) for q in queries]
        needed0, _, shapes0, S = plans[0]
        if any(p[2] != shapes0 for p in plans):
            return None
        views = []
        for t_i, (tensor, _) in enumerate(needed0):
            if tensor.device_cache is None:
                return None
            boxes = [tuple(map(tuple, p[0][t_i][1])) for p in plans]
            geo = _traced_geometry(tensor.output_window, boxes, tensor.device_cache.slot)
            if geo is None:
                return None
            views.append((tensor.device_cache._atlas, *geo[:3]))
        scalars = np.asarray([p[1] for p in plans], np.int64)
        return self._compose_fused_core(views, scalars, shapes0, h, w, S, with_climate,
                                        pack_wire)

    def _compose_fused(self, i1, j1, i2, j2, with_climate: bool, pack_wire: bool = False):
        """(elev, climate or None) of one query in one call, or None when a
        window it reads is not in its stage's device cache."""
        out = self._compose_fused_batch([(i1, j1, i2, j2)], with_climate, pack_wire)
        if out is None:
            return None
        elev, climate = out
        return elev[0], (climate[0] if climate is not None else None)

    def prefetch(self, queries, with_climate: bool = True) -> None:
        """Plan and generate every stage window the `queries` ((i1, j1, i2,
        j2) boxes) need, in one pass over all three stage roots."""
        scale = self.latent_compression
        res_list, lat_list, coarse_list = [], [], []
        for (i1, j1, i2, j2) in queries:
            res_ranges, lat_ranges, _, _ = self._elev_ranges(i1, j1, i2, j2, scale)
            res_list.append(res_ranges)
            lat_list.append(lat_ranges)
            if with_climate:
                coarse_list.append(self._climate_ranges(i1, j1, i2, j2, scale))
        reqs = [(self.residual, res_list), (self.latents, lat_list)]
        if coarse_list:
            reqs.append((self.coarse, coarse_list))
        with torch.no_grad():  # inference: the stage forwards take the kernels
            ensure_regions_multi(reqs)

    def get(self, i1, j1, i2, j2, with_climate: bool = True,
            pack_wire: bool = False) -> dict:
        """Terrain for a bounding box: elev (H, W) meters [+ climate (5, H, W)].

        pack_wire=True packs the serving wire formats on the device before the
        fetch: elevation floor + clip to int16, climate to float16.  Every
        window is made resident, then composed in one call from the stage
        caches, or staged where a window is not in them."""
        with torch.no_grad(), span("get"):
            self._timed("prefetch", lambda: self.prefetch([(i1, j1, i2, j2)], with_climate))
            fused = self._timed("compose", lambda: self._compose_fused(
                i1, j1, i2, j2, with_climate, pack_wire))
            if fused is None:
                out = self._compose(i1, j1, i2, j2, with_climate, pack_wire)
            else:
                elev, climate = fused
                out = self._timed("fetch", lambda: {
                    "elev": elev.cpu().numpy(),
                    "climate": climate.cpu().numpy() if climate is not None else None})
            with span("timings"):
                self._settle_timings()
            return out

    def _compose_grouped(self, queries, with_climate: bool, pack_wire: bool = False):
        """Group `queries` by geometry (output size and region shapes) and
        compose each group in one call.  Returns (pending, fallback):
        pending [(query indices, (elev, climate or None))] still on the
        device, fallback the indices of queries whose windows are not all in
        the device caches (composed through get)."""
        groups: dict = {}
        plans = []
        with span("plan"):
            for qi, q in enumerate(queries):
                plan = self._compose_query_plan(*q, with_climate)
                plans.append(plan)
                (i1, j1, i2, j2) = q
                groups.setdefault((i2 - i1, j2 - j1, plan[2], plan[3]), []).append(qi)
        pending, fallback = [], []
        for idxs in groups.values():
            out = self._timed("compose", lambda idxs=idxs: self._compose_fused_batch(
                [queries[i] for i in idxs], with_climate, pack_wire,
                plans=[plans[i] for i in idxs]))
            if out is None:
                fallback.extend(idxs)
            else:
                pending.append((idxs, out))
        return pending, fallback

    def get_many(self, queries, with_climate: bool = True,
                 pack_wire: bool = False) -> list:
        """Batched get(): one generation pass over all `queries` ((i1, j1,
        i2, j2) boxes), so their missing windows share stage batches; then
        each geometry group composed in one call, every group's copy to the
        host started before the first is waited for.  Each result's bytes
        are those get() returns.

        Its host work runs in named profiler ranges under ``td.get_many``:
        ``prefetch`` (with ``plan`` and the stages), ``plan`` and
        ``compose`` of the groups, ``copy``, ``fallback``, ``fetch`` and
        ``timings``."""
        with torch.no_grad(), span("get_many"):
            self._timed("prefetch", lambda: self.prefetch(queries, with_climate))
            pending, fallback = self._compose_grouped(queries, with_climate, pack_wire)
            with span("copy"):
                copies = [(idxs, _host_copy(elev), _host_copy(climate))
                          for idxs, (elev, climate) in pending]
            results = [None] * len(queries)
            if fallback:
                with span("fallback"):
                    for qi in fallback:
                        results[qi] = self.get(*queries[qi], with_climate=with_climate,
                                               pack_wire=pack_wire)
            for idxs, (elev, e_ev), (climate, c_ev) in copies:
                def fetch():
                    for ev in (e_ev, c_ev):
                        if ev is not None:
                            ev.synchronize()
                    elev_b = elev.numpy()
                    climate_b = climate.numpy() if climate is not None else None
                    for b, qi in enumerate(idxs):
                        results[qi] = {"elev": elev_b[b],
                                       "climate": climate_b[b] if climate_b is not None else None}

                self._timed("fetch", fetch)
            with span("timings"):
                self._settle_timings()
            return results

    def _compose(self, i1, j1, i2, j2, with_climate: bool, pack_wire: bool) -> dict:
        """The staged compose: elevation, then climate, each its own call."""
        scale = self.latent_compression
        elev = self._timed("compose_elev", lambda: self._compute_elev(
            i1, j1, i2, j2, scale))
        climate = (self._timed("compose_climate", lambda: self._compute_climate(
            i1, j1, i2, j2, elev, scale)) if with_climate else None)
        if pack_wire:
            elev = _pack_elev_i16(elev)
            climate = climate.half() if climate is not None else None
        return self._timed("fetch", lambda: {
            "elev": elev.cpu().numpy(),
            "climate": climate.cpu().numpy() if climate is not None else None})

    def warmup(self, tile: int | None = None, with_climate: bool = True) -> dict:
        """Serve three `tile`-sized queries (a cold tile, its neighbour and
        an odd alignment) before the first client, so the first request does
        not pay the kernel build, CUDA context and allocator set-up.  The
        tiles are real world data and stay cached."""
        t = int(tile or self.decoder_tile_size)
        t0 = time.perf_counter()
        self.get(0, 0, t, t, with_climate=with_climate)
        self.get(0, t, t, 2 * t, with_climate=with_climate)
        off = t // 2 + 1
        self.get(off, 2 * t + off, off + t, 3 * t + off, with_climate=with_climate)
        return {"warmup_s": round(time.perf_counter() - t0, 2)}

    def empty_cache(self):
        """Drop every cached window output, in the store and the stage
        tensors' device caches; the next query recomputes."""
        if self.tile_store is None:
            return
        for t in (self.coarse, self.latents, self.residual):
            if t is not None:
                t.clear_cache()
        self.tile_store.clear()

    def close(self):
        """Close the tile store (a temporary world file is removed) and drop
        the stage tensors and the forwards' CUDA graphs."""
        if self.tile_store is not None:
            self.tile_store.close()
        if self._is_temp_file and self._hdf5_file_path in _TEMP_FILES:
            try:
                os.unlink(self._hdf5_file_path)
            except OSError:
                pass
            _TEMP_FILES.discard(self._hdf5_file_path)
        self.tile_store = None
        self.coarse = self.latents = self.residual = None
        self._graphs.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
