#!/usr/bin/env python3
"""Smoke test of the PyTorch port (terrain_diffusion_tpu_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
1. build the hand-written CUDA kernels from csrc/ (one nvcc per source, in
   parallel, sm_90a), with ptxas' register report for every conv, block and
   wgmma-core instantiation; it fails on a spill in any of them and on
   ptxas' warning that wgmma.mma_async instructions are serialized; then
   the native host library (``native.build``, g++), which must load, so
   that no phase takes the numpy Perlin and portable-noise paths;
2. kernel phase: each kernel against its plain PyTorch version on the same
   inputs, TF32 off on both sides, bar max|diff| / max|ref| < 1e-4 (float32,
   another summation order), with the eager times of the kernel, its plain
   version and the library yardstick (CUDA events around 5 calls, the
   wrappers' host work included, as the eager main path pays it) and,
   beside them, the kernel's device time (``device_ms``: 5 calls in a CUDA
   graph, replayed and timed with CUDA events, host work left out), the
   library yardstick's device time taken the same way
   (``library_device_ms``), and the wrapper's host work (``host``: the wall
   time of 5 calls that do not wait for the device; for a 16-bit conv or
   block, of it the per-call relayout of its weights, ``_k_major``): the fused block
   and the 3x3 conv at the decoder's shapes (batch 1, 2 and 16), the
   attention at the base model's midblock shape (batch 1, 16, 64), the JAX
   package's test shapes and the largest eligible map (HW = 2048).  Each
   row also gives the case's FLOPs and bytes, its bound (the larger of
   bytes / 3.35 TB/s and operations over the peak of the unit the kernel
   runs them on: 3 x FLOPs / 495 TFLOP/s for the 3xTF32 tensor-core
   kernels, FLOPs / 67 TFLOP/s for the 64 -> 1 head and the attention's
   CUDA-core path) with its share, the float32 CUDA-core figure FLOPs / 67
   TFLOP/s, the time of the library yardstick (``F.conv2d`` for the conv,
   the block's two ``F.conv2d`` 3x3 convs for the block,
   ``F.scaled_dot_product_attention`` on pre-normed (N, heads, HW, ch)
   tensors for the attention, which leaves out its pixel norm and layout
   change; TF32 off) and the launches per forward.  Each attention row
   names the kernel path its width takes, as the built library dispatches
   it (``library_attention_path``, checked equal to ``attention_path``);
   the rows of a head of 400 channels (float32, bf16, fp16) run the CUDA-core
   kernel.  Each 16-bit conv row names the core the chooser gives it
   (``[head]``, ``[in_conv]``).  Then the
   fused block, at production widths on small maps, and the attention at
   the midblock b64 and HW = 2048, against their plain versions run in
   float64 on the CPU, beside the float32 plain version's own error.  The
   16-bit conv chooser of the built library (``tdt_conv16_path``) must
   equal ``fused_block.conv16_path`` at every width; and for the bf16 block
   at enc 512x512 64->64 b2 and dec 512x512 proj 192->64 b2 one row per
   launch (prep, projection, conv0, conv1: ms, device ms, bytes, FLOPs,
   bound, and for a conv cuDNN's bf16 ``F.conv2d`` of its shape);
3. threefry phase: the card's threefry noise crop equals the CPU's bit for
   bit, on a crop with negative coordinates;
4. model phase: the production-width decoder U-Net (128x128 input) and base
   U-Net (attention_impl="pallas", 64x64 latents with a 58-dim conditioning
   vector) on the card (kernels) against the same modules on the CPU (plain
   versions); then one latent_init call at bucket 64 with the attention
   kernel and with the plain attention, timed in turns (kernel, plain,
   plain, kernel; the least time of each); then one production-width
   decoder forward at 512x512, batch 2 and 16, timed with CUDA events
   beside the summed bound of its 26 + 2 kernel launches;
5. api phase: the three production-width models (random weights from a
   seeded generator) behind the /terrain API with portable noise on a
   localhost port: /health and three 256x256 requests (a tile, the same tile
   again - byte-identical - and an overlapping crop);
6. Minecraft phase: the same models saved as a world directory (reference
   layout) and served by the Minecraft server's entry point,
   ``minecraft_api.main([world_dir, "--device", "cuda", "--threaded", ...])``,
   on a localhost port, WorldPipeline at its defaults (threefry noise, T=2):
   /health, a 256x256 tile at scale 1 and again (byte-identical), a tile at
   scale 4, the legacy /90 route, and four adjacent tiles requested at once
   from four threads; then, with the cache emptied, the same four one at a
   time, which must agree with the concurrent answers (elevation within
   1 m, biome ids equal on >= 99% of pixels).
7. bf16 (the ``--dtype bf16`` path, with the kernels' 16-bit forms): the
   kernel phase's bf16 rows (the 7 fused-block and 4 conv main-path cases,
   the midblock attention at b1 / b16 / b64 and the 400-channel head; and
   the fp16 rows: the block at b2, the in conv and the head at b2 / b16, the
   midblock b64 and the 400-channel head),
   each against its plain version on the same 16-bit inputs (bar 1e-2 in
   bf16, 2.5e-3 in fp16) and against the plain version in
   float64 on the card (no rounding: the kernel's error at most 1.25 x the
   float32 plain version's), with ms, device ms, plain, library (cuDNN's
   bf16 ``F.conv2d``, SDPA in bf16), FLOPs and bytes at the real element
   sizes, the bound on the unit the kernel runs (989 TFLOP/s for bf16
   ``mma``, 495 per TF32 pass) and its share; the decoder forward at 512x512
   b2 / b16 beside its summed bound; latent_init b64 with and without the
   attention kernel; the decoder and base U-Nets card vs CPU in bf16 (bar 2e-2
   relative RMSE) with their launches; and a bf16 Minecraft phase,
   ``minecraft_api.main([..., "--dtype", "bf16", "--threaded"])`` on the world
   of phase 6: a cold 256x256 tile, the same again (byte-identical), four
   adjacent cold tiles at once, with the cold tile's relative RMSE against
   phase 6's float32 tile.  Before it, the fp16 forms on the main path: one
   decoder forward at 512x512 b2 and one base forward (attention kernel) in
   fp16, which launch 26 blocks, 2 convs and 1 attention in fp16, and the
   fp16 decoder forward timed at b2 / b16.
8. training (``terrain_diffusion_tpu_torch.training``): ``run_training`` on
   the shipped configs, float32 with TF32 off, with in-memory datasets made
   from the seed in the item layout of the HDF5 datasets (no h5py on the
   card) and the unused val / sweep / results dataset sections dropped:
   ``diffusion_decoder_64-3.cfg`` at its batch 32, 128x128 crops, random
   init, 6 steps; ``consistency_decoder_64-3.cfg`` at its batch 16 with the
   diffusion run's saved model as teacher and a random ``decoder_32-3``
   guide, 4 steps; ``diffusion_192-3.cfg`` at its batch 48, 64x64 crops,
   dropout 0.1, 3 steps.  Each run prints ms per step (steps 3 on), images/s,
   peak GiB (the run's own, above what the earlier phases hold), loss and
   grad_norm (finite), FLOPs per step and the bound at 67
   TFLOP/s, and its kernel launches: the consistency run's equal its steps x
   (teacher + guide top-level blocks, in conv and head), the others launch
   none.  Then one diffusion and one consistency step at b2 on the card (the
   teacher and guide through the kernels) and on the CPU, same weights,
   batch and draws: loss, grad_norm, F_theta_grad and the updated weights
   within 1e-4 relative.  The kernel phase holds the training shapes too:
   the 64- and 32-channel top-level blocks and the in conv and head at
   128x128 b16.  Then the rest of the trainers: ``autoencoder_x8.cfg`` at
   its full width and crop 512, its batch the largest of 16 / 8 / 4 whose
   peak (at a one-step b2 probe's peak per image) stays under 70 GiB (its
   16 does not fit in float32), 5 steps, then ``evaluate`` on two 512x512 b2
   batches and ``save-model --sigma-rel 0.1`` through the command group
   with a round trip of the saved VAE, each launching the blocks and in
   conv ``vae_launches`` predicts, all in float32; its first step card vs
   CPU (b2 at 64x64, same init, batch and generator) within 1e-4;
   ``autoencoder_x8_squared.cfg`` at its batch 64, crop 128, 4 steps;
   ``diffusion_coarse.cfg`` at its batch 256, 16x16, 5 steps; the
   perceptron (4-32-32-4) on a separable climate set, 250 steps, held-out
   accuracy over 0.9; the GAN in inject mode with R1 every other step,
   64-channel U-Net generator and discriminator, b16 144x144 cropped to
   128x128, 5 steps (its discriminator phase's no_grad fakes launch the
   generator's top-level blocks, in conv and head each step), then FID with
   the EMA weights on two b16 batches (the same launches a batch).  These
   runs' FLOPs come from hooks on every MPConv of a plain forward.
9. evaluation (``terrain_diffusion_tpu_torch.evaluation``, the VAE): a VAE
   at ``autoencoder_x8.cfg``'s full width (seeded random weights) encodes
   and decodes 512x512 b2 in float32 on the card and on the CPU, bar 1e-4
   relative on the means, logvars and reconstruction, with the launches per
   encode (the 8 blocks of at least 128 x 128 pixels + the 2 -> 64 in conv)
   and decode (12 blocks) checked, and bf16's relative RMSE against float32
   reported; the samplers card vs CPU with one threefry key, bar 1e-4:
   ``sample_decoder_consistency_tiled`` on the 64-3 decoder over a 96x96
   latent canvas (4 tiles: 104 block + 8 conv launches),
   ``sample_base_consistency`` on the 192-3 base at b4 (2 attention
   launches), ``sample_autoencoder_tiled`` over 768x768 (4 tiles); FID / KID
   (terrain features) between two VAE draws, finite; the latency CLI
   (``evaluation.latency.main``, its default bf16, 3 runs) on phase 6's world
   directory and ``run_http_benchmark`` at 1 and 4 clients, 2 requests each
   (every p50 > 0, peak device bytes > 0, every answer of full size);
   ``DiffusionTrainer.evaluate_full`` on ``diffusion_192-3.cfg`` with KID (4
   images at b2, decoded by the world's decoder), finite.  The kernel phase
   holds the VAE's block shapes that no other row has and its 2 -> 64 in
   conv, in float32 and bf16 (``vae ...`` rows; the blocks take no
   embedding).
10. surface: the rest of the serving surface through the command group
   (``python -m terrain_diffusion_tpu_torch``'s ``cli``, in process) on phase
   6's world: ``generate --caching-strategy direct --coarse-window 4`` (one
   2048x2048 residual slice, float32); ``tiff-export`` of a 4x4-cell
   conditioning set (five GeoTIFFs written from the seed) to a 1024x1024
   int16 GeoTIFF in bf16, read back (shape, transform scaled by 256) and
   held within 1 m of a fresh ``world.get`` on the same pipeline bound
   again; ``explore --threaded`` on a localhost port (every route, statuses
   and mimetypes, detail_raw equal to ``world.get`` floored to int16, POST
   /api/seed last); ``random_sampler`` (2 tiles of 512 in bf16, finite, the
   centres at least the separation apart).  Each path's launches are held
   to its pipeline's model forwards, every one in the path's type; it
   prints ``{"surface": {...}}`` with seconds, launches and peak GiB per
   path.  Indirect caching needs h5py, which the card machine lacks: the
   phase runs direct caching.
11. data preparation (``terrain_diffusion_tpu_torch.data``) at the JAX
   builders' defaults on GeoTIFFs written from the seed (an ETOPO-like 10'
   global raster, one 4096x4096 DEM cell with a void, five 10' synthetic-map
   rasters): ``process_single_cell`` (4096 / 512, 4 chunks a side) on the
   card against the same call with ``device="cpu"`` (residual and lowfreq
   within 1e-5 relative, ids, ``lowres_exact`` and ``pct_land`` equal), with
   the Laplacian encode's device ms; ``encode_residual`` of the cell's
   landiest 1024x1024 subchunk (8 x 1024 x 1024 x 1 through D4) with
   ``autoencoder_x8.cfg`` at full width (seeded random weights saved and
   loaded through ``load_model``): its launches held to ``vae_launches`` at
   1024 (11 blocks + the in and out convs, float32), then against the plain
   path on the card within 1e-4 (kernel, plain, plain, kernel; peak GiB);
   ``calculate_beauty_score`` of the 16 subchunks, card against CPU within
   1e-5; ``build-synthetic-stats`` through the command group on the 10'
   rasters, then a WorldPipeline in that directory whose conditioning map
   equals the cache's and not the built-in tables', and one 256x256 get.
   It prints ``{"data_prep": {...}}``.  The HDF5 loops around these calls
   need h5py and run on the CPU only.  The kernel phase holds the encode's
   new shapes: the block at 1024x1024 64->64 b8 (2^31 bytes a tensor), the
   in conv 2->64 at 1024x1024 b8 and the out conv 256->8 at 128x128 b8.
12. export, through the command group on phase 6's world (full-width
   models, live gains): ``export --device cuda --no-verify`` writes the
   three U-Nets as torch.export programs (the decoder at 512x512 b1); then a
   fresh process that imports only torch and the port loads each program
   and runs it against the eager model on the
   same inputs: bit for bit, with the launches of each counted from zero
   (the decoder's 26 block and 2 conv launches, the base's 1 attention
   launch, equal to eager's) and the decoder's forward timed loaded and
   eager (CUDA events); ``onnx-export --device cuda`` writes the three ONNX
   files, each verified on the numpy runtime against the card forward
   (coarse and base at 64 px, the decoder through its 64-px export), and
   the decoder is exported again at 128x128, where its verifying forward
   launches the block and conv kernels.  It prints ``{"export": {...}}``
   (seconds, bytes, launches, each ONNX file's max|diff|, output std and
   numpy runtime seconds).
13. tools, on phase 6's world and the training phase's autoencoder_x8 run,
   datasets in memory (the card has no h5py): each ``dev-viz`` tool's page
   function (the card has no matplotlib; the command must then fail naming
   it, which is checked) at full width - ``pipeline-viz`` at 512x512 on a
   fresh world (all three kernels launched), ``consistency-decoder`` on the
   64-3 decoder at crop 512 (26 + 2 launches), ``autoencoder`` on the
   training run's saved EMA VAE at crop 512 (``vae_launches``),
   ``noise-loss-curve`` on the 64-3 decoder at 512 b2 over 5 sigmas (5 x
   (26 + 2)), ``base-diffusion`` (15 DPM steps of the 192-3 base, 15
   attention launches, and the decoder's 26 + 2), and the host tools
   (dataset, noise with the threefry field on the card, windows,
   signed-sqrt) - every panel finite; the consistency-decoder page at crop
   128 card vs CPU and ``sample_dpm`` with ``sde-dpmsolver++`` (order 2,
   midpoint, 20 steps) on the coarse model card vs CPU on the same noise,
   bar 1e-4; ``run_sweep`` over the autoencoder objective (3 trials, 2
   startup) on the run's PostHocEMA snapshots and 16 in-memory items, its
   values finite and its JSONL store resumed to a 4th trial; the native
   library loaded, its Perlin FBm (256x256) and portable normals (1M)
   equal to the numpy paths bit for bit, with both host times.  It prints
   ``{"tools": {...}}``.
14. parallel (``terrain_diffusion_tpu_torch.parallel``, the downloading
   tools): two cold 256x256 gets (the world's first, then a fresh region)
   of the production-width float32 world with the kernels, then with
   ``block_impl="xla"`` (no block or conv launch;
   within 1e-4 of the kernel world), then on a mesh of two slots on
   ``cuda:0`` (within rtol 1e-4, atol 1e-5 of the single world; launches
   = the world's forwards x 2), and over every card where there are two
   or more ("1 card: not run" otherwise); ``diffusion_decoder_64-3.cfg`` at
   batch 4 of 128x128, 2 steps, with no group and under NCCL at world
   size 1 (bit for bit; cuDNN deterministic in this sub-phase), then as
   two gloo ranks on ``cuda:0`` (``distributed.launch``) within 1e-5 of
   one process; the row-sharded forward of the 64-3 decoder at 512x512
   under NCCL at world size 1 against its plain forward (2e-5);
   ``extract_grid_data`` of a seeded 10' global GeoTIFF at JAX's cell size,
   each checked cell equal to the raster's window.  It prints
   ``{"parallel": {...}}``, each time beside the card's name and limit.
15. atlas (the device tile atlas and the fused stage and compose calls):
   a float32 and a bf16 world of the production-width models at the JAX
   defaults (threefry, T=2, decoder 512/384, the base model's attention
   on the kernel), each on the fused path and as a staged twin sharing its
   models (no fused stage call, no fused compose): a cold 256x256
   ``get(pack_wire=True)``, the same tile warm, and a ``get_many`` of four
   adjacent 256x256 tiles; then cold tiles at two fresh regions in turns
   (fused, staged, staged, fused).  Wire bytes fused = staged, float outputs
   within 1e-5 relative, the fused world's launches = its forwards (26 / 2
   / 1 a decoder / decoder / base forward), its compose fused (``compose``
   calls, no ``compose_elev``).  It prints each world's stage calls, cold
   and warm ms on both paths, the atlas bytes and the peak GiB, and
   ``{"atlas": {...}}``.
Phases 5, 6 and 7's Minecraft phase each zero the launch counts before their
requests and read them after: attention launches = base-model forwards
(latent_init + latent_step calls), fused-block launches = 26 x decoder
forwards, conv launches = 2 x decoder forwards, every one in the phase's
type.  The training phase zeroes them before each run.

The evaluation phase zeroes them before each of its card runs and sums
them by kernel and type.

The last lines are a JSON kernel report (a row per kernel and type:
launches from the Minecraft phase in float32 and bf16 and from the fp16
forwards in fp16, ``training_launches`` from the consistency run, the
autoencoder's evaluate and saved-model round trip and the GAN run and FID,
``evaluation_launches`` from the evaluation phase, which must be positive
for the three float32 kernels, ``surface_launches`` from the surface phase,
which must be positive for the float32 and bf16 kernels, and
``data_prep_launches`` from the data-preparation encode, which must be
positive for the float32 block and conv, and ``export_launches`` from the
loaded decoder program, which must be positive for the float32 block and
conv, and ``tools_launches`` from the tools phase, which must be positive
for the three float32 kernels, and ``parallel_launches`` from the mesh
world, which must be positive for the three float32 kernels, and
``atlas_launches`` from the atlas phase's fused worlds, which must be
positive for the float32 and bf16 kernels), the card's name and power
limit, and
{"ok": true, "device": {...}}.
"""
import configparser
import copy
import importlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_TOL = 1e-4
# 16-bit kernel vs plain version: about 2.5 steps of the type at the largest value
KERNEL_TOL16 = {" bf16": 1e-2, " fp16": 2.5e-3}
ERR16_RATIO = 1.25   # bf16 kernel's float64-oracle error over the plain version's, at most
UNET_TOL16 = 2e-2    # bf16 U-Net card vs CPU, relative RMSE
SEED = 20261016
# NVIDIA H100 SXM peaks (data sheet, dense, at the 700 W limit)
TC_TF32_FLOPS = 495e12  # TF32 tensor cores
TC_BF16_FLOPS = 989e12  # bf16 and fp16 tensor cores
F32_FLOPS = 67e12       # float32 on the CUDA cores
HBM_BYTES = 3.35e12     # device memory, bytes/s
# the unit a kernel runs its products on: (passes, peak FLOP/s, name)
UNITS = {"3xtf32": (3, TC_TF32_FLOPS, "3xTF32 tensor cores"),
         "bf16": (1, TC_BF16_FLOPS, "16-bit tensor cores"),
         "f32": (1, F32_FLOPS, "f32 CUDA cores")}
HEAD_COUT = 8  # conv3x3 runs convs to at most 8 channels on the CUDA cores
LAUNCHES_PER_FORWARD = {"fused_block": "26/decoder", "conv3x3": "2/decoder",
                        "attention": "1/base"}
SRC = "terrain_diffusion_tpu_torch/csrc/"
KERNELS = {  # name -> (source, TPU kernel it replaces, case reported in the JSON line)
    "fused_block": (SRC + "fused_block.cu", "terrain_diffusion_tpu/ops/pallas_block.py:420",
                    "enc 512x512 64->64 b2"),
    "conv3x3": (SRC + "conv3x3.cu", "terrain_diffusion_tpu/ops/pallas_block.py:595",
                "out conv 512x512 64->1 b2"),
    "attention": (SRC + "attention.cu", "terrain_diffusion_tpu/ops/pallas_attention.py:80",
                  "midblock 8x8 12x64 b64"),
}
BF16, FP16 = " bf16", " fp16"  # suffixes of the 16-bit rows' kernel names
LAUNCH_ROW_CASES = ("enc 512x512 64->64 b2", "dec 512x512 proj 192->64 b2")
# the VAE's block shapes (autoencoder_x8.cfg at 512x512 b2) that no decoder
# or training row has: (row name, (map, Cin, Cout, mode), options, launches)
VAE_BLOCK_CASES = [
    ("vae enc 256x256 64->64 b2", (256, 64, 64, "enc"), {}, "1/VAE encode"),
    ("vae enc 256x256 128->128 b2", (256, 128, 128, "enc"), {}, "1/VAE encode"),
    ("vae enc 128x128 128->128 b2", (128, 128, 128, "enc"), {}, "1/VAE encode"),
    ("vae enc 128x128 proj 128->256 b2", (128, 128, 256, "enc"), {"proj": True}, "1/VAE encode"),
    ("vae enc 128x128 256->256 b2", (128, 256, 256, "enc"), {}, "1/VAE encode"),
    ("vae dec 128x128 256->256 b2", (128, 256, 256, "dec"), {}, "3/VAE decode"),
    ("vae dec 256x256 pre-up 256 b2", (128, 256, 256, "dec"), {"up": 2}, "1/VAE decode"),
    ("vae dec 256x256 proj 256->128 b2", (256, 256, 128, "dec"), {"proj": True},
     "1/VAE decode"),
    ("vae dec 256x256 128->128 b2", (256, 128, 128, "dec"), {}, "2/VAE decode"),
    ("vae dec 512x512 pre-up 128 b2", (256, 128, 128, "dec"), {"up": 2}, "1/VAE decode"),
    ("vae dec 512x512 proj 128->64 b2", (512, 128, 64, "dec"), {"proj": True}, "1/VAE decode"),
    ("vae dec 512x512 64->64 b2", (512, 64, 64, "dec"), {}, "2/VAE decode"),
]


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def model_config(rel_path: str) -> dict:
    """The [model] section of a training config, JSON-decoded."""
    cp = configparser.ConfigParser(interpolation=None)
    cp.optionxform = str
    with open(os.path.join(ROOT, rel_path)) as f:
        cp.read_file(f)
    return {k: json.loads(v) for k, v in cp["model"].items() if not k.startswith("@")}


def time_ms(fn, iters: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 5) -> float:
    """Device time of one call of fn: iters calls captured in a CUDA graph
    (after a warm-up call outside it), replayed and timed with CUDA events."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        fn()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(iters):
                fn()
    torch.cuda.current_stream().wait_stream(stream)
    ms = time_ms(graph.replay, iters=3) / iters
    del graph
    return ms


def host_ms(fn, iters: int = 5) -> float:
    """Host time of one call of fn: the wall time of iters calls, none of
    which waits for the device (the queue was drained before), per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def bound_ms(flops: float, nbytes: float, unit: str):
    """The least time the card could take for this work, and what sets it:
    bytes over the memory rate, or operations over the peak of the unit that
    runs them (UNITS: three TF32 passes for a 3xTF32 kernel, one bf16 pass,
    or float32 on the CUDA cores)."""
    passes, peak, _ = UNITS[unit]
    t_ops = passes * flops / peak
    t_bytes = nbytes / HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(t) -> int:
    return t.numel() * t.element_size()


def block_work(x, w0, w1, c, wskip=None, x2=None, *, pre_upsample=1, **_):
    """(FLOPs, bytes) of one fused block: both 3x3 convs and the 1x1
    projection; each input read once, the output (in x's type) written once."""
    n, hs, ws, _ = x.shape
    px = n * hs * ws * pre_upsample ** 2
    cin0, cmid, cout = w0.shape[2], w0.shape[3], w1.shape[3]
    flops = 2 * 9 * px * (cin0 * cmid + cmid * cout)
    if wskip is not None:
        flops += 2 * px * wskip.shape[0] * wskip.shape[1]
    inputs = [t for t in (x, x2, w0, w1, c, wskip) if t is not None]
    return flops, sum(nbytes(t) for t in inputs) + px * cout * x.element_size()


def conv_work(x, w):
    px = x.shape[0] * x.shape[1] * x.shape[2]
    flops = 2 * 9 * px * w.shape[2] * w.shape[3]
    return flops, nbytes(x) + nbytes(w) + px * w.shape[3] * x.element_size()


def attn_work(qkv, heads):
    """QK^T and PV over every head; qkv read once, the output written once."""
    n, h, w, c3 = qkv.shape
    hw, c = h * w, c3 // 3
    return 2 * 2 * n * hw * hw * c, nbytes(qkv) + n * hw * c * qkv.element_size()


def conv_unit(w, dtype) -> str:
    """The unit conv3x3 runs a conv to w.shape[3] channels on, in dtype
    (fp16 tensor cores run at the bf16 rate)."""
    if w.shape[3] <= HEAD_COUT:
        return "f32"
    return "3xtf32" if dtype == "float32" else "bf16"


def sdpa_inputs(qkv, heads: int, eps: float = 1e-4):
    """q, k, v of every head, pixel-normed, as contiguous (N, heads, HW, ch)
    tensors: the inputs of the attention's library yardstick."""
    n, h, w, c3 = qkv.shape
    ch = c3 // 3 // heads
    y = qkv.reshape(n, h * w, heads, ch, 3).permute(4, 0, 2, 1, 3)
    y = y / (eps + y.norm(dim=-1, keepdim=True) / math.sqrt(ch))
    return [t.contiguous() for t in y]


def conv16_paths(fb):
    """The built library's 16-bit conv chooser equals the wrapper's mirror
    at every width up to 512 channels in and out, 1x1 and 3x3."""
    counts, wrong = {}, []
    for ks in (1, 3):
        for cin in range(1, 513):
            for cout in range(1, 513):
                got, want = fb.library_conv16_path(ks, cin, cout), fb.conv16_path(ks, cin, cout)
                if got != want:
                    wrong.append((ks, cin, cout, got, want))
                counts[want] = counts.get(want, 0) + 1
    check(not wrong, f"the library's 16-bit conv chooser differs from conv16_path at "
          f"{len(wrong)} (ks, cin, cout, library, mirror), first {wrong[:5]}")
    print(f"[kernel] 16-bit conv chooser equals conv16_path on every width pair: {counts}",
          flush=True)


def kernel_phase(torch, fb, attn, cuda_lib, dev):
    import torch.nn.functional as F

    conv16_paths(fb)
    g = torch.Generator().manual_seed(SEED)
    bf16 = torch.bfloat16

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    def exact(args):
        """The arguments in float64 on the card: the plain version's oracle."""
        return [t.double() if t is not None else None for t in args]

    def block_args(n, hs, cx, cout, mode, x2=False, proj=False, up=1, emb=True):
        cg = 2 * cx if x2 else cx
        c_main = cout if (mode == "enc" and proj) else cg
        args = (rand(n, hs, hs, cx),
                rand(3, 3, c_main, cout, scale=(9 * c_main) ** -0.5),
                rand(3, 3, cout, cout, scale=(9 * cout) ** -0.5),
                rand(n, cout, scale=0.3) + 1.0 if emb else None,
                rand(cg, cout, scale=cg ** -0.5) if proj else None,
                rand(n, hs, hs, cx) if x2 else None)
        kw = dict(mode=mode, pixel_norm=(mode == "enc"), res_balance=0.3,
                  clip_act=256.0, concat_scales=(0.7, 0.3) if x2 else None,
                  pre_upsample=up)
        return args, kw

    def block_case(*a, dtype=torch.float32, **k):
        args, kw = block_args(*a, **k)
        if dtype != torch.float32:  # the activations in dtype, weights and c float32
            args = (args[0].to(dtype), *args[1:5], None if args[5] is None else args[5].to(dtype))
        x, w0, w1 = args[:3]
        n, h, w = x.shape[0], x.shape[1] * kw["pre_upsample"], x.shape[2] * kw["pre_upsample"]
        # the library yardstick: cuDNN's two 3x3 convs of the block in its
        # type (no single call computes the block), on inputs of their shapes
        lib_in = [rand(n, h, w, wt.shape[2]).to(dtype).permute(0, 3, 1, 2) for wt in (w0, w1)]
        lib_w = [wt.to(dtype).permute(3, 2, 0, 1).contiguous() for wt in (w0, w1)]
        return dict(run=lambda: fb.fused_block(*args, **kw),
                    ref=lambda: fb.fused_block_reference(*args, **kw),
                    exact=lambda: fb.fused_block_reference(*exact(args), **kw),
                    library=lambda: [F.conv2d(i, wt, padding=1) for i, wt in zip(lib_in, lib_w)],
                    work=block_work(*args, **kw),
                    unit="3xtf32" if dtype == torch.float32 else "bf16",
                    relayout=None if dtype == torch.float32 else lambda: [
                        fb._k_major(wt, dtype, fb.INV_SILU_GAIN) for wt in (w0, w1)])

    def conv_case(n, cin, cout, dtype=torch.float32, size=512):
        x, wt = rand(n, size, size, cin).to(dtype), rand(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
        xv, w_oihw = x.permute(0, 3, 1, 2), wt.to(dtype).permute(3, 2, 0, 1).contiguous()
        label = "" if dtype == torch.float32 else f"[{fb.conv16_path(3, cin, cout)}]"
        return dict(run=lambda: fb.conv3x3(x, wt), ref=lambda: fb.conv3x3_reference(x, wt),
                    exact=lambda: fb.conv3x3_reference(*exact((x, wt))),
                    library=lambda: F.conv2d(xv, w_oihw, padding=1),
                    work=conv_work(x, wt), unit=conv_unit(wt, str(dtype).split(".")[-1]),
                    label=label,
                    relayout=None if dtype == torch.float32 else lambda: fb._k_major(wt, dtype))

    def attn_case(shape, heads, dtype=torch.float32):
        qkv = rand(*shape, scale=3.0).to(dtype)
        ch = shape[3] // 3 // heads
        path = attn.library_attention_path(ch)
        check(path == attn.attention_path(ch),
              f"ch = {ch}: the library dispatches to {path}, attention_path says "
              f"{attn.attention_path(ch)}")
        # the library yardstick computes less: no pixel norm, no layout change
        q, k, v = (t.to(dtype) for t in sdpa_inputs(qkv.float(), heads))
        return dict(run=lambda: attn.fused_pixelnorm_attention(qkv, heads),
                    ref=lambda: attn.pixelnorm_attention_reference(qkv, heads),
                    exact=lambda: attn.pixelnorm_attention_reference(qkv.double(), heads),
                    library=lambda: F.scaled_dot_product_attention(q, k, v),
                    work=attn_work(qkv, heads),
                    unit="3xtf32" if path == "tensor_cores" else "f32", label=f"[{path}]")

    cases = []
    for n in (1, 2):
        cases += [
            ("fused_block", f"enc 512x512 64->64 b{n}", block_case(n, 512, 64, 64, "enc")),
            ("fused_block", f"enc 256x256 proj 64->128 b{n}",
             block_case(n, 256, 64, 128, "enc", proj=True)),
            ("fused_block", f"dec 128x128 pre-up 256 b{n}",
             block_case(n, 64, 256, 256, "dec", up=2)),
            ("fused_block", f"dec 512x512 x2-concat 64+64->64 b{n}",
             block_case(n, 512, 64, 64, "dec", x2=True, proj=True)),
            ("fused_block", f"dec 512x512 proj 192->64 b{n}",
             block_case(n, 512, 192, 64, "dec", proj=True)),
            ("conv3x3", f"in conv 512x512 6->64 b{n}", conv_case(n, 6, 64)),
            ("conv3x3", f"out conv 512x512 64->1 b{n}", conv_case(n, 64, 1)),
        ]
    cases += [  # the largest decoder bucket
        ("fused_block", "enc 512x512 64->64 b16", block_case(16, 512, 64, 64, "enc")),
        ("conv3x3", "in conv 512x512 6->64 b16", conv_case(16, 6, 64)),
        ("conv3x3", "out conv 512x512 64->1 b16", conv_case(16, 64, 1)),
    ]
    for c in (64, 32):  # the training path: consistency teacher (64) and guide (32) at 128x128
        cases += [
            ("fused_block", f"train enc 128x128 {c}->{c} b16", block_case(16, 128, c, c, "enc")),
            ("fused_block", f"train dec 128x128 pre-up {2 * c} b16",
             block_case(16, 64, 2 * c, 2 * c, "dec", up=2)),
            ("fused_block", f"train dec 128x128 proj {3 * c}->{c} b16",
             block_case(16, 128, 3 * c, c, "dec", proj=True)),
            ("fused_block", f"train dec 128x128 x2-concat {c}+{c}->{c} b16",
             block_case(16, 128, c, c, "dec", x2=True, proj=True)),
            ("conv3x3", f"train in conv 128x128 6->{c} b16", conv_case(16, 6, c, size=128)),
            ("conv3x3", f"train out conv 128x128 {c}->1 b16", conv_case(16, c, 1, size=128)),
        ]
    cases += [("attention", f"midblock 8x8 12x64 b{n}", attn_case((n, 8, 8, 2304), 12))
              for n in (1, 16, 64)]
    cases += [("attention", "jax test 8x8 1x64 b2", attn_case((2, 8, 8, 192), 1)),
              ("attention", "jax test 16x16 2x64 b1", attn_case((1, 16, 16, 384), 2)),
              ("attention", "largest 32x64 3x64 b1", attn_case((1, 32, 64, 576), 3)),
              ("attention", "wide head 8x8 1x400 b1", attn_case((1, 8, 8, 1200), 1))]
    # the bf16 forms at the main path's shapes
    cases += [
        ("fused_block" + BF16, "enc 512x512 64->64 b1", block_case(1, 512, 64, 64, "enc",
                                                               dtype=bf16)),
        ("fused_block" + BF16, "enc 512x512 64->64 b2", block_case(2, 512, 64, 64, "enc",
                                                               dtype=bf16)),
        ("fused_block" + BF16, "enc 256x256 proj 64->128 b2",
         block_case(2, 256, 64, 128, "enc", proj=True, dtype=bf16)),
        ("fused_block" + BF16, "dec 128x128 pre-up 256 b2",
         block_case(2, 64, 256, 256, "dec", up=2, dtype=bf16)),
        ("fused_block" + BF16, "dec 512x512 x2-concat 64+64->64 b2",
         block_case(2, 512, 64, 64, "dec", x2=True, proj=True, dtype=bf16)),
        ("fused_block" + BF16, "dec 512x512 proj 192->64 b2",
         block_case(2, 512, 192, 64, "dec", proj=True, dtype=bf16)),
        ("fused_block" + BF16, "enc 512x512 64->64 b16",
         block_case(16, 512, 64, 64, "enc", dtype=bf16)),
    ]
    cases += [("conv3x3" + BF16, f"{io} conv 512x512 {cin}->{cout} b{n}",
               conv_case(n, cin, cout, dtype=bf16))
              for io, cin, cout in (("in", 6, 64), ("out", 64, 1)) for n in (2, 16)]
    cases += [("attention" + BF16, f"midblock 8x8 12x64 b{n}",
               attn_case((n, 8, 8, 2304), 12, dtype=bf16)) for n in (1, 16, 64)]
    fp16 = torch.float16  # the fp16 forms: the main path's rows of each kernel
    cases += [("fused_block" + FP16, "enc 512x512 64->64 b2",
               block_case(2, 512, 64, 64, "enc", dtype=fp16))]
    cases += [("conv3x3" + FP16, f"{io} conv 512x512 {cin}->{cout} b{n}",
               conv_case(n, cin, cout, dtype=fp16))
              for io, cin, cout in (("in", 6, 64), ("out", 64, 1)) for n in (2, 16)]
    cases += [("attention" + FP16, "midblock 8x8 12x64 b64",
               attn_case((64, 8, 8, 2304), 12, dtype=fp16))]
    # a 16-bit qkv off the tensor-core widths: the CUDA-core kernel's 16-bit form
    cases += [("attention" + sfx, "wide head 8x8 1x400 b1", attn_case((1, 8, 8, 1200), 1, dtype=dt))
              for sfx, dt in ((BF16, bf16), (FP16, fp16))]
    # the VAE (autoencoder_x8.cfg, 512x512 b2) at the shapes no row above has:
    # its blocks take no embedding (c = None)
    for sfx, dt in (("", torch.float32), (BF16, bf16)):
        cases += [("fused_block" + sfx, name, dict(block_case(2, *a, dtype=dt, emb=False, **k),
                                                    per_forward=per))
                  for name, a, k, per in VAE_BLOCK_CASES]
        cases += [("conv3x3" + sfx, "vae in conv 512x512 2->64 b2",
                   dict(conv_case(2, 2, 64, dtype=dt), per_forward="1/VAE encode"))]
    # the data-preparation encode: one 1024x1024 subchunk's eight D4 views
    # (8 x 1024 x 1024 x 64 float32 is 2^31 bytes), float32
    cases += [("fused_block", "prep enc 1024x1024 64->64 b8",
               dict(block_case(8, 1024, 64, 64, "enc", emb=False), per_forward="2/prep encode")),
              ("conv3x3", "prep in conv 1024x1024 2->64 b8",
               dict(conv_case(8, 2, 64, size=1024), per_forward="1/prep encode")),
              ("conv3x3", "prep out conv 128x128 256->8 b8",
               dict(conv_case(8, 256, 8, size=128), per_forward="1/prep encode"))]
    rows = []
    for kernel, name, case in cases:
        suffix = kernel[-len(BF16):] if kernel[-len(BF16):] in (BF16, FP16) else ""
        half = bool(suffix)
        got = case["run"]()
        torch.cuda.synchronize()
        want = case["ref"]()
        err_abs = float((got.float() - want.float()).abs().max())
        rel = err_abs / float(want.float().abs().max())
        oracle = ""
        if half:  # both against the unrounded plain version, in float64 on the card
            ex = case["exact"]()
            err64, err64_plain = rel_err(got.double(), ex), rel_err(want.double(), ex)
            oracle = f" float64: kernel {err64:.3e} plain {err64_plain:.3e}"
            del ex
        ms, plain_ms = time_ms(case["run"]), time_ms(case["ref"])
        lib_ms, lib_dev_ms = time_ms(case["library"]), graph_ms(case["library"])
        device_ms = graph_ms(case["run"])
        # the wrapper's host work, and of it the 16-bit weights' relayout
        host = host_ms(case["run"])
        relayout = host_ms(case["relayout"]) if case.get("relayout") else None
        flops, n_bytes = case["work"]
        b_ms, b_by = bound_ms(flops, n_bytes, case["unit"])
        f32_ms = flops / F32_FLOPS * 1e3
        label = f"{name} {case.get('label', '')}"
        base_kernel = kernel[:len(kernel) - len(suffix)]
        print(f"[kernel] {kernel:11s} {label:34s} rel_err={rel:.3e} max_abs_err={err_abs:.3e}"
              f"{oracle} kernel={ms:.4f} ms (device {device_ms:.4f} ms) plain={plain_ms:.4f} ms "
              f"library={lib_ms:.4f} ms (device {lib_dev_ms:.4f} ms; ms / library "
              f"{ms / lib_ms:.2f}x, device {device_ms / lib_dev_ms:.2f}x) host={host:.4f} ms "
              f"({host / ms:.0%} of eager"
              f"{'' if relayout is None else f'; weight relayout {relayout:.4f} ms'}) | "
              f"{flops / 1e9:.3f} GFLOP {n_bytes / 1e6:.1f} MB bound={b_ms:.4f} ms ({b_by}, "
              f"{UNITS[case['unit']][2]}) share={b_ms / ms:.1%} (device {b_ms / device_ms:.1%}) "
              f"f32-cuda-core={f32_ms:.4f} ms ({f32_ms / ms:.1%}) "
              f"launches/forward={case.get('per_forward', LAUNCHES_PER_FORWARD[base_kernel])}",
              flush=True)
        check(got.dtype == want.dtype, f"{name}: kernel type {got.dtype}, plain {want.dtype}")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        tol = KERNEL_TOL16[suffix] if half else KERNEL_TOL
        check(rel < tol, f"{kernel} {name}: rel err {rel:.3e} >= {tol}")
        if half:
            check(err64 <= ERR16_RATIO * err64_plain,
                  f"{kernel} {name}: {err64:.3e} from the float64 oracle, over {ERR16_RATIO} x "
                  f"the plain version's {err64_plain:.3e}")
        rows.append(dict(kernel=kernel, case=name, max_abs_err=err_abs, rel_err=rel,
                         ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=lib_ms,
                         library_device_ms=lib_dev_ms, host_ms=host, relayout_ms=relayout,
                         bound_ms=b_ms, bound_by=b_by))
        del got, want
    print("[kernel] attention library = F.scaled_dot_product_attention(q, k, v) on pre-normed "
          "contiguous (N, heads, HW, ch) tensors in the row's type, TF32 off: it leaves out the "
          "pixel norm and the layout change", flush=True)
    for kernel, name, case in cases:  # the bf16 block's launches, one row each
        if kernel == "fused_block" + BF16 and name in LAUNCH_ROW_CASES:
            launch_rows(torch, fb, cuda_lib, dev, name, case)
    float64_checks(torch, fb, attn, block_args, rand)
    return rows


class LaunchRecorder:
    """Stands in for the kernel library while one block runs: every call of a
    block entry point launches as it would, and then measure(entry, replay,
    arguments) times it alone, replay(stream) launching it again on the
    given stream, while the block's wrapper still holds its tensors."""

    def __init__(self, lib, measure):
        self.lib, self.measure = lib, measure

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if not name.startswith("tdt_block_"):
            return fn

        def call(*args):
            rc = fn(*args)
            if rc == 0:
                self.measure(name, lambda stream: fn(*args[:-1], stream), args)
            return rc
        return call


def launch_work(name, args):
    """(label, FLOPs, bytes, conv (n, h, w, ks, cin, cout) or None) of one
    recorded block launch, from its C arguments (csrc/fused_block.cu): each
    input read once, each output written once, at the real element sizes;
    None for an entry this accounting does not know."""
    if name == "tdt_block_prep":
        x_f32, pre_up, xs, xr, a, n, h, w, cx, dtype = (args[2], *args[5:6], *args[7:15])
        e = 4 if dtype == 0 else 2
        px, cg = n * h * w, (2 * cx if args[1] else cx)
        read = (px // 4 if pre_up else px) * cg * (4 if x_f32 else e)
        wrote = px * cg * (4 * bool(xs) + e * bool(xr) + e * bool(a))
        outs = "+".join(o for o, t in (("xs", xs), ("xr", xr), ("a", a)) if t)
        return f"prep -> {outs}", 0, read + wrote, None
    if name == "tdt_block_proj":
        x_f32, n, h, w, cin, cout, dtype = (args[1], *args[4:10])
        e, px = (4 if dtype == 0 else 2), n * h * w
        return ("projection", 2 * px * cin * cout,
                px * cin * (4 if x_f32 else e) + cin * cout * e + px * cout * 4,
                (n, h, w, 1, cin, cout))
    if name == "tdt_block_conv0":
        xs_f32, n, h, w, cin, cmid, dtype = (args[1], *args[5:11])
        e, px = (4 if dtype == 0 else 2), n * h * w
        return ("conv0", 18 * px * cin * cmid, px * cin * (4 if xs_f32 else e)
                + 9 * cin * cmid * e + n * cmid * 4 + px * cmid * e, (n, h, w, 3, cin, cmid))
    if name == "tdt_block_conv1":
        xres_f32, n, h, w, cmid, cout, dtype = (args[3], *args[5:10], args[15])
        e, px = (4 if dtype == 0 else 2), n * h * w
        return ("conv1", 18 * px * cmid * cout, px * cmid * e + 9 * cmid * cout * e
                + px * cout * ((4 if xres_f32 else e) + e), (n, h, w, 3, cmid, cout))
    return None


def launch_rows(torch, fb, cuda_lib, dev, name, case):
    """One row per launch of a bf16 block case: each launch recorded from one
    block call and replayed alone (eager ms: 5 calls; device ms: 5 calls in a
    CUDA graph), with its FLOPs, bytes, bf16 bound and, for a conv, cuDNN's
    bf16 F.conv2d of its shape as library_ms."""
    import torch.nn.functional as F

    rows = []

    def measure(entry, launch, args):
        def replay():
            check(launch(torch.cuda.current_stream().cuda_stream) == 0, f"{entry} replay failed")
        torch.cuda.synchronize()
        rows.append((entry, args, time_ms(replay), graph_ms(replay)))

    lib = cuda_lib.load()
    cuda_lib._lib = LaunchRecorder(lib, measure)
    try:
        case["run"]()
    finally:
        cuda_lib._lib = lib
    torch.cuda.synchronize()
    total = total_dev = total_bound = 0.0
    for entry, args, ms, dev_ms in rows:
        work = launch_work(entry, args)
        total, total_dev = total + ms, total_dev + dev_ms
        if work is None:
            print(f"[launch] fused_block bf16 {name}: {entry} {ms:.4f} ms (device "
                  f"{dev_ms:.4f} ms), work not counted", flush=True)
            continue
        label, flops, n_bytes, conv = work
        b_ms, b_by = bound_ms(flops, n_bytes, "bf16")
        total_bound += b_ms
        lib_txt = ""
        if conv is not None:
            n, h, w, ks, cin, cout = conv
            xi = torch.randn((n, h, w, cin), device=dev).bfloat16().permute(0, 3, 1, 2)
            wi = torch.randn((cout, cin, ks, ks), device=dev).bfloat16()
            lib_ms = time_ms(lambda: F.conv2d(xi, wi, padding=ks // 2))
            lib_txt = (f" library={lib_ms:.4f} ms (cuDNN bf16 F.conv2d {ks}x{ks} {cin}->{cout}) "
                       f"core={fb.conv16_path(ks, cin, cout)}")
            del xi, wi
        print(f"[launch] fused_block bf16 {name}: {label:18s} {ms:.4f} ms (device {dev_ms:.4f} "
              f"ms) | {flops / 1e9:.3f} GFLOP {n_bytes / 1e6:.1f} MB bound={b_ms:.4f} ms "
              f"({b_by}) share={b_ms / ms:.1%} (device {b_ms / dev_ms:.1%}){lib_txt}", flush=True)
    print(f"[launch] fused_block bf16 {name}: {len(rows)} launches, summed "
          f"{total:.4f} ms (device {total_dev:.4f} ms) against a summed bound of "
          f"{total_bound:.4f} ms", flush=True)


def float64_checks(torch, fb, attn, block_args, rand):
    """The fused block and the attention against their plain versions run in
    float64 on the CPU, beside the float32 plain version's own error: the
    block at production widths on maps small enough for the CPU, the
    attention at the midblock b64 and the largest eligible map."""
    for name, a, k in (("enc 128x128 proj 64->128", (1, 128, 64, 128, "enc"), {"proj": True}),
                       ("dec 64x64 pre-up 256", (1, 32, 256, 256, "dec"), {"up": 2}),
                       ("dec 128x128 x2-concat 64+64->64", (1, 128, 64, 64, "dec"),
                        {"x2": True, "proj": True}),
                       ("dec 128x128 proj 192->64", (1, 128, 192, 64, "dec"), {"proj": True})):
        args, kw = block_args(*a, **k)
        got = fb.fused_block(*args, **kw).double().cpu()
        plain = fb.fused_block_reference(*args, **kw).double().cpu()
        exact = fb.fused_block_reference(
            *(t.double().cpu() if t is not None else None for t in args), **kw)
        rel = rel_err(got, exact)
        print(f"[float64] fused_block {name}: kernel vs float64 CPU rel_err={rel:.3e} "
              f"(the plain version, cuDNN float32: {rel_err(plain, exact):.3e})", flush=True)
        check(rel < KERNEL_TOL, f"fused block {name}: {rel:.3e} from the float64 oracle")
    for name, shape, heads in (("midblock 8x8 12x64 b64", (64, 8, 8, 2304), 12),
                               ("largest 32x64 3x64 b1", (1, 32, 64, 576), 3)):
        qkv = rand(*shape, scale=3.0)
        got = attn.fused_pixelnorm_attention(qkv, heads).double().cpu()
        plain = attn.pixelnorm_attention_reference(qkv, heads).double().cpu()
        exact = attn.pixelnorm_attention_reference(qkv.double().cpu(), heads)
        rel, rel_plain = rel_err(got, exact), rel_err(plain, exact)
        print(f"[float64] attention {name} [{attn.attention_path(shape[3] // 3 // heads)}]: "
              f"kernel vs float64 CPU rel_err={rel:.3e} (the plain version, float32: "
              f"{rel_plain:.3e}; ratio {rel / rel_plain:.2f})", flush=True)
        check(rel < KERNEL_TOL and rel <= 2 * rel_plain,
              f"attention {name}: {rel:.3e} from the float64 oracle, plain {rel_plain:.3e}")


def decoder_forward_phase(torch, fb, decoder, dev, dtype="float32"):
    """One production-width decoder forward at 512x512, b2 and b16, in
    ``dtype``, timed with CUDA events, beside the summed bound of its kernel
    launches (the shapes recorded from the forward itself)."""
    from terrain_diffusion_tpu_torch.nn import edm_unet, layers
    from terrain_diffusion_tpu_torch.ops import cuda_lib

    g = torch.Generator().manual_seed(SEED + 3)
    dt = getattr(torch, dtype)
    for n in (2, 16):
        x = torch.randn((n, 512, 512, 5), generator=g).to(dev, dt)
        nl = torch.full((n,), 1.2, device=dev, dtype=dt)
        calls = []
        fused, conv = layers.fused_block, edm_unet.conv3x3

        def rec_block(*a, **k):
            calls.append((*block_work(*a, **k), "3xtf32" if dtype == "float32" else "bf16"))
            return fused(*a, **k)

        def rec_conv(x, w):
            calls.append((*conv_work(x, w), conv_unit(w, dtype)))
            return conv(x, w)

        layers.fused_block, edm_unet.conv3x3 = rec_block, rec_conv
        cuda_lib.reset_launch_counts()
        try:
            with torch.no_grad():
                decoder(x, nl, [])
        finally:
            layers.fused_block, edm_unet.conv3x3 = fused, conv
        check(len(calls) == 28, f"decoder forward made {len(calls)} kernel calls, not 26 + 2")
        typed = (fb.fused_block.launches_by_dtype.get(dt, 0),
                 fb.conv3x3.launches_by_dtype.get(dt, 0))
        check(typed == (26, 2), f"decoder forward launched {typed} {dtype} kernels, not 26 + 2")
        bound = sum(bound_ms(*call)[0] for call in calls)
        flops = sum(f for f, _, _ in calls)
        with torch.no_grad():
            ms = time_ms(lambda: decoder(x, nl, []), iters=3)
        unit = "3xTF32" if dtype == "float32" else "16-bit"
        print(f"[decoder] forward 512x512 b{n}{'' if dtype == 'float32' else ' ' + dtype}: "
              f"{ms:.2f} ms; its 26 + 2 kernel launches: {flops / 1e9:.1f} GFLOP, summed bound "
              f"{bound:.2f} ms ({unit} tensor cores / bytes), f32 CUDA-core figure "
              f"{flops / F32_FLOPS * 1e3:.2f} ms", flush=True)
        del x


def fp16_forward_phase(torch, fb, attn, models, dev) -> dict:
    """The fp16 forms on the main path: one decoder forward at 512x512 b2
    and one base forward (attention kernel) at 64x64 in fp16, with their
    fp16 launches (26 blocks + 2 convs, 1 attention), then the decoder
    forward timed at b2 and b16 as in float32 and bf16."""
    from terrain_diffusion_tpu_torch.ops import cuda_lib

    fp16 = torch.float16
    g = torch.Generator().manual_seed(SEED + 5)
    decoder, base = models[2], models[1]
    cuda_lib.reset_launch_counts()
    with torch.no_grad():
        y = decoder(torch.randn((2, 512, 512, 5), generator=g).to(dev, fp16),
                    torch.full((2,), 1.2, device=dev, dtype=fp16), [])
        z = base(torch.randn((1, 64, 64, 5), generator=g).to(dev, fp16),
                 torch.full((1,), 0.9, device=dev, dtype=fp16),
                 [torch.randn((1, 58), generator=g).to(dev, fp16)])
    launches = {"fused_block": fb.fused_block.launches_by_dtype.get(fp16, 0),
                "conv3x3": fb.conv3x3.launches_by_dtype.get(fp16, 0),
                "attention": attn.fused_pixelnorm_attention.launches_by_dtype.get(fp16, 0)}
    print(f"[fp16] decoder 512x512 b2 + base 64x64 forwards: fp16 launches {launches}",
          flush=True)
    check(all(bool(torch.isfinite(t.float()).all()) and t.dtype == fp16 for t in (y, z)),
          "fp16 forwards: non-finite or not fp16")
    check(launches == {"fused_block": 26, "conv3x3": 2, "attention": 1},
          f"fp16 forwards launched {launches}, not 26 + 2 + 1")
    decoder_forward_phase(torch, fb, decoder, dev, "float16")
    return launches


def threefry_phase(torch, dev):
    """The threefry field on the card equals the CPU's, bit for bit."""
    from terrain_diffusion_tpu_torch.ops.noise_field import threefry_noise_patch

    kw = dict(h=512, w=768, channels=5, tile_h=256, tile_w=256)
    seed, y0, x0 = 2 ** 63 + SEED, -300, -1001
    t0 = time.perf_counter()
    got = threefry_noise_patch(seed, y0, x0, device=dev, **kw)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) * 1000
    want = threefry_noise_patch(seed, y0, x0, device="cpu", **kw)
    diff = float((got.cpu() - want).abs().max())
    std = float(want.std())
    print(f"[threefry] crop (5, 512, 768) at ({y0}, {x0}): card vs CPU max|diff|={diff}, "
          f"std={std:.4f}, card {dt:.1f} ms", flush=True)
    check(torch.equal(got.cpu(), want), f"threefry noise on the card differs from the CPU: {diff}")
    check(abs(std - 1.0) < 0.01, f"threefry noise std {std}")


def set_attention_impl(model, impl: str):
    from terrain_diffusion_tpu_torch.nn.layers import UNetBlock

    for m in model.modules():
        if isinstance(m, UNetBlock):
            m.attention_impl = impl


def build_models(torch, dev):
    from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig

    g = torch.Generator().manual_seed(SEED + 1)
    models = []
    for rel in ("configs/diffusion_coarse/diffusion_coarse.cfg",
                "configs/diffusion_base/diffusion_192-3.cfg",
                "configs/diffusion_decoder/diffusion_decoder_64-3.cfg"):
        cfg = model_config(rel)
        if "diffusion_base" in rel:  # the JAX value that asks for the attention kernel
            cfg["block_kwargs"] = {**cfg.get("block_kwargs", {}), "attention_impl": "pallas"}
        m = EDMUnet2D(EDMUnetConfig.from_dict(cfg), device=dev, generator=g)
        with torch.no_grad():  # init leaves the gains at 0: a constant network
            for name, p in m.named_parameters():
                if name.endswith("emb_gain"):
                    p.copy_(torch.randn((), generator=g) * 0.5)
                elif name == "out_gain":
                    p.fill_(1.0)
        models.append(m.eval())
        print(f"[model] {rel}: {m.count_parameters() / 1e6:.2f} M parameters", flush=True)
    return models


def model_phase(torch, np, attn, models, dev):
    """Decoder and base U-Nets on the card (kernels) vs the same modules on
    the CPU (plain versions); then latent_init at bucket 64, kernel vs plain
    attention."""
    from terrain_diffusion_tpu_torch.pipeline.world import (SCHED, SD, WorldPipeline,
                                                            compute_sigmas)

    g = torch.Generator().manual_seed(SEED + 2)
    decoder, base = models[2], models[1]
    x = torch.randn((1, 128, 128, 5), generator=g)
    nl = torch.full((1,), 1.2)
    with torch.no_grad():
        got = decoder(x.to(dev), nl.to(dev), []).cpu()
        want = copy.deepcopy(decoder).cpu()(x, nl, [])
    rel = rel_err(got, want)
    print(f"[model] decoder 128x128 card vs CPU: rel_err={rel:.3e}", flush=True)
    check(bool(torch.isfinite(got).all()) and rel < KERNEL_TOL,
          f"decoder forward on the card disagrees with the CPU: {rel:.3e}")

    x = torch.randn((2, 64, 64, 5), generator=g)
    cond = torch.randn((2, 58), generator=g)
    nl = torch.full((2,), 0.9)
    with torch.no_grad():
        before = attn.fused_pixelnorm_attention.launches
        got = base(x.to(dev), nl.to(dev), [cond.to(dev)]).cpu()
        launched = attn.fused_pixelnorm_attention.launches - before
        want = copy.deepcopy(base).cpu()(x, nl, [cond])
    rel = rel_err(got, want)
    print(f"[model] base 64x64 (attention kernel) card vs CPU: rel_err={rel:.3e}, "
          f"attention launches {launched}", flush=True)
    check(launched == 1, f"base forward launched the attention kernel {launched} times")
    check(bool(torch.isfinite(got).all()) and rel < KERNEL_TOL,
          f"base forward on the card disagrees with the CPU: {rel:.3e}")

    # one latent_init window call at bucket 64, kernel vs plain attention
    pipe = WorldPipeline(seed=SEED, device=dev, log_mode="info").set_models(*models)
    t_init = float(np.arctan(float(compute_sigmas(SCHED, 20)[0]) / SD))  # as the stage has it
    init_f = pipe._latent_program(t_init, 5819, with_prev=False)[0]
    ctxs = np.stack([np.zeros(64, np.int64), np.arange(64) // 8, np.arange(64) % 8], axis=1)
    coarse = torch.randn((64, 7, 4, 4), generator=g).to(dev)
    coarse[:, -1] = 1.0  # the window-weight channel
    out, turns = {}, {"pallas": [], "xla": []}
    with torch.no_grad():  # in turns: kernel, plain, plain, kernel; the least of each
        for impl in ("pallas", "xla", "xla", "pallas"):
            set_attention_impl(base, impl)
            out[impl] = init_f(ctxs, coarse)
            turns[impl].append(time_ms(lambda: init_f(ctxs, coarse), iters=3))
    set_attention_impl(base, "pallas")
    rel = rel_err(out["pallas"][:, :-1], out["xla"][:, :-1])
    print(f"[latent] latent_init b64: attention kernel {min(turns['pallas']):.1f} ms, plain "
          f"attention {min(turns['xla']):.1f} ms (turns: kernel "
          f"{', '.join(f'{t:.1f}' for t in turns['pallas'])}; plain "
          f"{', '.join(f'{t:.1f}' for t in turns['xla'])}), rel_err={rel:.3e}", flush=True)
    check(rel < KERNEL_TOL, f"latent_init with the kernel disagrees with plain: {rel:.3e}")


def rrmse(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())


def model_phase_bf16(torch, np, fb, attn, models, dev):
    """The decoder and base U-Nets in bf16 on the card (the kernels' 16-bit
    forms) against the same modules in bf16 on the CPU (plain versions),
    with their launches; then latent_init at bucket 64 in bf16, with the
    attention kernel and with the plain attention."""
    from terrain_diffusion_tpu_torch.ops import cuda_lib
    from terrain_diffusion_tpu_torch.pipeline.world import (SCHED, SD, WorldPipeline,
                                                            compute_sigmas)

    bf16 = torch.bfloat16
    g = torch.Generator().manual_seed(SEED + 4)
    decoder, base = models[2], models[1]
    # at a 128x128 input only the top level's blocks reach the kernels'
    # 128 x 128 pixels (the 512x512 forward of the decoder phase runs 26)
    top = f"{decoder.config.image_size}x{decoder.config.image_size}_"
    n_top = sum(1 for name, kind, *_ in decoder.enc_plan + decoder.dec_plan
                if kind == "block" and name.startswith(top))
    for name, model, x, cond, want_launches in (
            ("decoder 128x128", decoder, torch.randn((1, 128, 128, 5), generator=g), [],
             {"fused_block": n_top, "conv3x3": 2}),
            ("base 64x64 (attention kernel)", base, torch.randn((1, 64, 64, 5), generator=g),
             [torch.randn((1, 58), generator=g)], {"attention": 1})):
        nl = torch.full((1,), 0.9)
        cuda_lib.reset_launch_counts()
        with torch.no_grad():
            got = model(x.to(dev, bf16), nl.to(dev, bf16), [c.to(dev, bf16) for c in cond]).cpu()
            launched = {"fused_block": fb.fused_block.launches_by_dtype.get(bf16, 0),
                        "conv3x3": fb.conv3x3.launches_by_dtype.get(bf16, 0),
                        "attention": attn.fused_pixelnorm_attention.launches_by_dtype.get(bf16, 0)}
            t0 = time.perf_counter()
            want = copy.deepcopy(model).cpu()(x.to(bf16), nl.to(bf16), [c.to(bf16) for c in cond])
            cpu_s = time.perf_counter() - t0
        err = rrmse(got, want)
        print(f"[model bf16] {name} card vs CPU: rel RMSE {err:.3e} (CPU forward {cpu_s:.1f} s), "
              f"bf16 launches {launched}", flush=True)
        check(got.dtype == bf16 and bool(torch.isfinite(got.float()).all()) and err < UNET_TOL16,
              f"bf16 {name} on the card disagrees with the CPU: {err:.3e}")
        check(all(launched[k] == v for k, v in want_launches.items()),
              f"bf16 {name}: launches {launched}, expected {want_launches}")

    pipe = WorldPipeline(seed=SEED, device=dev, log_mode="info", dtype="bf16").set_models(*models)
    t_init = float(np.arctan(float(compute_sigmas(SCHED, 20)[0]) / SD))
    init_f = pipe._latent_program(t_init, 5819, with_prev=False)[0]
    ctxs = np.stack([np.zeros(64, np.int64), np.arange(64) // 8, np.arange(64) % 8], axis=1)
    coarse = torch.randn((64, 7, 4, 4), generator=g).to(dev)
    coarse[:, -1] = 1.0
    out, turns = {}, {"pallas": [], "xla": []}
    with torch.no_grad():
        for impl in ("pallas", "xla", "xla", "pallas"):
            set_attention_impl(base, impl)
            out[impl] = init_f(ctxs, coarse)
            turns[impl].append(time_ms(lambda: init_f(ctxs, coarse), iters=3))
    set_attention_impl(base, "pallas")
    err = rrmse(out["pallas"][:, :-1], out["xla"][:, :-1])
    print(f"[latent bf16] latent_init b64 in bf16: attention kernel {min(turns['pallas']):.1f} "
          f"ms, plain attention {min(turns['xla']):.1f} ms (turns: kernel "
          f"{', '.join(f'{t:.1f}' for t in turns['pallas'])}; plain "
          f"{', '.join(f'{t:.1f}' for t in turns['xla'])}), rel RMSE {err:.3e}", flush=True)
    check(err < UNET_TOL16, f"bf16 latent_init with the kernel disagrees with plain: {err:.3e}")


def http_get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=900) as r:
        return r.status, dict(r.headers), r.read()


class Server:
    """A WSGI app on an ephemeral localhost port, in a thread."""

    def __init__(self, app, **kw):
        self.httpd = app.make_server("127.0.0.1", 0, quiet=True, **kw)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=60)


def stage_calls(pipe) -> dict:
    return {k: v[0] for k, v in pipe.stage_timings.items()}


def forward_launches(pipe, calls_before, label) -> dict:
    """The launches that the model forwards the pipeline's stages ran since
    ``calls_before`` make: 26 blocks and 2 convs a decoder forward, one
    attention a base forward (a fused T=1 ``latent_t1`` call runs 1 + its
    intermediate steps)."""
    calls = stage_calls(pipe)
    n = {k: calls.get(k, 0) - calls_before.get(k, 0)
         for k in ("latent_init", "latent_step", "latent_t1", "decoder")}
    # a fused T=1 call runs init and each intermediate step: 1 + steps forwards
    t1_forwards = 1 if getattr(pipe, "onestep_latent", False) else 2
    n_base = n["latent_init"] + n["latent_step"] + t1_forwards * n["latent_t1"]
    n_dec = n["decoder"]
    print(f"[{label}] base forwards {n_base}, decoder forwards {n_dec}", flush=True)
    check(n_base > 0 and n_dec > 0, f"{label}: no base or decoder forward ran")
    return {"fused_block": 26 * n_dec, "conv3x3": 2 * n_dec, "attention": n_base}


def check_launches(torch, cuda_lib, fb, attn, pipe, calls_before, label, dtype=None) -> dict:
    """Launch counts since the last reset against the model forwards the
    pipeline's stages ran; with ``dtype``, every launch must be of that
    type's kernels."""
    launches = {"fused_block": fb.fused_block.launches, "conv3x3": fb.conv3x3.launches,
                "attention": attn.fused_pixelnorm_attention.launches}
    print(f"[{label}] launches {launches}", flush=True)
    want = forward_launches(pipe, calls_before, label)
    check(launches == want, f"{label}: launch counts {launches} != {want}")
    if dtype is not None:
        typed = {"fused_block": fb.fused_block, "conv3x3": fb.conv3x3,
                 "attention": attn.fused_pixelnorm_attention}
        typed = {k: fn.launches_by_dtype.get(dtype, 0) for k, fn in typed.items()}
        print(f"[{label}] launches of the {dtype} kernels {typed}", flush=True)
        check(typed == want, f"{label}: {dtype} launch counts {typed} != {want}")
    for stage, v in pipe.timing_summary().items():
        print(f"[{label}] stage {stage:16s} calls={v['calls']:4d} "
              f"total={v['total_s'] * 1000:.1f} ms mean={v['mean_ms']:.2f} ms", flush=True)
    print(f"[{label}] peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    return launches


def api_phase(torch, np, cuda_lib, fb, attn, models, dev):
    """The /terrain API, single-threaded, portable noise."""
    from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline
    from terrain_diffusion_tpu_torch.serving import api

    pipe = WorldPipeline(seed=SEED, noise_mode="portable", device=dev).set_models(*models)
    t0 = time.perf_counter()
    pipe.bind()  # set-up (synthetic-map quantile tables), timed apart from requests
    print(f"[api] bind {(time.perf_counter() - t0) * 1000:.1f} ms", flush=True)
    api.configure(pipeline=pipe)
    bodies = []
    with Server(api.app) as srv:
        status, _, body = http_get(srv.port, "/health")
        check(status == 200 and json.loads(body) == {"status": "ok"}, "/health")
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launch_counts()
        before = stage_calls(pipe)
        for path in ("/terrain?i1=0&j1=0&i2=256&j2=256&scale=1",
                     "/terrain?i1=0&j1=0&i2=256&j2=256&scale=1",
                     "/terrain?i1=128&j1=192&i2=384&j2=448&scale=1"):
            dec_before = stage_calls(pipe).get("decoder", 0)
            t0 = time.perf_counter()
            status, headers, body = http_get(srv.port, path)
            wall = time.perf_counter() - t0
            bodies.append(body)
            h, w = int(headers["X-Height"]), int(headers["X-Width"])
            check(status == 200 and (h, w) == (256, 256), f"{path}: {status} {h}x{w}")
            check(len(body) == h * w * 2 + h * w * 4 * 4, f"{path}: payload {len(body)}")
            elev = np.frombuffer(body[:h * w * 2], dtype="<i2")
            climate = np.frombuffer(body[h * w * 2:], dtype="<f4")
            check(bool(np.isfinite(climate).all()), f"{path}: non-finite climate")
            check(elev.min() > -32768 and elev.max() < 32767 and elev.std() > 0,
                  f"{path}: elevation saturated or constant")
            print(f"[api] GET {path}: {wall * 1000:.1f} ms, decoder batches "
                  f"{stage_calls(pipe).get('decoder', 0) - dec_before}, "
                  f"elev [{elev.min()}, {elev.max()}] m", flush=True)
        launches = check_launches(torch, cuda_lib, fb, attn, pipe, before, "api")
    check(bodies[0] == bodies[1], "repeated /terrain request is not byte-identical")
    pipe.close()
    return launches


def start_minecraft_server(mc, world_dir: str, port: int, *extra) -> threading.Thread:
    """``minecraft_api.main`` as a user runs it (``extra`` arguments
    appended), in a thread that serves until ``mc.app.server.shutdown()``;
    returns the thread once /health answers."""
    errors = []

    def serve():
        try:
            mc.main([world_dir, "--device", "cuda", "--threaded", "--host", "127.0.0.1",
                     "--port", str(port), "--seed", str(SEED),
                     "--batch-size", "1,2,4,8,16,32,64", "--log-mode", "info", *extra])
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    deadline = time.perf_counter() + 300
    while True:
        if errors:
            fail(f"minecraft_api.main failed: {errors[0]!r}")
        try:
            status, _, body = http_get(port, "/health")
            break
        except OSError:
            check(time.perf_counter() < deadline, "the Minecraft server did not start")
            time.sleep(0.2)
    check(status == 200 and json.loads(body) == {"status": "ok"}, "/health")
    return thread


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tile_getter(np, mc, port):
    """get_tile(path) -> (wall s, body, elevation, biome ids) of a 256x256
    Minecraft /terrain answer, checked."""
    biome_ids = set(mc.BIOME_ID.values()) | {41, 44, 46, 48}  # + the ocean ids

    def get_tile(path):
        t0 = time.perf_counter()
        status, headers, body = http_get(port, path)
        wall = time.perf_counter() - t0
        h, w = int(headers.get("X-Height", -1)), int(headers.get("X-Width", -1))
        check(status == 200 and (h, w) == (256, 256), f"{path}: {status} {h}x{w}")
        check(len(body) == 2 * 2 * h * w, f"{path}: payload {len(body)}")
        elev = np.frombuffer(body[:2 * h * w], dtype="<i2")
        biome = np.frombuffer(body[2 * h * w:], dtype="<i2")
        check(elev.min() > -32768 and elev.max() < 32767 and elev.std() > 0,
              f"{path}: elevation saturated or constant")
        check(set(np.unique(biome).tolist()) <= biome_ids, f"{path}: unknown biome ids")
        return wall, body, elev, biome

    return get_tile


def minecraft_phase(torch, np, cuda_lib, fb, attn, models, dev, world_dir):
    """The Minecraft server through its entry point: the models saved as a
    world directory, loaded by ``minecraft_api.main`` with --threaded
    (coalesced serving), WorldPipeline at its defaults (threefry, T=2).
    Returns the launches and the first tile's body."""
    from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline
    from terrain_diffusion_tpu_torch.serving import minecraft_api as mc
    from terrain_diffusion_tpu_torch.serving.coalesce import CoalescedPipeline

    port = free_port()
    t0 = time.perf_counter()
    WorldPipeline(device=dev).set_models(*models).save_pretrained(world_dir)
    print(f"[minecraft] world saved in {(time.perf_counter() - t0) * 1000:.1f} ms",
          flush=True)
    t0 = time.perf_counter()
    server = start_minecraft_server(mc, world_dir, port)
    print(f"[minecraft] server up (weights loaded, bound) in "
          f"{(time.perf_counter() - t0) * 1000:.1f} ms", flush=True)
    world = mc._PIPELINE
    check(isinstance(world, CoalescedPipeline), "threaded Minecraft serving is not coalesced")
    check(world.noise_mode == "threefry" and world.T == 2 and world.device.type == "cuda",
          "the world does not run at the defaults on the card")
    get_tile = tile_getter(np, mc, port)

    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    before = stage_calls(world)
    bodies = []
    for path in ("/terrain?i1=0&j1=0&i2=256&j2=256", "/terrain?i1=0&j1=0&i2=256&j2=256",
                 "/terrain?i1=1024&j1=-1024&i2=1280&j2=-768&scale=4",
                 "/90?i1=256&j1=0&i2=512&j2=256"):
        wall, body, elev, biome = get_tile(path)
        bodies.append(body)
        print(f"[minecraft] GET {path}: {wall * 1000:.1f} ms, elev [{elev.min()}, "
              f"{elev.max()}] m, {len(np.unique(biome))} biomes", flush=True)
    check(bodies[0] == bodies[1], "repeated Minecraft /terrain request is not byte-identical")

    paths = [f"/terrain?i1={i}&j1={j}&i2={i + 256}&j2={j + 256}"
             for i in (2048, 2304) for j in (-512, -256)]
    results = [None] * 4

    def client(k):
        results[k] = get_tile(paths[k])

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    check(all(r is not None for r in results), "a concurrent request failed")
    print(f"[minecraft] 4 concurrent adjacent tiles: {wall * 1000:.1f} ms "
          f"(each {', '.join(f'{r[0] * 1000:.1f}' for r in results)} ms)", flush=True)
    launches = check_launches(torch, cuda_lib, fb, attn, world, before, "minecraft")
    # The four tiles again, one at a time and computed afresh.  Bar: the CPU
    # parity test's (elevation within 1 m, biome ids equal on >= 99% of
    # pixels), since one-tile requests run the stages at smaller batch buckets,
    # where cuDNN and cuBLAS may pick kernels of another summation order.
    world.empty_cache()
    for k, path in enumerate(paths):
        _, body, elev, biome = get_tile(path)
        d_elev = int(np.abs(elev.astype(np.int32) - results[k][2]).max())
        same_biome = float(np.mean(biome == results[k][3]))
        print(f"[minecraft] {path} one at a time, uncached, vs concurrent: byte-identical "
              f"{body == results[k][1]}, max|elev diff| {d_elev} m, "
              f"biome ids equal on {same_biome:.4f}", flush=True)
        check(d_elev <= 1 and same_biome >= 0.99,
              f"{path}: concurrent and sequential responses differ")
    mc.app.server.shutdown()
    server.join(timeout=60)
    world.close()
    return launches, bodies[0]


def minecraft_phase_bf16(torch, np, cuda_lib, fb, attn, dev, world_dir, f32_tile):
    """The bf16 Minecraft server: ``minecraft_api.main(... --dtype bf16
    --threaded)`` on the world of the float32 phase; a cold tile, the same
    again, four adjacent cold tiles at once; the cold tile against the float32
    phase's."""
    from terrain_diffusion_tpu_torch.serving import minecraft_api as mc

    port = free_port()
    t0 = time.perf_counter()
    server = start_minecraft_server(mc, world_dir, port, "--dtype", "bf16")
    print(f"[minecraft bf16] server up (weights loaded, bound) in "
          f"{(time.perf_counter() - t0) * 1000:.1f} ms", flush=True)
    world = mc._PIPELINE
    check(world.compute_dtype == torch.bfloat16 and world.device.type == "cuda",
          "the bf16 world does not run in bf16 on the card")
    get_tile = tile_getter(np, mc, port)
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    before = stage_calls(world)
    path = "/terrain?i1=0&j1=0&i2=256&j2=256"
    bodies = []
    for label in ("cold", "again"):
        wall, body, elev, biome = get_tile(path)
        bodies.append(body)
        print(f"[minecraft bf16] GET {path} ({label}): {wall * 1000:.1f} ms, elev "
              f"[{elev.min()}, {elev.max()}] m, {len(np.unique(biome))} biomes", flush=True)
    check(bodies[0] == bodies[1], "repeated bf16 Minecraft /terrain request is not byte-identical")
    n = 256 * 256
    elev16 = np.frombuffer(bodies[0][:2 * n], "<i2").astype(np.float64)
    elev32 = np.frombuffer(f32_tile[:2 * n], "<i2").astype(np.float64)
    err = float(np.sqrt(np.mean((elev16 - elev32) ** 2)) / np.sqrt(np.mean(elev32 ** 2)))
    same_biome = float(np.mean(np.frombuffer(bodies[0][2 * n:], "<i2")
                               == np.frombuffer(f32_tile[2 * n:], "<i2")))
    print(f"[minecraft bf16] cold tile vs the float32 phase's: elevation rel RMSE {err:.3e}, "
          f"max|diff| {np.abs(elev16 - elev32).max():.0f} m, biome ids equal on "
          f"{same_biome:.4f}", flush=True)
    check(bool(np.isfinite(err)), "bf16 tile: non-finite elevation error")
    paths = [f"/terrain?i1={i}&j1={j}&i2={i + 256}&j2={j + 256}"
             for i in (2048, 2304) for j in (-512, -256)]
    results = [None] * 4

    def client(k):
        results[k] = get_tile(paths[k])

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    check(all(r is not None for r in results), "a concurrent bf16 request failed")
    print(f"[minecraft bf16] 4 concurrent adjacent tiles: {wall * 1000:.1f} ms "
          f"(each {', '.join(f'{r[0] * 1000:.1f}' for r in results)} ms)", flush=True)
    launches = check_launches(torch, cuda_lib, fb, attn, world, before, "minecraft bf16",
                              dtype=torch.bfloat16)
    mc.app.server.shutdown()
    server.join(timeout=60)
    world.close()
    return launches


# ---------------------------------------------------------------------------
# training phase
# ---------------------------------------------------------------------------

TRAIN_TOL = 1e-4  # card vs CPU training step, relative (TF32 off)
DECODER_CFG = "configs/diffusion_decoder/diffusion_decoder_64-3.cfg"
CONSISTENCY_CFG = "configs/diffusion_decoder/consistency_decoder_64-3.cfg"
GUIDE_CFG = "configs/diffusion_decoder/diffusion_decoder_32-3.cfg"
BASE_CFG = "configs/diffusion_base/diffusion_192-3.cfg"
UNUSED_SECTIONS = ("val_dataset", "sweep_dataset", "results_dataset")  # not read by a short run


class MemoryDataset:
    """Training items made from a seed with numpy, in the item layout of the
    port's datasets (no h5py on the card): ``decoder`` as
    ``H5DecoderTerrainDataset`` gives them (image = the residual crop times
    sigma_data, (crop, crop, 1); cond_img = the nearest-up x8 latent sample,
    (crop, crop, 4)), ``latents`` as ``H5LatentsDataset`` (image = 4 latent
    channels + lowfreq, (crop, crop, 5); cond_inputs = [the 58-dim vector]),
    ``autoencoder`` as ``H5AutoencoderDataset`` and the GAN's raster crops
    (image, (crop, crop, 1)), ``coarse`` as ``CoarseDataset`` (image, (crop,
    crop, 6); cond_img, (crop, crop, 5); cond_inputs = 5 scalars
    log(tan(t) / 8)), and ``biome``, the perceptron's separable climate set
    of JAX's convergence test (image = a 4-vector, label = hot / cold x wet
    / dry)."""

    def __init__(self, kind, crop_size, seed, n_items=64, sigma_data=0.5):
        import numpy as np

        rng = np.random.default_rng(seed)
        self.kind, self.n = kind, n_items
        self.cond = self.cond_inputs = None
        if kind == "decoder":
            lat = rng.standard_normal((n_items, crop_size // 8, crop_size // 8, 4), np.float32)
            self.cond = np.repeat(np.repeat(lat, 8, axis=1), 8, axis=2)
            self.image = rng.standard_normal((n_items, crop_size, crop_size, 1),
                                             np.float32) * sigma_data
        elif kind == "latents":
            self.image = rng.standard_normal((n_items, crop_size, crop_size, 5),
                                             np.float32) * sigma_data
            self.cond_inputs = [rng.standard_normal((n_items, 58), np.float32)]
        elif kind == "autoencoder":
            self.image = rng.standard_normal((n_items, crop_size, crop_size, 1),
                                             np.float32) * sigma_data
        elif kind == "coarse":
            self.image = rng.standard_normal((n_items, crop_size, crop_size, 6),
                                             np.float32) * sigma_data
            self.cond = rng.standard_normal((n_items, crop_size, crop_size, 5), np.float32)
            t = np.arctan(np.exp(10 * rng.random((5, n_items)) - 5))
            self.cond_inputs = list(np.log(np.tan(t) / 8).astype(np.float32))
        else:  # biome
            self.image, self.label = biome_set(np, rng, n_items)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        i %= self.n  # the evaluation draws indices up to 2 ** 31
        if self.kind == "biome":
            return {"image": self.image[i], "label": self.label[i]}
        item = {"image": self.image[i], "path": f"memory/{i}",
                "cond_inputs": [c[i] for c in self.cond_inputs or ()]}
        if self.cond is not None:
            item["cond_img"] = self.cond[i]
        return item


def biome_set(np, rng, n):
    """Climate 4-vectors and 4 classes from two thresholds (hot / cold x
    wet / dry), linearly separable given the inputs."""
    temp = rng.uniform(-15, 35, n).astype(np.float32)
    precip = rng.uniform(0, 2000, n).astype(np.float32)
    t_std = rng.uniform(0, 400, n).astype(np.float32)
    p_cv = rng.uniform(0, 150, n).astype(np.float32)
    labels = (2 * (temp > 10) + (precip > 1000)).astype(np.int64)
    x = np.stack([temp / 20.0, precip / 1000.0, t_std / 200.0, p_cv / 75.0], axis=-1)
    return x, labels


MEMORY_KINDS = ("decoder", "latents", "autoencoder", "coarse", "biome")


def memory_dataset(kind, crop, **extra):
    """The ``train_dataset`` override of an in-memory dataset."""
    section = {"@dataset": "chip_smoke_" + kind, "crop_size": crop, "seed": SEED, **extra}
    return "train_dataset=" + json.dumps(section)


def register_memory_datasets():
    from terrain_diffusion_tpu_torch.training.registry import build_registry, dataset_registry

    build_registry()
    for kind in MEMORY_KINDS:
        dataset_registry.register(f"chip_smoke_{kind}")(
            lambda crop_size=0, seed=0, n_items=64, _k=kind: MemoryDataset(_k, crop_size, seed,
                                                                          n_items))


def unet_forward_flops(model, n, h, w) -> float:
    """FLOPs of one U-Net forward at (n, h, w): every 3x3 and 1x1 conv
    (2 x weights x output pixels) and the attention products; the embedding
    linears and elementwise work are left out."""
    scale = h / model.config.image_size
    total = 2 * model.out_conv.weight.numel() * n * h * w
    for plan, mods in ((model.enc_plan, model.enc), (model.dec_plan, model.dec)):
        for name, kind, *_ in plan:
            res = int(name.split("x")[0]) * scale
            mod = mods[name]
            convs = [mod.weight] if kind == "conv" else [p for p in mod.parameters()
                                                         if p.dim() == 4]
            total += sum(2 * wt.numel() * n * res * res for wt in convs)
            if kind != "conv" and mod.num_heads > 0:
                total += 4 * n * (res * res) ** 2 * mod.conv_res1.weight.shape[0]
    return total


def top_level_launches(model) -> dict:
    """Kernel launches of one forward at a crop of 128 x 128 pixels: only the
    top level's blocks (names of the image_size level) reach 128 x 128, plus
    the in conv and the head."""
    top = f"{model.config.image_size}x{model.config.image_size}_"
    n = sum(1 for name, kind, *_ in model.enc_plan + model.dec_plan
            if kind == "block" and name.startswith(top))
    return {"fused_block": n, "conv3x3": 2, "attention": 0}


def run_config(torch, cuda_lib, fb, attn, rel, save_dir, overrides, steps, label,
               finite=("loss", "grad_norm")):
    """``run_training`` on a shipped config (a path, or a config dict) with
    ``overrides``, log_every=1; returns (trainer, state, the metrics lines,
    launches, peak GiB), each line's ``finite`` metrics checked finite.  The
    peak is the run's own: the device memory allocated at its peak less what
    was allocated when it started (the earlier phases' models)."""
    from terrain_diffusion_tpu_torch.training.registry import apply_overrides, load_config
    from terrain_diffusion_tpu_torch.training.train import run_training

    config = copy.deepcopy(rel) if isinstance(rel, dict) else load_config(os.path.join(ROOT, rel))
    for section in UNUSED_SECTIONS:
        config.pop(section, None)
    apply_overrides(config, [f"logging.save_dir={json.dumps(save_dir)}", *overrides])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    trainer, state, counters = run_training(config, max_steps=steps, log_every=1,
                                            device="cuda")
    wall = time.perf_counter() - t0
    launches = {"fused_block": fb.fused_block.launches, "conv3x3": fb.conv3x3.launches,
                "attention": attn.fused_pixelnorm_attention.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 - held
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        lines = [ln for ln in map(json.loads, f) if "step_ms" in ln]
    check(counters["step"] == steps and len(lines) == steps,
          f"{label}: {counters['step']} steps, {len(lines)} metrics lines, not {steps}")
    for ln in lines:
        check(all(math.isfinite(ln[k]) for k in finite),
              f"{label}: step {ln['step']} " + ", ".join(f"{k} {ln[k]}" for k in finite))
    print(f"[train] {label}: run_training {steps} steps in {wall:.1f} s (model build, data and "
          f"checkpoint included); peak {peak:.2f} GiB above the {held:.2f} GiB allocated before",
          flush=True)
    return trainer, state, lines, launches, peak


def report_run(label, lines, launches, peak, batch, shape, step_flops, keys=("loss", "grad_norm"),
               card=""):
    steady = [ln["step_ms"] for ln in lines[2:]]
    ms = sum(steady) / len(steady)
    bound = step_flops / F32_FLOPS * 1e3
    steps = len(lines)
    per_step = {k: v / steps for k, v in launches.items()}

    def series(key, fmt):  # every step's value, or the first and last 3 of a long run
        vals = [format(ln[key], fmt) for ln in lines]
        return ", ".join(vals if len(vals) <= 10 else vals[:3] + ["..."] + vals[-3:])

    print(f"[train] {label}: {card + ': ' if card else ''}b{batch} {shape}: {ms:.1f} ms/step "
          f"over steps 3-{steps} (all steps {series('step_ms', '.1f')}), "
          f"{batch / ms * 1e3:.1f} images/s, peak {peak:.2f} GiB, "
          + ", ".join(f"{k} {series(k, '.4g')}" for k in keys)
          + f", {step_flops / 1e12:.2f} TFLOP/step, bound {bound:.1f} ms at 67 TFLOP/s "
          f"({bound / ms:.1%}), kernel launches/step {per_step}", flush=True)
    return dict(ms=ms, images_s=batch / ms * 1e3, peak_gib=peak, tflop=step_flops / 1e12,
                bound_ms=bound, launches=launches)


def lively(torch, model, seed):
    """Non-zero block gains and out gain (an init leaves them at 0, where a
    model's output is 0): the card-vs-CPU step then tests every weight."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("emb_gain"):
                p.copy_(torch.randn((), generator=g) * 0.5)
            elif name == "out_gain":
                p.fill_(1.0)
    return model


def card_vs_cpu_steps(torch, np, cuda_lib, fb, teacher, guide, devices=("cuda", "cpu")):
    """One diffusion step and one consistency step at batch 2, 128x128, on
    the card (the teacher and guide through the kernels) and on the CPU
    (plain versions), same weights, batch and draws: the loss, the JVP
    tangent F_theta_grad and the updated weights agree within TRAIN_TOL."""
    from terrain_diffusion_tpu_torch.training import diffusion_core as core

    g = torch.Generator().manual_seed(SEED + 6)
    batch = {"image": torch.randn((2, 128, 128, 1), generator=g) * 0.5,
             "cond_img": torch.randn((2, 128, 128, 4), generator=g)}
    lr = 1e-4
    dcfg = core.DiffusionLossConfig(sigma_data=0.5, P_mean=-0.6, P_std=1.3)
    ccfg = core.ConsistencyLossConfig(sigma_data=0.5, P_mean=-0.6, P_std=2.0,
                                      guidance_scale=1.265, warmup_steps=10000)
    d = core.draws(batch["image"], torch.Generator().manual_seed(SEED + 7))
    results = {}
    for dev in devices:
        on = lambda t: t.to(dev)  # noqa: E731
        b = {k: on(v) for k, v in batch.items()}
        dd = {k: on(v) if isinstance(v, torch.Tensor) else v for k, v in d.items()}
        t_dev, g_dev = copy.deepcopy(teacher).to(dev).eval(), copy.deepcopy(guide).to(dev).eval()
        out = {}
        for kind in ("diffusion", "consistency"):
            student = copy.deepcopy(teacher).to(dev).train()
            terms = {}
            if kind == "diffusion":
                loss_fn = lambda m, bb, _g: core.diffusion_loss(m, bb, dd, dcfg)  # noqa: E731
            else:
                def loss_fn(m, bb, _g):
                    loss, aux = core.consistency_loss(m, t_dev, bb, dd, ccfg, 0, guide_fn=g_dev,
                                                      return_terms=True)
                    terms.update(aux)
                    return loss, aux
            opt = core.make_optimizer(grad_clip=5.0)
            state = opt.init(core.trained_tensors(student))
            cuda_lib.reset_launch_counts()
            metrics = core.make_train_step(loss_fn, opt)(student, state, b, None, lr)
            out[kind] = dict(loss=metrics["loss"].cpu(), grad_norm=metrics["grad_norm"].cpu(),
                             weights={k: v.detach().cpu() for k, v in
                                      core.trained_tensors(student).items()},
                             f_grad=terms["F_theta_grad"].cpu() if terms else None,
                             launches=(fb.fused_block.launches, fb.conv3x3.launches))
        results[dev] = out
    for kind in ("diffusion", "consistency"):
        got, want = (results[d][kind] for d in devices)
        errs = {"loss": rel_err(got["loss"], want["loss"]),
                "grad_norm": rel_err(got["grad_norm"], want["grad_norm"]),
                "weights": max(rel_err(got["weights"][k], w) for k, w in want["weights"].items())}
        if got["f_grad"] is not None:
            errs["F_theta_grad"] = rel_err(got["f_grad"], want["f_grad"])
        print(f"[train] card vs CPU, one {kind} step b2 128x128: "
              + ", ".join(f"{k} rel_err={v:.3e}" for k, v in errs.items())
              + f"; card kernel launches (block, conv) {got['launches']}", flush=True)
        check(all(v < TRAIN_TOL for v in errs.values()),
              f"{kind} step card vs CPU: {errs} (bar {TRAIN_TOL})")
    t_want, g_want = top_level_launches(teacher), top_level_launches(guide)
    n_want = tuple(t_want[k] + g_want[k] for k in ("fused_block", "conv3x3"))
    card = results[devices[0]]
    check(card["diffusion"]["launches"] == (0, 0) and card["consistency"]["launches"] == n_want,
          f"card step launches {card['diffusion']['launches']} / "
          f"{card['consistency']['launches']}, expected (0, 0) / {n_want}")


def teacher_guide_ms(torch, teacher, guide, n=16):
    """Eager ms of one teacher and one guide forward at b``n`` 128x128 under
    no_grad, as a distillation step runs them: with the kernels, and with the
    plain path (the 128 x 128 cutover raised out of reach), in turns (kernels,
    plain, plain, kernels; the least of each)."""
    from terrain_diffusion_tpu_torch.nn import edm_unet, layers

    g = torch.Generator().manual_seed(SEED + 9)
    x = torch.randn((n, 128, 128, 5), generator=g).cuda()
    nl = torch.full((n,), 0.8, device="cuda")

    def forwards():
        with torch.no_grad():
            teacher(x, nl, None)
            guide(x, nl, None)

    cutover, turns = layers.FUSED_MIN_PIXELS, {"kernels": [], "plain": []}
    for mode in ("kernels", "plain", "plain", "kernels"):
        layers.FUSED_MIN_PIXELS = edm_unet.FUSED_MIN_PIXELS = (
            cutover if mode == "kernels" else 1 << 62)
        try:
            turns[mode].append(time_ms(forwards, iters=3))
        finally:
            layers.FUSED_MIN_PIXELS = edm_unet.FUSED_MIN_PIXELS = cutover
    return min(turns["kernels"]), min(turns["plain"]), turns


def training_phase(torch, np, cuda_lib, fb, attn, dev, work_dir, card):
    """The training path through ``run_training`` on the shipped configs,
    datasets in memory: the diffusion decoder (64-3, b32, 128x128, random
    init, 6 steps), its consistency distillation (b16, the diffusion run's
    saved model as teacher, a random 32-3 guide, 4 steps: the teacher and
    guide forwards launch the block and conv kernels, the student none),
    and the base model (192-3, b48, 64x64, dropout 0.1, 3 steps, no kernel);
    then one diffusion and one consistency step card vs CPU; then
    ``rest_of_training``.  Returns the kernel launches of every run (all
    float32) and a summary per run."""
    from terrain_diffusion_tpu_torch.nn import torch_compat
    from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig

    register_memory_datasets()
    summary = {}

    save = os.path.join(work_dir, "diffusion_decoder")
    trainer, _, lines, launches, peak = run_config(
        torch, cuda_lib, fb, attn, DECODER_CFG, save, [memory_dataset("decoder", 128)], 6,
        "diffusion decoder 64-3")
    teacher_path = os.path.join(save, "latest_checkpoint", "saved_model")
    fwd = unet_forward_flops(trainer.model, 32, 128, 128)
    summary["diffusion"] = report_run("diffusion decoder 64-3", lines, launches, peak, 32,
                                      "128x128", 3 * fwd)
    check(launches == {"fused_block": 0, "conv3x3": 0, "attention": 0},
          f"the diffusion run launched kernels: {launches}")
    del trainer

    guide = EDMUnet2D(EDMUnetConfig.from_dict(model_config(GUIDE_CFG)), device="cpu",
                      generator=torch.Generator().manual_seed(SEED + 5))
    lively(torch, guide, SEED + 5)
    guide_path = os.path.join(work_dir, "guide_32-3")
    torch_compat.save_model(guide, guide_path)
    save = os.path.join(work_dir, "consistency_decoder")
    trainer, _, lines, launches, peak = run_config(
        torch, cuda_lib, fb, attn, CONSISTENCY_CFG, save,
        [memory_dataset("decoder", 128), f"model.main_path={json.dumps(teacher_path)}",
         f"model.guide_path={json.dumps(guide_path)}"], 4, "consistency decoder 64-3")
    student_fwd = unet_forward_flops(trainer.model, 16, 128, 128)
    teacher_fwd = unet_forward_flops(trainer.teacher, 16, 128, 128)
    guide_fwd = unet_forward_flops(trainer.guide, 16, 128, 128)
    step_flops = teacher_fwd + guide_fwd + 4 * student_fwd
    summary["consistency"] = run = report_run("consistency decoder 64-3 (+ guide 32-3)", lines,
                                              launches, peak, 16, "128x128", step_flops)
    per_step = {k: a + b for (k, a), b in zip(top_level_launches(trainer.teacher).items(),
                                             top_level_launches(trainer.guide).values())}
    want = {k: v * len(lines) for k, v in per_step.items()}
    print(f"[train] consistency: launches {launches} = {len(lines)} steps x (teacher + guide "
          f"{per_step}); teacher + guide forwards {(teacher_fwd + guide_fwd) / 1e12:.2f} of "
          f"{step_flops / 1e12:.2f} TFLOP/step ({(teacher_fwd + guide_fwd) / step_flops:.1%})",
          flush=True)
    check(launches == want, f"consistency run launches {launches}, expected {want}")
    run["teacher_guide_share"] = (teacher_fwd + guide_fwd) / step_flops
    k_ms, p_ms, turns = teacher_guide_ms(torch, trainer.teacher, trainer.guide)
    print(f"[train] consistency: teacher + guide forwards b16 128x128: {k_ms:.1f} ms with the "
          f"kernels ({k_ms / run['ms']:.1%} of the {run['ms']:.1f} ms step), {p_ms:.1f} ms on "
          f"the plain path (turns: kernels {', '.join(f'{t:.1f}' for t in turns['kernels'])}; "
          f"plain {', '.join(f'{t:.1f}' for t in turns['plain'])})", flush=True)
    run.update(teacher_guide_ms=k_ms, teacher_guide_plain_ms=p_ms)
    teacher = lively(torch, copy.deepcopy(trainer.teacher).cpu(), SEED + 8)
    guide_cpu = copy.deepcopy(trainer.guide).cpu()
    del trainer

    save = os.path.join(work_dir, "diffusion_base")
    trainer, _, lines, launches, peak = run_config(
        torch, cuda_lib, fb, attn, BASE_CFG, save, [memory_dataset("latents", 64)], 3,
        "diffusion base 192-3")
    check(trainer.model.enc["512x512_block0"].dropout == 0.1, "the base run has no dropout")
    fwd = unet_forward_flops(trainer.model, 48, 64, 64)
    summary["base"] = report_run("diffusion base 192-3 (dropout 0.1)", lines, launches, peak,
                                 48, "64x64", 3 * fwd)
    check(launches == {"fused_block": 0, "conv3x3": 0, "attention": 0},
          f"the base run launched kernels: {launches}")
    del trainer
    torch.cuda.empty_cache()

    card_vs_cpu_steps(torch, np, cuda_lib, fb, teacher, guide_cpu)
    rest, by_dtype = rest_of_training(torch, np, cuda_lib, fb, attn, work_dir, card)
    summary.update(rest)
    launches = dict(want)
    for (kernel, _dt), n in by_dtype.items():  # all float32 (checked)
        launches[kernel] += n
    return launches, summary

# ---------------------------------------------------------------------------
# the rest of training: autoencoder, coarse diffusion, perceptron, GAN
# ---------------------------------------------------------------------------

AE_SQUARED_CFG = "configs/autoencoder/autoencoder_x8_squared.cfg"
COARSE_CFG = "configs/diffusion_coarse/diffusion_coarse.cfg"
AE_PEAK_LIMIT_GIB = 70.0  # autoencoder_x8.cfg's 512x512 run: the largest batch under this
AE_BATCHES = (16, 8, 4)   # the config's 16, then halved
AE_KEYS = ("loss", "grad_norm", "mae", "kl", "perceptual")
PERCEPTRON_CONFIG = {  # JAX's convergence test's perceptron, on its separable set
    "trainer": {"@trainer": "perceptron"},
    "logging": {"save_epochs": 0},
    "training": {"batch_size": 64, "seed": SEED},
    "model": {"@model": "perceptron", "in_dim": 4, "out_dim": 4, "hidden_dims": [32, 32]},
    "lr_sched": {"@lr_sched": "constant", "lr": 3e-3},
}
GAN_UNET = {"@model": "unet", "image_size": 144, "out_channels": 1, "model_channels": 64,
            "model_channel_mults": [1, 2, 2], "layers_per_block": 1, "attn_resolutions": [],
            "midblock_attention": False}
GAN_CONFIG = {  # inject mode, R1 every other step, 144x144 images cropped to 128x128
    "trainer": {"@trainer": "gan"},
    "logging": {"save_epochs": 0},
    "training": {"batch_size": 16, "seed": SEED, "latent_channels": 1, "crop_size": 128,
                 "mode": "inject", "r_gamma": 0.1, "r_interval": 2, "burnin_steps": 4,
                 "kl_weight": 0.01, "range_weight": 1.0, "lr_warmup_factor": 0.1},
    "g_optimizer": {"kwargs": {"betas": [0.0, 0.99]}},
    "d_optimizer": {"kwargs": {"betas": [0.0, 0.99]}},
    "model": {**GAN_UNET, "in_channels": 2},  # concat(noised real, z)
    "discriminator": {**GAN_UNET, "in_channels": 1},
    "lr_sched": {"@lr_sched": "constant", "lr": 1e-4},
}
GAN_KEYS = ("d_loss", "g_loss", "r_loss", "d_grad_norm", "g_grad_norm")


def read_launches(fb, attn) -> tuple:
    """The launch counts by kernel, and by (kernel, type)."""
    fns = {"fused_block": fb.fused_block, "conv3x3": fb.conv3x3,
           "attention": attn.fused_pixelnorm_attention}
    by_dtype = {(k, dt): n for k, f in fns.items() for dt, n in f.launches_by_dtype.items()}
    return {k: f.launches for k, f in fns.items()}, by_dtype


def forward_flops(torch, model, fn) -> float:
    """FLOPs of every conv and linear that ``fn`` runs through ``model`` (2 x
    weights x output pixels), counted by hooks on its MPConvs on the plain
    path (the cutover raised out of reach) under no_grad."""
    from terrain_diffusion_tpu_torch.nn import edm_unet, layers

    total = [0]

    def hook(mod, _args, out):
        total[0] += 2 * mod.weight.numel() * (out.numel() // out.shape[-1])

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, layers.MPConv)]
    cutover = layers.FUSED_MIN_PIXELS
    layers.FUSED_MIN_PIXELS = edm_unet.FUSED_MIN_PIXELS = 1 << 62
    try:
        with torch.no_grad():
            fn()
    finally:
        layers.FUSED_MIN_PIXELS = edm_unet.FUSED_MIN_PIXELS = cutover
        for h in hooks:
            h.remove()
    return float(total[0])


def vae_roundtrip_flops(torch, vae, size) -> float:
    x = torch.zeros((1, size, size, 1), device="cuda")
    return forward_flops(torch, vae, lambda: vae.decode(vae.preencode(x)[0]))


def check_float32(by_dtype, label):
    import torch

    check(all(dt == torch.float32 for (_k, dt), n in by_dtype.items() if n),
          f"{label}: a launch in another type than float32: {by_dtype}")


def autoencoder_card_vs_cpu(torch, np):
    """The first AutoencoderTrainer step of autoencoder_x8.cfg (full width,
    a constant lr of 1e-3 where the config warms up from 0) on the card and
    on the CPU, same init, batch (b2 at 64x64, small enough for the CPU) and
    generator: loss, its terms, grad_norm and the weights within TRAIN_TOL."""
    from terrain_diffusion_tpu_torch.nn.edm_autoencoder import EDMAutoencoderConfig
    from terrain_diffusion_tpu_torch.training import lr_sched as ls
    from terrain_diffusion_tpu_torch.training.registry import ModelSpec, load_config
    from terrain_diffusion_tpu_torch.training.trainers.autoencoder import AutoencoderTrainer

    config = load_config(os.path.join(ROOT, VAE_CFG))
    spec = ModelSpec(EDMAutoencoderConfig.from_dict(model_config(VAE_CFG)))
    rng = np.random.default_rng(SEED + 22)
    batch = {"image": rng.standard_normal((2, 64, 64, 1), np.float32) * 0.5}
    results = {}
    for dev in ("cuda", "cpu"):
        trainer = AutoencoderTrainer(config, {"model": spec,
                                              "lr_sched": ls.ConstantLRScheduler(1e-3)},
                                     device=dev)
        state = trainer.init_state(torch.Generator().manual_seed(SEED + 23))
        metrics = trainer.train_step(state, batch, torch.Generator().manual_seed(SEED + 24),
                                     {"step": 0, "seen": 0})
        results[dev] = metrics, {k: v.detach().cpu() for k, v in trainer.params().items()}
    (got, w_got), (want, w_want) = results["cuda"], results["cpu"]
    errs = {k: abs(got[k] - want[k]) / abs(want[k]) for k in AE_KEYS}
    errs["weights"] = max(rel_err(w_got[k], w) for k, w in w_want.items())
    print("[train] card vs CPU, the first autoencoder_x8 step b2 64x64: "
          + ", ".join(f"{k} rel_err={v:.3e}" for k, v in errs.items()), flush=True)
    check(all(v < TRAIN_TOL for v in errs.values()),
          f"autoencoder step card vs CPU: {errs} (bar {TRAIN_TOL})")


def autoencoder_x8_run(torch, np, cuda_lib, fb, attn, work_dir, card) -> tuple:
    """autoencoder_x8.cfg at its full width and crop 512: the batch from a
    one-step probe at b2 (the largest of 16 / 8 / 4 whose peak, at the
    probe's peak per image, stays under AE_PEAK_LIMIT_GIB), 5 steps (no
    kernel), then ``evaluate`` on two 512x512 b2 batches and ``save-model
    --sigma-rel 0.1`` with a VAE round trip of the saved model, each
    launching the blocks and in conv ``vae_launches`` predicts, in
    float32.  Returns the run's summary and the launches by (kernel, type)."""
    from terrain_diffusion_tpu_torch import __main__ as cli_main
    from terrain_diffusion_tpu_torch.nn import torch_compat

    *_, peak2 = run_config(torch, cuda_lib, fb, attn, VAE_CFG, os.path.join(work_dir, "ae_probe"),
                           [memory_dataset("autoencoder", 512), "training.batch_size=2"], 1,
                           "autoencoder_x8 probe b2 512x512", finite=AE_KEYS)
    held = torch.cuda.memory_allocated() / 2 ** 30
    per_image = peak2 / 2
    fits = [b for b in AE_BATCHES if held + b * per_image < AE_PEAK_LIMIT_GIB]
    check(bool(fits), f"autoencoder_x8: {per_image:.2f} GiB an image, no batch of {AE_BATCHES} "
                      f"under {AE_PEAK_LIMIT_GIB} GiB")
    batch, steps = fits[0], 5
    print(f"[train] autoencoder_x8: {card}: probe peak {peak2:.2f} GiB at b2 = {per_image:.2f} GiB "
          f"an image: the config's batch 16 would need about {16 * per_image:.1f} GiB; batch "
          f"{batch} (the largest of {AE_BATCHES} under {AE_PEAK_LIMIT_GIB} GiB with the "
          f"{held:.2f} GiB already allocated)", flush=True)
    torch.cuda.empty_cache()
    save = os.path.join(work_dir, "autoencoder_x8")
    trainer, state, lines, launches, peak = run_config(
        torch, cuda_lib, fb, attn, VAE_CFG, save,
        [memory_dataset("autoencoder", 512), f"training.batch_size={batch}",
         f"ema.checkpoint_every_num_steps={steps}"], steps, f"autoencoder_x8 b{batch}",
        finite=AE_KEYS)
    total = torch.cuda.max_memory_allocated() / 2 ** 30
    check(total < AE_PEAK_LIMIT_GIB, f"autoencoder_x8 b{batch}: peak {total:.2f} GiB")
    check(not any(launches.values()), f"the autoencoder training run launched {launches}")
    fwd = vae_roundtrip_flops(torch, trainer.model, 512)
    run = report_run(f"autoencoder_x8 (batch {batch} of 16)", lines, launches, peak, batch,
                     "512x512", 3 * fwd * batch, keys=AE_KEYS[:4], card=card)
    run.update(batch=batch, probe_gib_per_image=per_image)

    enc, dec = vae_launches(trainer.model)
    per_trip = {k: enc[k] + dec[k] for k in enc}
    rng = np.random.default_rng(SEED + 20)
    batches = [{"image": rng.standard_normal((2, 512, 512, 1), np.float32) * 0.5}
               for _ in range(2)]
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    out = trainer.evaluate(state, batches, torch.Generator().manual_seed(SEED + 21))
    torch.cuda.synchronize()
    n_eval, by_eval = read_launches(fb, attn)
    print(f"[train] autoencoder_x8 evaluate, 2 batches 512x512 b2: {json.dumps(out)} in "
          f"{time.perf_counter() - t0:.2f} s, launches {n_eval} (2 x {per_trip})", flush=True)
    check(all(math.isfinite(v) for v in out.values()) and set(out) >= {"val_loss", "val_mae"},
          f"autoencoder evaluate: {out}")
    check(n_eval == {k: 2 * v for k, v in per_trip.items()},
          f"autoencoder evaluate launched {n_eval}, expected 2 x {per_trip}")
    check_float32(by_eval, "autoencoder evaluate")
    del trainer, state

    ckpt = os.path.join(save, "latest_checkpoint")
    cli_main.cli(["save-model", ckpt, "--sigma-rel", "0.1"], standalone_mode=False)
    vae = torch_compat.load_model(os.path.join(ckpt, "saved_model_ema"), device="cuda")
    x = torch.from_numpy(batches[0]["image"]).cuda()
    cuda_lib.reset_launch_counts()
    with torch.no_grad():
        rec = vae.decode(vae.preencode(x)[0])
    torch.cuda.synchronize()
    n_trip, by_trip = read_launches(fb, attn)
    print(f"[train] save-model --sigma-rel 0.1, then the saved VAE's round trip 512x512 b2: "
          f"launches {n_trip}", flush=True)
    check(bool(torch.isfinite(rec).all()) and rec.shape == x.shape,
          "the saved VAE's reconstruction is non-finite or of the wrong shape")
    check(n_trip == per_trip, f"the saved VAE's round trip launched {n_trip}, expected {per_trip}")
    check_float32(by_trip, "the saved VAE's round trip")
    del vae
    torch.cuda.empty_cache()
    by_dtype = {k: by_eval.get(k, 0) + by_trip.get(k, 0) for k in set(by_eval) | set(by_trip)}
    return run, by_dtype


def gan_run(torch, np, cuda_lib, fb, attn, work_dir, card) -> tuple:
    """The GAN in inject mode with R1 (steps 0, 2, 4): 64-channel U-Net
    generator and discriminator, b16 144x144 cropped to 128x128, 5 steps;
    the discriminator phase's fakes (no_grad) launch the generator's
    top-level blocks and its in conv and head each step; then ``evaluate``
    (FID with the EMA weights, terrain features) on two b16 batches, which
    launches the same per batch.  Returns the summary and the launches of
    both by (kernel, type)."""
    steps = 5
    trainer, state, lines, launches, peak = run_config(
        torch, cuda_lib, fb, attn, GAN_CONFIG, os.path.join(work_dir, "gan"),
        [memory_dataset("autoencoder", 144)], steps, "gan inject + R1", finite=GAN_KEYS)
    _, by_train = read_launches(fb, attn)
    check_float32(by_train, "the GAN run")
    per_forward = top_level_launches(trainer.model)
    check(launches == {k: steps * v for k, v in per_forward.items()},
          f"the GAN run launched {launches}, expected {steps} x {per_forward}")
    check(lines[0]["r_loss"] > 0 or lines[2]["r_loss"] > 0, "the GAN run's R1 penalty is 0")
    g = trainer.model
    d = trainer.discriminator
    z144 = torch.zeros((1, 144, 144, 2), device="cuda")
    g_fwd = forward_flops(torch, g, lambda: g(z144, torch.zeros((1,), device="cuda"), []))
    d128 = forward_flops(torch, d, lambda: d(z144[:, :128, :128, :1],
                                             torch.zeros((1,), device="cuda"), []))
    d144 = forward_flops(torch, d, lambda: d(z144[..., :1], torch.zeros((1,), device="cuda"), []))
    b = 16  # a step without R1: fakes, D fwd + bwd on 2b crops, G fwd + bwd, D fwd + bwd on b
    step_flops = b * (g_fwd + 3 * 2 * d128 + 3 * g_fwd + 3 * d144)
    run = report_run("gan inject + R1 (64-ch generator and discriminator)", lines, launches, peak,
                     b, "144x144 (crops 128x128)", step_flops, keys=GAN_KEYS, card=card)
    r1 = [ln["step_ms"] for ln in lines[2:] if (ln["step"] - 1) % 2 == 0]
    plain = [ln["step_ms"] for ln in lines[2:] if (ln["step"] - 1) % 2 == 1]
    run.update(r1_ms=sum(r1) / len(r1), plain_ms=sum(plain) / len(plain))
    print(f"[train] gan: {card}: steps 3-{steps}: {run['r1_ms']:.1f} ms a step with R1, "
          f"{run['plain_ms']:.1f} ms without ({step_flops / F32_FLOPS * 1e3 / run['plain_ms']:.1%} "
          f"of the plain step's bound)", flush=True)
    rng = np.random.default_rng(SEED + 31)
    batches = [{"image": rng.standard_normal((b, 144, 144, 1), np.float32) * 0.5}
               for _ in range(2)]
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    out = trainer.evaluate(state, batches, torch.Generator().manual_seed(SEED + 32))
    torch.cuda.synchronize()
    n_fid, by_fid = read_launches(fb, attn)
    print(f"[train] gan evaluate (FID, EMA weights, terrain features), 2 batches 144x144 b16: "
          f"{json.dumps(out)} in {time.perf_counter() - t0:.2f} s, launches {n_fid}", flush=True)
    check(math.isfinite(out["val/fid"]), f"gan evaluate: {out}")
    check(n_fid == {k: 2 * v for k, v in per_forward.items()},
          f"gan evaluate launched {n_fid}, expected 2 x {per_forward}")
    check_float32(by_fid, "gan evaluate")
    return run, {k: by_train.get(k, 0) + by_fid.get(k, 0) for k in set(by_train) | set(by_fid)}


def rest_of_training(torch, np, cuda_lib, fb, attn, work_dir, card) -> tuple:
    """The trainers, datasets' layouts and models the earlier runs leave
    out: autoencoder_x8.cfg (full width, crop 512, its batch cut to fit),
    its first step card vs CPU, autoencoder_x8_squared.cfg (b64, crop 128),
    diffusion_coarse.cfg (b256, 16x16, 128 channels), the perceptron on a
    separable climate set, and the GAN.  Returns the summaries and the
    kernel launches by (kernel, type)."""
    summary = {}
    summary["autoencoder_x8"], by_dtype = autoencoder_x8_run(torch, np, cuda_lib, fb, attn,
                                                             work_dir, card)
    autoencoder_card_vs_cpu(torch, np)

    trainer, _, lines, launches, peak = run_config(
        torch, cuda_lib, fb, attn, AE_SQUARED_CFG, os.path.join(work_dir, "ae_squared"),
        [memory_dataset("autoencoder", 128)], 4, "autoencoder_x8_squared b64", finite=AE_KEYS)
    check(not any(launches.values()), f"the squared autoencoder run launched {launches}")
    fwd = vae_roundtrip_flops(torch, trainer.model, 128)
    summary["autoencoder_x8_squared"] = report_run(
        "autoencoder_x8_squared", lines, launches, peak, 64, "128x128", 3 * fwd * 64,
        keys=AE_KEYS[:4], card=card)
    del trainer
    torch.cuda.empty_cache()

    trainer, _, lines, launches, peak = run_config(
        torch, cuda_lib, fb, attn, COARSE_CFG, os.path.join(work_dir, "coarse"),
        [memory_dataset("coarse", 16, n_items=512)], 5, "diffusion_coarse b256")
    check(not any(launches.values()), f"the coarse run launched {launches}")
    m = trainer.model
    x = torch.zeros((1, 16, 16, 11), device="cuda")
    conds = [torch.zeros((1,), device="cuda")] * 5
    fwd = forward_flops(torch, m, lambda: m(x, torch.zeros((1,), device="cuda"), conds))
    summary["diffusion_coarse"] = report_run("diffusion_coarse", lines, launches, peak, 256,
                                             "16x16", 3 * fwd * 256, card=card)
    del trainer

    steps = 250  # as JAX's convergence test
    trainer, _, lines, launches, peak = run_config(
        torch, cuda_lib, fb, attn, PERCEPTRON_CONFIG, os.path.join(work_dir, "perceptron"),
        [memory_dataset("biome", 0, n_items=3584)], steps, "perceptron")
    x, y = biome_set(np, np.random.default_rng(SEED + 30), 512)
    with torch.no_grad():
        logits = trainer.model(torch.from_numpy(x).cuda())
    acc = float((logits.argmax(-1).cpu().numpy() == y).mean())
    fwd = sum(2 * p.numel() for n, p in trainer.model.named_parameters() if n.endswith("weight"))
    summary["perceptron"] = run = report_run("perceptron 4-32-32-4", lines, launches, peak, 64,
                                             "4-vectors", 3 * fwd * 64, card=card)
    run["held_out_acc"] = acc
    print(f"[train] perceptron: held-out accuracy {acc:.3f} after {steps} steps", flush=True)
    check(acc > 0.9, f"the perceptron's held-out accuracy is {acc:.3f}")

    summary["gan"], by_gan = gan_run(torch, np, cuda_lib, fb, attn, work_dir, card)
    for k, n in by_gan.items():
        by_dtype[k] = by_dtype.get(k, 0) + n
    torch.cuda.empty_cache()
    return summary, by_dtype


# ---------------------------------------------------------------------------
# evaluation phase
# ---------------------------------------------------------------------------

VAE_CFG = "configs/autoencoder/autoencoder_x8.cfg"
EVAL_TOL = 1e-4  # card vs CPU, max|diff| / max|ref|, float32 with TF32 off


class EvalLaunches:
    """Kernel launches of the evaluation path's card runs: ``run(fn)`` zeroes
    the counts, runs fn, reads the counts by kernel and type, and adds them
    to ``total`` (the JSON line's ``evaluation_launches``)."""

    def __init__(self, torch, cuda_lib, fb, attn):
        self.torch, self.cuda_lib = torch, cuda_lib
        self.fns = {"fused_block": fb.fused_block, "conv3x3": fb.conv3x3,
                    "attention": attn.fused_pixelnorm_attention}
        self.total = {}

    def run(self, fn):
        self.cuda_lib.reset_launch_counts()
        out = fn()
        self.torch.cuda.synchronize()
        counts = {k: f.launches for k, f in self.fns.items()}
        for k, f in self.fns.items():
            for dt, n in f.launches_by_dtype.items():
                self.total[(k, dt)] = self.total.get((k, dt), 0) + n
        return out, counts


def vae_launches(vae, size=None) -> tuple:
    """Kernel launches of one encode and one decode of ``size`` x ``size``
    images (the config's image size by default): the blocks whose output
    map has at least 128 x 128 pixels, the encoder's in conv and its 3x3 out
    conv where their maps have (the decoder's head stays an MPConv).  The
    plan names its levels at the config's image size: a larger image scales
    every level."""
    from terrain_diffusion_tpu_torch.nn.layers import FUSED_MIN_PIXELS

    cfg_size, levels = vae.config.image_size, len(vae.config.model_channel_mults)
    size = size or cfg_size

    def res(name):
        if name.startswith("mid"):
            r = cfg_size // 2 ** (levels - 1)
        elif name.startswith("up"):
            r = cfg_size // 2 ** int(name[2:])
        else:
            r = int(name.split("x")[0])
        return r * size // cfg_size

    n_enc = sum(1 for name, kind, *_ in vae.encoder.enc_plan
                if kind == "block" and res(name) ** 2 >= FUSED_MIN_PIXELS)
    n_dec = sum(1 for name, *_ in vae.decoder_plan if res(name) ** 2 >= FUSED_MIN_PIXELS)
    n_conv = sum(int(r * r >= FUSED_MIN_PIXELS) for r in (size, size // 2 ** (levels - 1)))
    return ({"fused_block": n_enc, "conv3x3": n_conv, "attention": 0},
            {"fused_block": n_dec, "conv3x3": 0, "attention": 0})


def vae_phase(torch, np, vae, dev, launches, card):
    """The VAE at autoencoder_x8.cfg's full width, 512x512 b2: encode on the
    card (kernels) and on the CPU (plain), decode the CPU's means on both;
    the launches per encode and decode; bf16 against float32, reported."""
    g = torch.Generator().manual_seed(SEED + 10)
    x = torch.randn((2, 512, 512, 1), generator=g)
    want_enc, want_dec = vae_launches(vae)
    cpu = copy.deepcopy(vae).cpu()
    xd = x.to(dev)
    with torch.no_grad():
        (means, logvars), n_enc = launches.run(lambda: vae.preencode(xd))
        t0 = time.perf_counter()
        cmeans, clogvars = cpu.preencode(x)
        rec, n_dec = launches.run(lambda: vae.decode(cmeans.to(dev)))
        crec = cpu.decode(cmeans)
        cpu_s = time.perf_counter() - t0
        zd = cmeans.to(dev)
        enc_ms = time_ms(lambda: vae.preencode(xd), iters=3)
        dec_ms = time_ms(lambda: vae.decode(zd), iters=3)
        bf = torch.bfloat16
        (m16, _), n16 = launches.run(lambda: vae.preencode(xd, compute_dtype=bf))
        rec16, n16d = launches.run(lambda: vae.decode(zd.to(bf)))
        enc16_ms = time_ms(lambda: vae.preencode(xd, compute_dtype=bf), iters=3)
        dec16_ms = time_ms(lambda: vae.decode(zd.to(bf)), iters=3)
    errs = {"means": rel_err(means.cpu(), cmeans), "logvars": rel_err(logvars.cpu(), clogvars),
            "reconstruction": rel_err(rec.cpu(), crec)}
    print(f"[eval vae] {card}: autoencoder_x8 512x512 b2 float32 card vs CPU "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (CPU {cpu_s:.1f} s); encode {enc_ms:.2f} ms, decode {dec_ms:.2f} ms; launches "
          f"per encode {n_enc}, per decode {n_dec}", flush=True)
    print(f"[eval vae] {card}: bf16 encode {enc16_ms:.2f} ms, decode {dec16_ms:.2f} ms; "
          f"rel RMSE against float32: means {rrmse(m16.float(), means):.3e}, reconstruction "
          f"{rrmse(rec16.float(), rec):.3e}; launches per encode {n16}, per decode {n16d}",
          flush=True)
    for k, v in errs.items():
        check(v < EVAL_TOL, f"VAE {k} on the card disagree with the CPU: {v:.3e}")
    check(bool(torch.isfinite(rec).all()) and rec.shape == (2, 512, 512, 1),
          "VAE reconstruction non-finite or of the wrong shape")
    check(n_enc == want_enc and n16 == want_enc,
          f"VAE encode launched {n_enc} / bf16 {n16}, expected {want_enc}")
    check(n_dec == want_dec and n16d == want_dec,
          f"VAE decode launched {n_dec} / bf16 {n16d}, expected {want_dec}")
    return {"encode_ms": enc_ms, "decode_ms": dec_ms, "encode_bf16_ms": enc16_ms,
            "decode_bf16_ms": dec16_ms}


def sampler_phase(torch, np, models, vae, dev, launches, card):
    """The tiled samplers on the card and on the CPU with one threefry key:
    the decoder's 1-step decode of a 96x96 latent canvas (four 512x512
    tiles), the base consistency sampler (attention kernel), the VAE round
    trip over a 768x768 canvas; then FID / KID between two VAE draws."""
    from terrain_diffusion_tpu_torch.evaluation import metrics, samplers
    from terrain_diffusion_tpu_torch.ops.noise_field import key_from_seed

    rng = np.random.default_rng(SEED)
    rng_lat = rng.standard_normal((1, 96, 96, 4)).astype(np.float32)
    rng_cond = rng.standard_normal((4, 58)).astype(np.float32)
    rng_img = rng.standard_normal((1, 768, 768, 1)).astype(np.float32)
    decoder, base = models[2], models[1]
    enc, dec = vae_launches(vae)
    runs = [
        ("decoder consistency 96x96 latents b1 (4 tiles)", decoder,
         lambda m: samplers.sample_decoder_consistency_tiled(
             m, rng_lat, key=key_from_seed(SEED % 2 ** 31)),
         {"fused_block": 4 * 26, "conv3x3": 4 * 2, "attention": 0}),
        ("base consistency 64x64 b4 (2 steps)", base,
         lambda m: samplers.sample_base_consistency(
             m, (4, 64, 64, 5), [rng_cond], key=key_from_seed(3), inter_t=1.1),
         {"fused_block": 0, "conv3x3": 0, "attention": 2}),
        ("VAE round trip 768x768 b1 (4 tiles)", vae,
         lambda m: samplers.sample_autoencoder_tiled(m, rng_img, key=key_from_seed(4)),
         {k: 4 * (enc[k] + dec[k]) for k in enc}),
    ]
    outs = {}
    for name, model, fn, want in runs:
        t0 = time.perf_counter()
        got, n = launches.run(lambda: fn(model))
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = fn(copy.deepcopy(model).cpu())
        cpu_s = time.perf_counter() - t0
        err = rel_err(got.cpu(), ref)
        print(f"[eval sampler] {card}: {name}: card {card_s * 1e3:.1f} ms, CPU {cpu_s:.1f} s, "
              f"card vs CPU {err:.3e}, launches {n}", flush=True)
        check(bool(torch.isfinite(got).all()) and err < EVAL_TOL,
              f"{name}: card vs CPU {err:.3e}")
        check(n == want, f"{name}: launches {n}, expected {want}")
        outs[name] = got
    other, _ = launches.run(lambda: samplers.sample_autoencoder_tiled(
        vae, rng_img, key=key_from_seed(5)))

    def patches(t):  # 144 64x64 heightmaps of a 768x768 canvas
        t = t.cpu().numpy()[0, :, :, 0]
        return t.reshape(12, 64, 12, 64).transpose(0, 2, 1, 3).reshape(144, 64, 64, 1)

    t0 = time.perf_counter()
    fid, kid_mean, kid_std = metrics.compute_fid_kid(patches(outs[runs[2][0]]), patches(other),
                                                     device=dev)
    print(f"[eval metrics] {card}: terrain-feature FID {fid:.4g}, KID {kid_mean:.4g} +- "
          f"{kid_std:.3g} between two VAE draws (144 patches each), "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
    check(all(math.isfinite(v) for v in (fid, kid_mean, kid_std)), "FID / KID not finite")


def latency_phase(torch, dev, world_dir, launches, card):
    """The latency CLI on the Minecraft phase's world (its default bf16,
    3 runs), then requests/s through the coalesced HTTP stack at 1 and 4
    clients."""
    from terrain_diffusion_tpu_torch.evaluation import latency
    from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline

    torch.cuda.reset_peak_memory_stats()  # the peak of this run, not of the phases before
    out, n = launches.run(lambda: latency.main.main(
        args=[world_dir, "--runs", "3", "--seed", str(SEED)], standalone_mode=False))
    print(f"[eval latency] {card}: {json.dumps(out)}; launches {n}", flush=True)
    mem = out["memory"]
    check(out["ttft"]["p50"] > 0 and out["ttst"]["p50"] > 0, "latency: a p50 is not positive")
    check(mem["available"] and mem["platform"] == "gpu" and mem["peak_bytes_in_use"] > 0,
          f"latency: memory statistics {mem}")
    world = WorldPipeline.from_pretrained(world_dir, seed=SEED, dtype="bf16",
                                          latents_batch_size=[1, 2, 4, 8, 16], device=dev)
    world.bind()
    http, n = launches.run(lambda: latency.run_http_benchmark(
        world, concurrency_levels=(1, 4), requests_per_client=2))
    world.close()
    print(f"[eval http] {card}: {json.dumps(http)}; launches {n}", flush=True)
    check(set(http["levels"]) == {"1", "4"} and all(
        lvl["requests"] == lvl["clients"] * 2 and lvl["requests_per_sec"] > 0
        for lvl in http["levels"].values()), f"http benchmark: {http['levels']}")
    return out, http


def kid_phase(torch, dev, world_dir, launches, card):
    """``DiffusionTrainer.evaluate_full`` on the base 192-3 config with KID:
    4 images at batch 2 from the in-memory latents set, decoded to terrain
    by the world's saved decoder (``kid_autoencoder_path``)."""
    from terrain_diffusion_tpu_torch.training.registry import (apply_overrides, load_config,
                                                               resolve)

    register_memory_datasets()
    config = load_config(os.path.join(ROOT, BASE_CFG))
    for section in UNUSED_SECTIONS:
        config.pop(section, None)
    section = {"@dataset": "chip_smoke_latents", "crop_size": 64, "seed": SEED}
    decoder_path = os.path.join(world_dir, "decoder_model")
    apply_overrides(config, [
        "train_dataset=" + json.dumps(section), "evaluation.kid_enabled=true",
        "evaluation.kid_n_images=4", "evaluation.kid_batch_size=2",
        "evaluation.validation_steps=4", f"evaluation.kid_autoencoder_path={json.dumps(decoder_path)}"])
    resolved = resolve(config)
    trainer = resolved["trainer"](config, resolved, device=dev)
    state = trainer.init_state(torch.Generator().manual_seed(SEED))
    val = MemoryDataset("latents", 64, SEED + 11)
    t0 = time.perf_counter()
    out, n = launches.run(lambda: trainer.evaluate_full(state, val,
                                                        torch.Generator().manual_seed(SEED)))
    print(f"[eval kid] {card}: evaluate_full (diffusion_192-3, 4 images b2, "
          f"{config['evaluation'].get('kid_scheduler_steps', 12)} DPM steps, decoded by "
          f"the 64-3 decoder): {json.dumps(out)} in {time.perf_counter() - t0:.1f} s, "
          f"launches {n}", flush=True)
    check(math.isfinite(out["val_loss"]) and math.isfinite(out["val_kid_mean"])
          and out["val_n_images"] == 4, f"evaluate_full: {out}")
    check(n["fused_block"] > 0 and n["conv3x3"] > 0, f"evaluate_full launched {n}")


def evaluation_phase(torch, np, cuda_lib, fb, attn, models, dev, world_dir, card) -> dict:
    """The evaluation path: the VAE, the tiled samplers and the metrics, the
    latency harness, in-training KID.  Returns the launches by (kernel, type)."""
    from terrain_diffusion_tpu_torch.nn.edm_autoencoder import (EDMAutoencoder,
                                                               EDMAutoencoderConfig)

    launches = EvalLaunches(torch, cuda_lib, fb, attn)
    vae = EDMAutoencoder(EDMAutoencoderConfig.from_dict(model_config(VAE_CFG)), device=dev,
                         generator=torch.Generator().manual_seed(SEED + 9)).eval()
    print(f"[eval] {card}: VAE {VAE_CFG}: {vae.count_parameters() / 1e6:.2f} M parameters",
          flush=True)
    vae_phase(torch, np, vae, dev, launches, card)
    sampler_phase(torch, np, models, vae, dev, launches, card)
    del vae
    torch.cuda.empty_cache()
    latency_phase(torch, dev, world_dir, launches, card)
    kid_phase(torch, dev, world_dir, launches, card)
    return launches.total


# ---------------------------------------------------------------------------
# surface phase
# ---------------------------------------------------------------------------

class Pipelines:
    """Records every WorldPipeline an entry point binds, so the phase can
    read its stage calls and drive it again after the command returns."""

    def __enter__(self):
        from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline

        self.cls, self.orig, self.made = WorldPipeline, WorldPipeline.bind, []

        def bind(pipe, *a, **k):
            self.made.append(pipe)
            return self.orig(pipe, *a, **k)

        WorldPipeline.bind = bind
        return self

    def __exit__(self, *exc):
        self.cls.bind = self.orig

    def one(self, label):
        worlds = {id(p): p for p in self.made}
        check(len(worlds) == 1, f"{label}: {len(worlds)} pipelines were bound, expected 1")
        return self.made[0]


class SurfacePath:
    """One path of the surface phase: zeroes the launch counts and the peak
    memory, runs, checks the launches against the model forwards of the
    pipeline ``world()`` names (``check_launches``) and keeps seconds,
    launches and peak GiB."""

    def __init__(self, torch, cuda_lib, fb, attn, report):
        self.torch, self.cuda_lib, self.fb, self.attn = torch, cuda_lib, fb, attn
        self.report = report
        self.by_dtype = {}

    def run(self, label, fn, dtype, world):
        torch = self.torch
        torch.cuda.reset_peak_memory_stats()
        self.cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = check_launches(torch, self.cuda_lib, self.fb, self.attn, world(), {},
                                  f"surface {label}", dtype=dtype)
        for k, f in (("fused_block", self.fb.fused_block), ("conv3x3", self.fb.conv3x3),
                     ("attention", self.attn.fused_pixelnorm_attention)):
            for dt, n in f.launches_by_dtype.items():
                self.by_dtype[(k, dt)] = self.by_dtype.get((k, dt), 0) + n
        self.report[label] = {"seconds": seconds, "launches": launches,
                              "dtype": str(dtype).replace("torch.", ""),
                              "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        return out


def surface_generate(path, cli, world_dir):
    """``generate``: one 2048x2048 residual slice in float32, direct caching."""
    import torch

    with Pipelines() as made:
        out = path.run("generate", lambda: cli.main(
            ["generate", world_dir, "--caching-strategy", "direct", "--coarse-window", "4",
             "--seed", str(SEED), "--log-mode", "info", "--device", "cuda"],
            standalone_mode=False), torch.float32, lambda: made.one("generate"))
    check(out["seed"] == SEED and out["decoder_windows"] > 0, f"generate returned {out}")
    path.report["generate"].update(out)
    print(f"[surface generate] {json.dumps(path.report['generate'])}", flush=True)


def surface_tiff_export(path, cli, np, world_dir, work_dir):
    """``tiff-export`` of a 4x4-cell conditioning set to a 1024x1024 int16
    GeoTIFF in bf16; the file read back, and the chunk against a fresh
    ``world.get`` on the same pipeline."""
    import torch

    from terrain_diffusion_tpu_torch.common.geotiff import Affine, read_geotiff, write_geotiff
    from terrain_diffusion_tpu_torch.serving import tiff_export

    tdir = os.path.join(work_dir, "conditioning")
    os.makedirs(tdir, exist_ok=True)
    rng = np.random.default_rng(SEED)
    transform = Affine.from_bounds(10.0, 45.0, 14.0, 49.0, 4, 4)
    means = {"heightmap.tif": (600.0, 900.0), "temperature.tif": (12.0, 6.0),
             "temperature_std.tif": (0.08, 0.02), "precipitation.tif": (800.0, 300.0),
             "precipitation_cv.tif": (30.0, 8.0)}
    for name, (mean, std) in means.items():
        write_geotiff(os.path.join(tdir, name),
                      (mean + std * rng.standard_normal((4, 4))).astype(np.float32), transform)
    out_tif = os.path.join(work_dir, "export.tif")
    with Pipelines() as made:
        canvas = path.run("tiff-export", lambda: cli.main(
            ["tiff-export", world_dir, tdir, out_tif, "--dtype", "bf16",
             "--seed", str(SEED), "--device", "cuda"], standalone_mode=False),
            torch.bfloat16, lambda: made.one("tiff-export"))
        world = made.one("tiff-export")
    arr, back_t, _ = read_geotiff(out_tif)
    check(arr.dtype == np.int16 and arr.shape == (1024, 1024) and np.array_equal(arr, canvas),
          f"tiff-export file: {arr.dtype} {arr.shape}")
    check(back_t == transform.scaled_pixels(tiff_export.PIXELS_PER_CELL),
          f"tiff-export transform {back_t} != {transform.scaled_pixels(256)}")
    # the same pipeline bound afresh (its imports and SNR stay): the chunk again
    world.bind()
    p0 = tiff_export.PADDING * tiff_export.PIXELS_PER_CELL
    fresh = world.get(p0, p0, p0 + 1024, p0 + 1024, with_climate=False)["elev"]
    fresh = np.clip(fresh, -32768, 32767).astype(np.int16)
    world.close()
    diff = int(np.abs(fresh.astype(np.int32) - canvas).max())
    print(f"[surface tiff-export] 1024x1024 int16, elev [{canvas.min()}, {canvas.max()}] m, "
          f"std {canvas.std():.1f}; max|file - fresh world.get| {diff} m", flush=True)
    check(diff <= 1 and canvas.std() > 0, f"tiff-export chunk differs from world.get by {diff} m")
    path.report["tiff-export"]["max_diff_m"] = diff


def surface_explore(path, cli, np, world_dir):
    """``explore --threaded`` on a free port: every route once, POST /api/seed
    last; detail_raw against ``world.get`` of the same region."""
    import torch

    from terrain_diffusion_tpu_torch.serving.explorer import server as explorer

    port = free_port()
    errors = []

    def serve():
        try:
            cli.main(["explore", world_dir, "--threaded", "--host", "127.0.0.1", "--port",
                      str(port), "--seed", str(SEED), "--log-mode", "info",
                      "--device", "cuda"], standalone_mode=False)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    def requests():
        thread = threading.Thread(target=serve, daemon=True)
        thread.start()
        deadline = time.perf_counter() + 300
        while True:
            check(not errors, f"explore failed: {errors[0]!r}" if errors else "")
            try:
                status, headers, body = http_get(port, "/api/status")
                break
            except OSError:
                check(time.perf_counter() < deadline, "the explorer did not start")
                time.sleep(0.2)
        answers = {"/api/status": (status, headers, body)}
        for route in ("/", "/api/coarse.png?channel=0", "/api/coarse_data.json",
                      "/api/coarse_stats", "/api/detail_raw?ci=0&cj=0&detail_size=512",
                      "/api/detail.png?ci=0&cj=0&detail_size=512&mode=relief",
                      "/api/detail.png?ci=0&cj=0&detail_size=512&mode=elevation"):
            t0 = time.perf_counter()
            answers[route] = http_get(port, route)
            print(f"[surface explore] GET {route}: {answers[route][0]}, "
                  f"{answers[route][1].get('Content-Type')}, {len(answers[route][2])} bytes, "
                  f"{(time.perf_counter() - t0) * 1000:.1f} ms", flush=True)
        return thread, answers

    thread, answers = path.run("explore", requests, torch.float32,
                               lambda: explorer._PIPELINE)
    world = explorer._PIPELINE
    mimes = {"/": "text/html", "/api/status": "application/json",
             "/api/coarse.png?channel=0": "image/png",
             "/api/coarse_data.json": "application/json",
             "/api/coarse_stats": "application/json",
             "/api/detail_raw?ci=0&cj=0&detail_size=512": "application/octet-stream",
             "/api/detail.png?ci=0&cj=0&detail_size=512&mode=relief": "image/png",
             "/api/detail.png?ci=0&cj=0&detail_size=512&mode=elevation": "image/png"}
    for route, mime in mimes.items():
        status, headers, body = answers[route]
        check(status == 200 and headers.get("Content-Type") == mime,
              f"explore {route}: {status} {headers.get('Content-Type')}")
        check(mime != "image/png" or body[:8] == b"\x89PNG\r\n\x1a\n", f"{route}: not a PNG")
    status = json.loads(answers["/api/status"][2])
    check(status["seed"] == str(SEED) and status["cell_px"] == 256, f"/api/status {status}")
    check(len(json.loads(answers["/api/coarse_data.json"][2])["channels"]["Elev"]) == 100,
          "coarse_data.json: not 100 rows")
    _, headers, body = answers["/api/detail_raw?ci=0&cj=0&detail_size=512"]
    h, w = int(headers["X-Height"]), int(headers["X-Width"])
    check((h, w) == (512, 512) and headers["X-Has-Temp"] == "1" and len(body) == h * w * 6,
          f"detail_raw: {h}x{w}, {len(body)} bytes")
    elev = np.frombuffer(body[:h * w * 2], "<i2").reshape(h, w)
    want = world.get(-256, -256, 256, 256)["elev"]
    want = np.clip(np.floor(want), -32768, 32767).astype(np.int16)
    check(np.array_equal(elev, want), "detail_raw elevation differs from world.get")
    with urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/api/seed", data=b'{"seed": "12345"}', method="POST",
            headers={"Content-Type": "application/json"}), timeout=300) as r:
        seed_answer = (r.status, json.loads(r.read()))
    check(seed_answer == (200, {"seed": "12345"}) and world.seed == 12345,
          f"POST /api/seed: {seed_answer}")
    print(f"[surface explore] detail_raw 512x512 equals world.get floored to int16; elev "
          f"[{elev.min()}, {elev.max()}] m; POST /api/seed -> {seed_answer[1]}", flush=True)
    explorer.app.server.shutdown()
    thread.join(timeout=60)
    world.close()


def surface_random_sampler(path, np, world_dir, work_dir):
    """``random_sampler``: 2 tiles of 512 in bf16 (its default type)."""
    import torch

    from terrain_diffusion_tpu_torch.serving import random_sampler

    out_dir = os.path.join(work_dir, "random_tiles")
    with Pipelines() as made:
        tiles = path.run("random_sampler", lambda: random_sampler.main.main(
            args=[world_dir, out_dir, "--n", "2", "--tile", "512", "--seed", str(SEED),
                  "--device", "cuda"], standalone_mode=False),
            torch.bfloat16, lambda: made.one("random_sampler"))
    sep = 200 * 256  # sample_random_tiles' default separation
    (a0, b0), (a1, b1) = tiles[0]["center"], tiles[1]["center"]
    check(len(tiles) == 2 and all(t["elev"].shape == (512, 512) and np.isfinite(t["elev"]).all()
                                  for t in tiles), "random_sampler: tiles not finite 512x512")
    check(max(abs(a0 - a1), abs(b0 - b1)) >= sep, f"random_sampler centres {a0, b0} {a1, b1}")
    check(len(os.listdir(out_dir)) == 2, "random_sampler wrote no PNGs")
    print(f"[surface random_sampler] centres {tiles[0]['center']} {tiles[1]['center']}, elev "
          + ", ".join(f"[{t['elev'].min():.0f}, {t['elev'].max():.0f}] m" for t in tiles),
          flush=True)


def surface_phase(torch, np, cuda_lib, fb, attn, world_dir, card) -> dict:
    """The rest of the serving surface through the command group, in
    process, on the Minecraft phase's world: generate, tiff-export, explore
    and random_sampler.  Returns the launches by (kernel, type)."""
    from terrain_diffusion_tpu_torch import __main__ as cli_main

    report = {}
    path = SurfacePath(torch, cuda_lib, fb, attn, report)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_surface_") as work_dir:
        surface_generate(path, cli_main.cli, world_dir)
        surface_tiff_export(path, cli_main.cli, np, world_dir, work_dir)
        surface_explore(path, cli_main.cli, np, world_dir)
        surface_random_sampler(path, np, world_dir, work_dir)
    print(json.dumps({"surface": {"card": card, "caching_strategy": "direct (no h5py on the card)",
                                  "paths": report}}), flush=True)
    return path.by_dtype


# ---------------------------------------------------------------------------
# export phase
# ---------------------------------------------------------------------------

# run in a fresh process that imports only torch and the port: load each
# exported program, run it and the eager model it came from on the same
# inputs, count the kernel launches of each, and time the decoder's
EXPORT_LOADER = r"""
import json, sys, time
import torch
from terrain_diffusion_tpu_torch import use_full_f32
from terrain_diffusion_tpu_torch.export.torch_export import UNetForward
from terrain_diffusion_tpu_torch.nn.torch_compat import load_model
from terrain_diffusion_tpu_torch.ops import attention as attn, cuda_lib, fused_block as fb

use_full_f32()
world_dir, out_dir, seed = sys.argv[1], sys.argv[2], int(sys.argv[3])
manifest = json.load(open(out_dir + "/manifest.json"))
dev = torch.device("cuda", 0)


def counts():
    return {"fused_block": fb.fused_block.launches, "conv3x3": fb.conv3x3.launches,
            "attention": attn.fused_pixelnorm_attention.launches}


def run(fn, args):
    cuda_lib.reset_launch_counts()
    with torch.no_grad():
        out = fn(*args)
    torch.cuda.synchronize()
    return out, counts()


def event_ms(fn, args, iters=5):
    with torch.no_grad():
        fn(*args)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / iters


report = {}
for name, entry in manifest.items():
    t0 = time.perf_counter()
    program = torch.export.load(out_dir + "/" + entry["path"]).module()
    load_s = time.perf_counter() - t0
    eager = UNetForward(load_model(world_dir + "/" + name, device=dev))
    g = torch.Generator().manual_seed(seed)
    args = [torch.randn(s, generator=g).to(dev) for s in entry["inputs"]]
    got, loaded = run(program, args)
    want, eager_counts = run(eager, args)
    row = {"load_s": load_s, "max_abs_diff": float((got - want).abs().max()),
           "bit_equal": bool(torch.equal(got, want)), "finite": bool(torch.isfinite(got).all()),
           "output_std": float(want.std()), "shape": list(got.shape),
           "launches_loaded": loaded, "launches_eager": eager_counts}
    if name == "decoder_model":
        row["loaded_ms"] = [event_ms(program, args) for _ in range(2)]
        row["eager_ms"] = [event_ms(eager, args) for _ in range(2)]
    report[name] = row
report["jax_modules"] = sorted(m for m in sys.modules
                               if m.split(".")[0] in ("jax", "jaxlib", "terrain_diffusion_tpu"))
print(json.dumps(report))
"""


def export_phase(torch, np, cuda_lib, fb, attn, world_dir, card) -> dict:
    """The export commands through the group on the Minecraft phase's world
    (the full-width coarse, base (attention_impl="pallas") and decoder
    U-Nets, live gains): ``export`` writes three torch.export programs (the
    decoder at 512x512), which a fresh process loads and runs against the
    eager models, counting their launches; ``onnx-export`` writes and
    verifies the three ONNX files on the numpy runtime against the card
    forward, and the decoder is exported again at 128x128, where its
    verifying forward on the card launches the block and conv kernels.
    Returns the loaded programs' launches by kernel."""
    from terrain_diffusion_tpu_torch import __main__ as cli_main
    from terrain_diffusion_tpu_torch.export import onnx_export
    from terrain_diffusion_tpu_torch.nn.torch_compat import load_model

    cli = cli_main.cli
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as work_dir:
        out_pt2, out_onnx = os.path.join(work_dir, "pt2"), os.path.join(work_dir, "onnx")
        t0 = time.perf_counter()
        # --no-verify: the fresh process below loads and checks every program
        manifest = cli.main(["export", world_dir, out_pt2, "--device", "cuda", "--no-verify"],
                            standalone_mode=False)
        export_s = time.perf_counter() - t0
        for name, entry in manifest.items():
            print(f"[export] {name}: {entry['bytes']} bytes, traced and saved in "
                  f"{entry['export_s']:.1f} s, inputs {entry['inputs']}", flush=True)
        check(sorted(manifest) == ["base_model", "coarse_model", "decoder_model"],
              f"export wrote {sorted(manifest)}")
        check(manifest["decoder_model"]["inputs"][0] == [1, 512, 512, 5],
              "the decoder program is not at 512x512")
        print(f"[export] export through the group: {export_s:.1f} s", flush=True)

        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.run([sys.executable, "-c", EXPORT_LOADER, world_dir, out_pt2,
                               str(SEED + 14)], capture_output=True, text=True, timeout=600,
                              env=env, cwd=ROOT)
        loader_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"the fresh process failed to run the programs:\n"
                                    f"{proc.stderr[-3000:]}")
        loaded = json.loads(proc.stdout.strip().splitlines()[-1])
        check(loaded.pop("jax_modules") == [], "the fresh process imported JAX")
        for name, row in loaded.items():
            print(f"[export] {name} loaded in a fresh process in {row['load_s']:.1f} s: "
                  f"output {row['shape']}, std {row['output_std']:.4f}, vs eager "
                  f"max|diff|={row['max_abs_diff']:.3e} (bit equal: {row['bit_equal']}), "
                  f"launches loaded {row['launches_loaded']}, eager {row['launches_eager']}",
                  flush=True)
            check(row["finite"] and row["output_std"] > 0, f"{name}: a vacuous output")
            # the same operators run on the same inputs: equal bit for bit
            check(row["bit_equal"], f"{name}: the loaded program differs from eager by "
                                    f"{row['max_abs_diff']:.3e}")
            check(row["launches_loaded"] == row["launches_eager"],
                  f"{name}: the program launched {row['launches_loaded']}, eager "
                  f"{row['launches_eager']}")
        dec = loaded["decoder_model"]
        check(dec["launches_loaded"] == {"fused_block": 26, "conv3x3": 2, "attention": 0},
              f"the loaded decoder launched {dec['launches_loaded']}, not 26 + 2")
        check(loaded["base_model"]["launches_loaded"]["attention"] == 1,
              f"the loaded base launched {loaded['base_model']['launches_loaded']}")
        print(f"[export] decoder 512x512 b1 forward: loaded program "
              f"{min(dec['loaded_ms']):.2f} ms, eager {min(dec['eager_ms']):.2f} ms "
              f"(turns {dec['loaded_ms']} / {dec['eager_ms']}; CUDA events, 5 calls); "
              f"the fresh process took {loader_s:.1f} s ({card})", flush=True)

        t0 = time.perf_counter()
        onnx = cli.main(["onnx-export", world_dir, "-o", out_onnx, "--device", "cuda"],
                        standalone_mode=False)
        onnx_s = time.perf_counter() - t0
        decoder = load_model(os.path.join(world_dir, "decoder_model"), device="cuda")
        cuda_lib.reset_launch_counts()
        t1 = time.perf_counter()
        onnx["decoder_model@128"] = onnx_export.export_unet(
            decoder, os.path.join(out_onnx, "decoder_128.onnx"), image_size=128)
        onnx_128_s = time.perf_counter() - t1
        launches_128 = {"fused_block": fb.fused_block.launches, "conv3x3": fb.conv3x3.launches}
        for name, entry in onnx.items():
            print(f"[onnx] {name}: {entry['bytes']} bytes, verified at "
                  f"{entry['verified_at']}x{entry['verified_at']} b2 against the card forward: "
                  f"max|diff|={entry['max_abs_diff']:.3e}, output_std {entry['output_std']:.4f}, "
                  f"numpy runtime {entry['runtime_s']:.1f} s", flush=True)
            check(entry["verified"] is True, f"ONNX export of {name} is not verified: {entry}")
        print(f"[onnx] decoder at 128x128: its verifying forward launched {launches_128}; "
              f"onnx-export through the group {onnx_s:.1f} s, the 128x128 export "
              f"{onnx_128_s:.1f} s", flush=True)
        check(launches_128["fused_block"] > 0 and launches_128["conv3x3"] == 2,
              f"the decoder's verifying forward at 128x128 launched {launches_128}")
    summary = {"card": card, "export_s": export_s, "fresh_process_s": loader_s,
               "onnx_export_s": onnx_s, "onnx_128_s": onnx_128_s,
               "programs": {n: {"bytes": manifest[n]["bytes"], "export_s": manifest[n]["export_s"],
                                "load_s": loaded[n]["load_s"],
                                "launches": loaded[n]["launches_loaded"]} for n in manifest},
               "decoder_loaded_ms": min(dec["loaded_ms"]), "decoder_eager_ms": min(dec["eager_ms"]),
               "onnx": {n: {k: e[k] for k in ("bytes", "verified_at", "max_abs_diff",
                                              "output_std", "runtime_s")}
                        for n, e in onnx.items()},
               "onnx_128_launches": launches_128}
    print(json.dumps({"export": summary}), flush=True)
    return {k: v for k, v in dec["launches_loaded"].items()}


# ---------------------------------------------------------------------------
# data-preparation phase
# ---------------------------------------------------------------------------

PREP = dict(highres_size=4096, lowres_size=512, num_chunks=4)  # the builders' defaults
PREP_SIGMA = 5.0
PREP_TOL = 1e-5  # card vs CPU, max|diff| / max|ref|: the cell's Laplacian bands, beauty scores
PREP_CELL = 1234  # a cell of the default 368.64 km grid
TEN_MINUTES = (1080, 2160)  # the global 10 arc-minute grid of ETOPO and WorldClim


def smooth_field(np, rng, shape, scale, offset=0.0, waves=8, noise=0.0):
    """A seeded field: random plane waves, plus white noise of ``noise`` x scale."""
    yy = np.linspace(0.0, 1.0, shape[0])[:, None]
    xx = np.linspace(0.0, 1.0, shape[1])[None, :]
    out = np.zeros(shape, np.float32)
    for _ in range(waves):
        fy, fx = rng.uniform(0.5, 6.0, 2)
        out += np.sin(2 * np.pi * fy * yy + rng.uniform(0, 2 * np.pi)).astype(np.float32) \
            * np.cos(2 * np.pi * fx * xx + rng.uniform(0, 2 * np.pi)).astype(np.float32)
    out *= scale / np.sqrt(waves)
    if noise:
        out += (noise * scale) * rng.standard_normal(shape, dtype=np.float32)
    return out + np.float32(offset)


def write_prep_rasters(np, root):
    """Seeded GeoTIFFs: an ETOPO-like global 10' raster, one 4096x4096 MERIT-like
    DEM cell (land, a stretch of sea floor, a void of -9999), and the five
    synthetic-map rasters at 10' (ETOPO and four WorldClim bio layers, nodata
    where WorldClim has none)."""
    from terrain_diffusion_tpu_torch.common.geotiff import Affine, write_geotiff
    from terrain_diffusion_tpu_torch.pipeline.synthetic_map import RASTER_FILES

    rng = np.random.default_rng(SEED + 20)
    world = Affine.from_bounds(-180.0, -90.0, 180.0, 90.0, TEN_MINUTES[1], TEN_MINUTES[0])
    etopo = smooth_field(np, rng, TEN_MINUTES, 2500.0, -800.0)
    etopo_path = os.path.join(root, "etopo_10m.tif")
    write_geotiff(etopo_path, etopo, world, compress=None)
    dem_dir = os.path.join(root, "dem")
    os.makedirs(dem_dir)
    dem = smooth_field(np, rng, (PREP["highres_size"],) * 2, 700.0, 500.0, noise=0.05)
    dem[3000:3600, 200:1400] = -9999.0  # a void, filled from the low-res context
    write_geotiff(os.path.join(dem_dir, f"dem_{PREP_CELL}.tif"), dem, compress=None)
    stats_dir = os.path.join(root, "global")
    os.makedirs(stats_dir)
    layers = {"elev": etopo, "temp": smooth_field(np, rng, TEN_MINUTES, 12.0, 12.0),
              "temp_std": smooth_field(np, rng, TEN_MINUTES, 300.0, 800.0),
              "precip": np.abs(smooth_field(np, rng, TEN_MINUTES, 900.0, 700.0)),
              "precip_cv": np.abs(smooth_field(np, rng, TEN_MINUTES, 30.0, 60.0))}
    for name, arr in layers.items():
        if name != "elev":
            arr = arr.copy()
            arr[:90] = -3.4e38  # WorldClim's nodata over the Arctic ocean
        write_geotiff(os.path.join(stats_dir, RASTER_FILES[name]), arr, world,
                      nodata=None if name == "elev" else -3.4e38, compress=None)
    return etopo_path, dem_dir, stats_dir


def prep_cell(torch, np, etopo_path, dem_dir, report, card):
    """``process_single_cell`` of one 4096x4096 cell at the defaults on the card,
    against the same call on the CPU; the Laplacian encode's device time."""
    from terrain_diffusion_tpu_torch.data.preprocessing import elevation
    from terrain_diffusion_tpu_torch.data.world_grid import create_equal_area_grid
    from terrain_diffusion_tpu_torch.ops.laplacian import laplacian_encode

    bounds = create_equal_area_grid((368640.0, 368640.0))[PREP_CELL]
    args = (str(PREP_CELL), bounds, dem_dir, etopo_path, PREP["highres_size"],
            PREP["lowres_size"], PREP_SIGMA)
    secs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out = elevation.process_single_cell(*args, num_chunks=PREP["num_chunks"], device=dev)
        secs[dev] = time.perf_counter() - t0
        if dev == "cuda":
            card_out = out
    cpu_out = out
    errs = {k: max(rel_err(torch.from_numpy(g[k]).double(), torch.from_numpy(w[k]).double())
                   for g, w in zip(card_out, cpu_out)) for k in ("residual", "lowfreq")}
    same = all(np.array_equal(g["lowres_exact"], w["lowres_exact"]) and g["pct_land"] == w["pct_land"]
               and g["subchunk_id"] == w["subchunk_id"] for g, w in zip(card_out, cpu_out))
    x = torch.randn((1, PREP["highres_size"], PREP["highres_size"]), device="cuda")
    with torch.no_grad():
        enc_ms = time_ms(lambda: laplacian_encode(x, PREP["lowres_size"], PREP_SIGMA), iters=5)
    report["process_single_cell"] = {
        "seconds_card": secs["cuda"], "seconds_cpu": secs["cpu"],
        "laplacian_encode_device_ms": enc_ms, "rel_err": errs,
        "subchunks": len(card_out), "pct_land": [c["pct_land"] for c in card_out]}
    print(f"[prep cell] {card}: process_single_cell 4096x4096 -> 16 subchunks of 1024: "
          f"{secs['cuda']:.2f} s (Laplacian encode on the card), {secs['cpu']:.2f} s with "
          f"device=cpu; encode of 1x4096x4096 {enc_ms:.3f} ms on the card; card vs CPU "
          f"residual {errs['residual']:.3e}, lowfreq {errs['lowfreq']:.3e}", flush=True)
    check(len(card_out) == 16 and same, "process_single_cell: card and CPU subchunks differ in "
                                        "ids, lowres_exact or pct_land")
    for k, v in errs.items():
        check(v < PREP_TOL, f"process_single_cell {k}: card vs CPU {v:.3e} >= {PREP_TOL}")
    check(all(np.isfinite(c["residual"]).all() for c in card_out), "non-finite residual")
    return card_out


def prep_encode(torch, np, cuda_lib, fb, attn, residual, work_dir, report, card) -> dict:
    """``encode_residual`` of one 1024x1024 subchunk (b8 through D4) with
    autoencoder_x8.cfg at full width (seeded random weights, saved and loaded
    through ``load_model``), through the kernels and on the plain path on the
    card; launches held to ``vae_launches`` at 1024.  Returns the launches by
    (kernel, type)."""
    from terrain_diffusion_tpu_torch.data.preprocessing.build_encoded_dataset import (
        encode_residual)
    from terrain_diffusion_tpu_torch.nn import edm_unet, layers, torch_compat
    from terrain_diffusion_tpu_torch.nn.edm_autoencoder import (EDMAutoencoder,
                                                               EDMAutoencoderConfig)

    vae_dir = os.path.join(work_dir, "vae")
    torch_compat.save_model(EDMAutoencoder(
        EDMAutoencoderConfig.from_dict(model_config(VAE_CFG)), device="cpu",
        generator=torch.Generator().manual_seed(SEED + 21)), vae_dir)
    ae = torch_compat.load_model(vae_dir, device="cuda")
    size = residual.shape[0]
    want, _ = vae_launches(ae, size)
    kw = dict(sigma_data=0.5, residual_mean=0.0, residual_std=1.1678)

    def encode():
        t0 = time.perf_counter()
        out = encode_residual(ae, residual, **kw)
        return out, (time.perf_counter() - t0) * 1e3

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cuda_lib.reset_launch_counts()
    enc, _ = encode()
    launches, by_dtype = read_launches(fb, attn)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    cutover = layers.FUSED_MIN_PIXELS

    def plain_path(on: bool):  # the cutover out of reach: every block and conv plain
        layers.FUSED_MIN_PIXELS = edm_unet.FUSED_MIN_PIXELS = (1 << 62) if on else cutover

    turns, device_ms = {"kernels": [], "plain": []}, {}
    stack = torch.from_numpy(np.stack([residual] * 8)[..., None]).cuda()
    try:
        plain_path(True)
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launch_counts()
        enc_plain, _ = encode()
        plain_launches, _ = read_launches(fb, attn)
        plain_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        for path in ("kernels", "plain", "plain", "kernels"):
            plain_path(path == "plain")
            turns[path].append(encode()[1])
        with torch.no_grad():
            for path in ("kernels", "plain"):
                plain_path(path == "plain")
                device_ms[path] = time_ms(lambda: ae.preencode(stack), iters=3)
    finally:
        plain_path(False)
    err = rel_err(torch.from_numpy(enc).double(), torch.from_numpy(enc_plain).double())
    lat = size // 2 ** (len(ae.config.model_channel_mults) - 1)
    report["encode_residual"] = {
        "shape": list(enc.shape), "launches": launches, "predicted": want,
        "ms_kernels": min(turns["kernels"]), "ms_plain": min(turns["plain"]),
        "turns_ms": turns, "preencode_ms": device_ms, "rel_err_vs_plain": err,
        "peak_gib_kernels": peak, "peak_gib_plain": plain_peak}
    print(f"[prep encode] {card}: encode_residual 1024x1024 -> 8 x 1024x1024x1 autoencoder_x8 "
          f"float32: kernels {min(turns['kernels']):.1f} ms, plain {min(turns['plain']):.1f} ms "
          f"(host clock, D4 stack and copies included; turns {json.dumps(turns)}); preencode "
          f"alone (CUDA events) kernels {device_ms['kernels']:.1f} ms, plain "
          f"{device_ms['plain']:.1f} ms; rel err vs plain {err:.3e}; launches {launches} "
          f"(predicted {want}; plain path {plain_launches}); peak above the model "
          f"{peak:.2f} GiB kernels, {plain_peak:.2f} GiB plain", flush=True)
    check(enc.shape == (8, 2 * ae.config.latent_channels, lat, lat) and enc.dtype == np.float32
          and np.isfinite(enc).all(), f"encode_residual: {enc.shape} {enc.dtype}, or non-finite")
    check(launches == want, f"encode_residual launched {launches}, predicted {want}")
    check_float32(by_dtype, "prep encode")
    check(not any(plain_launches.values()), f"the plain encode launched {plain_launches}")
    check(err < EVAL_TOL, f"encode_residual kernels vs plain: {err:.3e} >= {EVAL_TOL}")
    return by_dtype


def prep_beauty(torch, np, cell, report, card):
    """``calculate_beauty_score`` of the cell's 16 subchunks, card against CPU."""
    from terrain_diffusion_tpu_torch.data.preprocessing.beauty_score import (
        calculate_beauty_score)

    scores = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        scores[dev] = [calculate_beauty_score(c["lowfreq"], c["residual"], device=dev)
                       for c in cell]
        scores[dev + "_ms"] = (time.perf_counter() - t0) * 1e3 / len(cell)
    diff = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(scores["cuda"], scores["cpu"]))
    report["beauty_score"] = {"ms_per_subchunk_card": scores["cuda_ms"],
                              "ms_per_subchunk_cpu": scores["cpu_ms"], "rel_err": diff,
                              "scores": scores["cuda"]}
    print(f"[prep beauty] {card}: calculate_beauty_score per 1024x1024 subchunk "
          f"{scores['cuda_ms']:.1f} ms (decode on the card), {scores['cpu_ms']:.1f} ms with "
          f"device=cpu; scores {['%.4f' % v for v in scores['cuda']]}; card vs CPU {diff:.3e}",
          flush=True)
    check(all(np.isfinite(scores["cuda"])), "non-finite beauty score")
    check(diff < PREP_TOL, f"beauty score card vs CPU {diff:.3e} >= {PREP_TOL}")


def prep_synthetic_stats(torch, np, cli, stats_dir, world_dir, work_dir, report, card):
    """``build-synthetic-stats`` through the command group on 10' rasters,
    then a WorldPipeline (from the working directory that holds the cache)
    whose conditioning comes from it."""
    from terrain_diffusion_tpu_torch.pipeline import synthetic_map
    from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline

    cwd = os.getcwd()
    os.chdir(work_dir)
    try:
        t0 = time.perf_counter()
        stats = cli.main(["build-synthetic-stats", "--data-dir", stats_dir],
                         standalone_mode=False)
        secs = time.perf_counter() - t0
        cache = synthetic_map.load_stats_cache(expect_params={
            "drop_water_pct": 0.5, "frequency_mult": [1.5, 3.0, 3.0, 3.0, 3.0]})
        world = WorldPipeline.from_pretrained(world_dir, seed=SEED, device="cuda",
                                              log_mode="info")
        world.bind()
        kw = dict(seed=SEED, frequency_mult=world.kwargs["frequency_mult"],
                  drop_water_pct=world.kwargs["drop_water_pct"])
        box = (-40, 24, 24, 88)
        got = world.synthetic_map_factory(*box)
        want = synthetic_map.make_synthetic_map_factory(**kw, stats=cache)(*box)
        built_in = synthetic_map.make_synthetic_map_factory(
            **kw, stats_path=os.path.join(work_dir, "absent.json"))(*box)
        t0 = time.perf_counter()
        elev = world.get(0, 0, 256, 256)["elev"]
        get_s = time.perf_counter() - t0
        world.close()
    finally:
        os.chdir(cwd)
    report["build_synthetic_stats"] = {"seconds": secs, "world_get_256_s": get_s,
                                       "a_temp_std": stats["a_temp_std"]}
    print(f"[prep stats] {card}: build-synthetic-stats on 5 rasters of {TEN_MINUTES} in "
          f"{secs:.2f} s; a WorldPipeline in its directory takes the cache (map equal: "
          f"{np.array_equal(got, want)}, differs from the built-in tables: "
          f"{not np.array_equal(got, built_in)}); a 256x256 get {get_s:.2f} s, elev "
          f"[{elev.min():.0f}, {elev.max():.0f}] m", flush=True)
    check(cache is not None and np.array_equal(
        cache["base_image_quantiles_0"], stats["base_image_quantiles_0"]),
        "build-synthetic-stats wrote no readable cache")
    check(np.array_equal(got, want) and not np.array_equal(got, built_in),
          "the WorldPipeline's conditioning did not come from the stats cache")
    check(elev.shape == (256, 256) and np.isfinite(elev).all(), "world.get with the cache")


def data_prep_phase(torch, np, cuda_lib, fb, attn, world_dir, card) -> dict:
    """Data preparation at the JAX defaults on seeded synthetic rasters:
    one cell, the encode of one of its subchunks, the beauty scores, the
    synthetic-map stats; returns the encode's launches by (kernel, type)."""
    from terrain_diffusion_tpu_torch import __main__ as cli_main

    report = {"card": card}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_prep_") as work_dir:
        t0 = time.perf_counter()
        etopo_path, dem_dir, stats_dir = write_prep_rasters(np, work_dir)
        report["rasters_s"] = time.perf_counter() - t0
        cell = prep_cell(torch, np, etopo_path, dem_dir, report, card)
        land = max(range(len(cell)), key=lambda i: cell[i]["pct_land"])
        launches = prep_encode(torch, np, cuda_lib, fb, attn, cell[land]["residual"], work_dir,
                               report, card)
        prep_beauty(torch, np, cell, report, card)
        prep_synthetic_stats(torch, np, cli_main.cli, stats_dir, world_dir, work_dir, report,
                             card)
    print(json.dumps({"data_prep": report}), flush=True)
    return launches


# ---------------------------------------------------------------------------
# tools phase
# ---------------------------------------------------------------------------

TOOLS_TOL = 1e-4  # card vs CPU, max|diff| / max|ref|: a tool's panels, the SDE sample
PERLIN_CFG = (0.05, 4, 2.0, 0.5)  # the synthetic map's first channel: (freq, octaves, lac, gain)
TOOLS_SIGMAS = 5  # noise-loss-curve points


def tool_config(work_dir: str, kind: str, crop: int, n_items: int) -> str:
    """A registry config whose ``val_dataset`` is an in-memory dataset (the
    card has no h5py for the HDF5 sections the tools usually read)."""
    path = os.path.join(work_dir, f"{kind}_{crop}.cfg")
    with open(path, "w") as f:
        f.write(f"[val_dataset]\n@dataset=chip_smoke_{kind}\ncrop_size={crop}\n"
                f"seed={SEED + 30}\nn_items={n_items}\n")
    return path


def pages_finite(np, label, pages):
    check(len(pages) > 0 and all(p.panels for p in pages), f"{label}: no panels")
    for p in pages:
        for kind, name, data, *_ in p.panels:
            arrays = [data] if kind == "image" else list(data[:2])
            check(all(np.isfinite(np.asarray(a, np.float64)).all() for a in arrays),
                  f"{label}: panel {name!r} is not finite")


def tools_native(np, report, card):
    """The native host library, built at the start of the run: loaded, and
    its Perlin FBm and portable normals equal to the numpy paths bit for
    bit on a 256x256 grid and 1M draws, with both host times."""
    from terrain_diffusion_tpu_torch import native
    from terrain_diffusion_tpu_torch.ops import perlin, rng_portable

    check(native.get_native() is not None, "the native library is not loaded")
    ys, xs = np.mgrid[0:256, 0:256].astype(np.float32)
    out = {}
    for name, fn in (("native", perlin.perlin_fbm), ("numpy", perlin.perlin_fbm_np)):
        t0 = time.perf_counter()
        out[name] = fn(SEED, *PERLIN_CFG, xs, ys)
        out[name + "_ms"] = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(out["native"], out["numpy"]) and out["native"].std() > 0,
          "native Perlin FBm differs from the numpy path")
    draws = {}
    for name, fn in (("native", rng_portable.fill_standard_normal),
                     ("numpy", rng_portable.fill_standard_normal_np)):
        draws[name] = np.empty(1 << 20, np.float32)
        t0 = time.perf_counter()
        fn(SEED, draws[name])
        draws[name + "_ms"] = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(draws["native"], draws["numpy"]),
          "the native portable normals differ from the numpy path")
    report["native"] = {"perlin_256x256_ms": {k: out[k + "_ms"] for k in ("native", "numpy")},
                        "normals_1M_ms": {k: draws[k + "_ms"] for k in ("native", "numpy")}}
    print(f"[tools native] {card}: loaded {native.lib._dll._name}; perlin_fbm 256x256 "
          f"(4 octaves) native {out['native_ms']:.2f} ms, numpy {out['numpy_ms']:.2f} ms; "
          f"fill_standard_normal 1M native {draws['native_ms']:.2f} ms, numpy "
          f"{draws['numpy_ms']:.2f} ms (host clock); both bit-equal", flush=True)


def tools_pages(torch, np, dev, world_dir, work_dir, launches, report, card):
    """Each tool's page function on the card at full width (the card has no
    matplotlib): the kernels' launches held to the forwards each runs."""
    from terrain_diffusion_tpu_torch.nn.torch_compat import load_model
    from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline
    from terrain_diffusion_tpu_torch.training.datasets import collate
    from terrain_diffusion_tpu_torch.training.dev_utils import curves, figs, load_section
    from terrain_diffusion_tpu_torch.training.dev_utils import dataset_viz, model_viz, noise_viz

    decoder = load_model(os.path.join(world_dir, "decoder_model"), device=dev)
    base = load_model(os.path.join(world_dir, "base_model"), device=dev)
    vae = load_model(os.path.join(world_dir, "autoencoder_x8", "latest_checkpoint",
                                  "saved_model_ema"), device=dev)
    dec512 = load_section(tool_config(work_dir, "decoder", 512, 2), "val_dataset")
    ae512 = load_section(tool_config(work_dir, "autoencoder", 512, 1), "val_dataset")
    lat64 = load_section(tool_config(work_dir, "latents", 64, 1), "val_dataset")
    sigmas = curves.sigma_grid(2e-3, 80.0, TOOLS_SIGMAS)
    enc, dec = vae_launches(vae, 512)
    one_decoder = {"fused_block": 26, "conv3x3": 2, "attention": 0}
    none = {"fused_block": 0, "conv3x3": 0, "attention": 0}
    world = WorldPipeline.from_pretrained(world_dir, seed=SEED, device=dev)
    world.bind()

    def loss_curve():
        curve = curves.noise_loss_curve(decoder, collate([dec512[i] for i in range(2)]),
                                        sigmas, SEED)
        return curves.curve_page(sigmas, *curve, 2)

    tools = [  # (label, page function maker, launches expected, or None for the world's forwards)
        ("pipeline-viz 512x512", lambda: figs.pipeline_viz_page(world, SEED, (0, 0), 512), None),
        ("consistency-decoder 512x512",
         lambda: model_viz.consistency_decoder_pages(dec512, decoder, SEED), one_decoder),
        ("autoencoder 512x512", lambda: model_viz.autoencoder_pages(ae512, vae, SEED),
         {k: enc[k] + dec[k] for k in enc}),
        (f"noise-loss-curve 512x512 b2 {TOOLS_SIGMAS} sigmas", loss_curve,
         {k: TOOLS_SIGMAS * v for k, v in one_decoder.items()}),
        ("base-diffusion 64x64 15 steps + decoder 512x512",
         lambda: model_viz.base_diffusion_pages(lat64, base, SEED, 15, decoder),
         dict(one_decoder, attention=15)),
        ("dataset latents 64x64", lambda: (lambda i: dataset_viz._dataset_page(
            lat64, i, True, dev)), none),
        ("noise 192x192", lambda: noise_viz.noise_page(SEED, 192, 64, "both", dev), none),
        ("windows", lambda: figs.windows_page(64, 32), none),
        ("signed-sqrt", figs.signed_sqrt_page, none),
    ]
    report["tools"] = {}
    for label, make, expected in tools:
        torch.cuda.reset_peak_memory_stats()
        before = stage_calls(world)
        t0 = time.perf_counter()
        pages, n = launches.run(lambda: [make()(0)])
        seconds = time.perf_counter() - t0
        pages_finite(np, label, pages)
        if expected is None:
            expected = forward_launches(world, before, label)
        check(n == expected, f"{label} launched {n}, expected {expected}")
        report["tools"][label] = {"seconds": seconds, "launches": n, "panels": len(pages[0].panels),
                                  "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        print(f"[tools] {card}: {label}: {len(pages[0].panels)} panels in {seconds:.2f} s, "
              f"launches {n}", flush=True)
    print(f"[tools] pipeline-viz stages: " + ", ".join(
        f"{k} {v['calls']} x {v['mean_ms']:.1f} ms" for k, v in world.timing_summary().items()),
        flush=True)
    world.close()


def tools_card_vs_cpu(torch, np, world_dir, work_dir, launches, report, card,
                      devices=("cuda", "cpu")):
    """consistency-decoder's page at crop 128 on the card against the same
    page on the CPU; sde-dpmsolver++ (order 2, midpoint) on the coarse model,
    card against CPU on the same noise."""
    card_dev, cpu = devices
    from terrain_diffusion_tpu_torch.evaluation.samplers import cond_inputs_from_snr
    from terrain_diffusion_tpu_torch.nn.torch_compat import load_model
    from terrain_diffusion_tpu_torch.scheduler.dpmsolver import (EDMSchedulerConfig,
                                                                 compute_sigmas, sample_dpm,
                                                                 trigflow_precondition_noise)
    from terrain_diffusion_tpu_torch.training.dev_utils import load_section, model_viz

    ds = load_section(tool_config(work_dir, "decoder", 128, 1), "val_dataset")
    pages = {}
    for dev in devices:
        decoder = load_model(os.path.join(world_dir, "decoder_model"), device=dev)
        page_fn = model_viz.consistency_decoder_pages(ds, decoder, SEED)
        if dev == card_dev:
            pages[dev], n = launches.run(lambda: page_fn(0))
            check(n == top_level_launches(decoder), f"consistency-decoder 128x128 launched {n}")
        else:
            pages[dev] = page_fn(0)
    errs = {}
    for (kind, name, got, *_), (_, _, want, *_) in zip(pages[card_dev].panels,
                                                       pages[cpu].panels):
        errs[name] = rel_err(torch.as_tensor(got), torch.as_tensor(want))
    print(f"[tools] {card}: consistency-decoder 128x128 page, card vs CPU: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)
    check(max(errs.values()) < TOOLS_TOL, f"consistency-decoder page card vs CPU: {errs}")

    cfg = EDMSchedulerConfig(algorithm_type="sde-dpmsolver++", solver_order=2,
                             solver_type="midpoint")
    steps = 20
    rng = np.random.default_rng(SEED + 31)
    x0 = rng.standard_normal((1, 64, 64, 6)).astype(np.float32) * compute_sigmas(cfg, steps)[0]
    cond = rng.standard_normal((1, 64, 64, 5)).astype(np.float32)
    noise = rng.standard_normal((steps, 1, 64, 64, 6)).astype(np.float32)
    out = {}
    for dev in devices:
        model = load_model(os.path.join(world_dir, "coarse_model"), device=dev)
        scalars, _ = cond_inputs_from_snr([0.3, 0.1, 1.0, 0.1, 1.0], 1, device=dev)
        cond_t = torch.from_numpy(cond).to(dev)

        def model_fn(scaled, sigma):
            nl = torch.full((1,), float(trigflow_precondition_noise(sigma, cfg.sigma_data)),
                            device=dev)
            return model(torch.cat([scaled, cond_t], dim=-1), nl, scalars)

        t0 = time.perf_counter()
        with torch.no_grad():
            out[dev] = sample_dpm(model_fn, torch.from_numpy(x0).to(dev), cfg, steps,
                                  sde_noise=torch.from_numpy(noise).to(dev)).cpu()
        out[dev + "_s"] = time.perf_counter() - t0
    err = rel_err(out[card_dev], out[cpu])
    report["card_vs_cpu"] = {"consistency_decoder_128": errs, "sde_dpmsolver_coarse": err,
                             "sde_s": {"card": out[card_dev + "_s"], "cpu": out[cpu + "_s"]}}
    print(f"[tools] {card}: sde-dpmsolver++ order 2 midpoint, coarse 64x64, {steps} steps: "
          f"card {out[card_dev + '_s']:.2f} s, CPU {out[cpu + '_s']:.2f} s, card vs CPU "
          f"{err:.3e}, output std {float(out[card_dev].std()):.4f}", flush=True)
    check(bool(torch.isfinite(out[card_dev]).all()) and err < TOOLS_TOL,
          f"sde-dpmsolver++ card vs CPU: {err:.3e}")


def tools_sweep(torch, np, dev, world_dir, work_dir, report, card):
    """run_sweep over the autoencoder objective: 3 trials (2 startup) on the
    PostHocEMA snapshots of the training phase's autoencoder_x8 run, 16
    in-memory 64x64 items; then the JSONL store resumed to a 4th trial."""
    from terrain_diffusion_tpu_torch.nn.torch_compat import load_model
    from terrain_diffusion_tpu_torch.training.phema import PostHocEMA
    from terrain_diffusion_tpu_torch.training.sweeps import sweep

    run_dir = os.path.join(world_dir, "autoencoder_x8")
    ckpt, phema = os.path.join(run_dir, "latest_checkpoint"), os.path.join(run_dir, "phema")
    snaps = PostHocEMA.list_snapshots(phema)
    check(len(snaps) >= 2, f"the autoencoder_x8 run wrote {len(snaps)} PostHocEMA snapshots")
    model = load_model(os.path.join(ckpt, "saved_model"), device=dev)
    data = MemoryDataset("autoencoder", 64, SEED + 32, n_items=16)
    items = [data[i] for i in range(16)]
    space = sweep.SweepSpace({"ema_sigma": (0.015, 0.25, True)})
    store = os.path.join(work_dir, "trials.jsonl")
    objective = sweep.autoencoder_objective(model, phema, items, SEED)
    kw = dict(storage=store, seed=SEED % 1000, n_startup_trials=2, prior_weight=0.2,
              prune_probability_threshold=0.05)
    t0 = time.perf_counter()
    best = sweep.run_sweep(objective, space, n_trials=3, **kw)
    seconds = time.perf_counter() - t0
    with open(store) as f:
        first = f.readlines()
    trials = [json.loads(line) for line in first]
    check(len(trials) == 3 and all(math.isfinite(t["value"]) for t in trials),
          f"the sweep's trials: {trials}")
    sweep.run_sweep(objective, space, n_trials=4, **kw)
    with open(store) as f:
        lines = f.readlines()
    check(len(lines) == 4 and lines[:3] == first, "the JSONL store did not resume")
    report["sweep"] = {"seconds_3_trials": seconds, "snapshots": len(snaps),
                       "values": [t["value"] for t in trials], "best": best}
    print(f"[tools sweep] {card}: 3 trials over {len(snaps)} snapshots in {seconds:.2f} s: "
          + ", ".join(f"ema_sigma {t['params']['ema_sigma']:.4f} -> {t['value']:.5f}"
                      + (" (pruned)" if t["pruned"] else "") for t in trials)
          + "; resumed to 4 trials", flush=True)


def tools_phase(torch, np, cuda_lib, fb, attn, world_dir, card) -> dict:
    """The dev tools and the remaining host pieces: every dev-viz tool's
    pages at full width, one page and the SDE sampler card vs CPU, a sweep
    over the training phase's VAE snapshots, the native library; rendering
    without matplotlib names it.  Returns the launches by (kernel, type)."""
    import importlib.util

    from terrain_diffusion_tpu_torch import __main__ as cli_main

    register_memory_datasets()
    launches = EvalLaunches(torch, cuda_lib, fb, attn)
    report = {"card": card}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as work_dir:
        tools_pages(torch, np, torch.device("cuda", 0), world_dir, work_dir, launches, report,
                    card)
        tools_card_vs_cpu(torch, np, world_dir, work_dir, launches, report, card)
        tools_sweep(torch, np, "cuda", world_dir, work_dir, report, card)
        png = os.path.join(work_dir, "windows.png")
        argv = ["dev-viz", "windows", "--out", png, "--headless"]
        if importlib.util.find_spec("matplotlib") is None:
            try:  # rendering needs matplotlib: the command must say so, not exit 0
                cli_main.cli.main(argv, standalone_mode=False)
                fail("dev-viz windows rendered without matplotlib")
            except RuntimeError as e:
                check("matplotlib" in str(e) and not os.path.exists(png),
                      f"dev-viz without matplotlib: {e}")
            report["render"] = "no matplotlib on this machine: the pages are built, " \
                               "rendering fails naming it"
        else:
            cli_main.cli.main(argv, standalone_mode=False)
            check(os.path.getsize(png) > 10_000, "dev-viz windows wrote no PNG")
            report["render"] = "matplotlib: dev-viz windows wrote its PNG"
        print(f"[tools] rendering: {report['render']}", flush=True)
    tools_native(np, report, card)
    report["launches"] = {f"{k} {str(dt).replace('torch.', '')}": n
                          for (k, dt), n in launches.total.items()}
    print(json.dumps({"tools": report}), flush=True)
    return launches.total


PARALLEL_STEPS = 2


def parallel_train_config(save_dir: str) -> dict:
    """``diffusion_decoder_64-3.cfg`` at full width, batch 4 of 128x128
    crops from the in-memory decoder dataset, for the data-parallel checks."""
    from terrain_diffusion_tpu_torch.training.registry import apply_overrides, load_config

    config = load_config(os.path.join(ROOT, DECODER_CFG))
    for section in UNUSED_SECTIONS:
        config.pop(section, None)
    apply_overrides(config, [f"logging.save_dir={json.dumps(save_dir)}",
                             memory_dataset("decoder", 128), "training.batch_size=4",
                             "logging.save_epochs=0"])
    return config


def parallel_train_rank(config: dict, device: str) -> dict:
    """One rank of a data-parallel run (inside ``distributed.launch``)."""
    import torch

    from terrain_diffusion_tpu_torch.training.train import run_training

    torch.backends.cudnn.deterministic = True
    register_memory_datasets()
    return run_training(config, max_steps=PARALLEL_STEPS, log_every=1, device=device)[2]


def checkpoint_tensors(torch, save_dir: str) -> dict:
    """The weights and Adam moments a run saved, by name."""
    from safetensors.torch import load_file

    ckpt = os.path.join(save_dir, "latest_checkpoint")
    out = {f"w/{k}": v for k, v in load_file(
        os.path.join(ckpt, "saved_model", "model.safetensors")).items()}
    opt = torch.load(os.path.join(ckpt, "train_state.pt"), map_location="cpu")["opt_state"]
    for moment in ("mu", "nu"):
        out.update({f"{moment}/{k}": v for k, v in opt[moment].items()})
    return out


def parallel_worlds(torch, np, cuda_lib, fb, attn, models, report, card):
    """block_impl="xla" against the kernel world, and a world on a mesh of
    two slots on cuda:0 (and over every card where there are two or more)
    against the single-device world, each with its launches held."""
    from terrain_diffusion_tpu_torch.parallel import Mesh
    from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline

    # the world's first get, then a get at a fresh region: both cold tiles,
    # the second after the world's code paths have run once
    boxes = ((0, 0, 256, 256), (8192, -4096, 8448, -3840))

    def serve(label, **kw):
        pipe = WorldPipeline(seed=SEED, device="cuda", **kw).set_models(*models).bind()
        cuda_lib.reset_launch_counts()
        outs, secs = [], []
        for box in boxes:
            t0 = time.perf_counter()
            outs.append(pipe.get(*box))
            secs.append(time.perf_counter() - t0)
            check(np.isfinite(outs[-1]["elev"]).all() and np.isfinite(outs[-1]["climate"]).all(),
                  f"{label}: a value is not finite")
        launches = {"fused_block": fb.fused_block.launches, "conv3x3": fb.conv3x3.launches,
                    "attention": attn.fused_pixelnorm_attention.launches}
        print(f"[parallel] {label}: cold 256x256 gets {secs[0] * 1000:.1f} ms (the world's "
              f"first), {secs[1] * 1000:.1f} ms (a fresh region); launches {launches} ({card})",
              flush=True)
        return pipe, outs, launches, secs

    # each world is closed once read: its forwards' CUDA graphs keep the
    # memory of its largest forward until then, and a float32 world's next
    # to another's does not fit on one card
    ref, want, ref_launches, ref_s = serve("kernel world")
    want_launches = forward_launches(ref, {}, "parallel kernel world")
    ref.close()
    check(ref_launches == want_launches, f"kernel world launches {ref_launches}")
    report["kernel_world_s"] = ref_s
    xla, got, launches, secs = serve("block_impl=xla world", block_impl="xla")
    err = max(rel_err(torch.from_numpy(g[k]), torch.from_numpy(w[k]))
              for g, w in zip(got, want) for k in ("elev", "climate"))
    print(f"[parallel] block_impl=xla vs kernels: rel_err={err:.3e}", flush=True)
    check(launches == {"fused_block": 0, "conv3x3": 0,
                       "attention": forward_launches(xla, {}, "xla world")["attention"]},
          f"block_impl=xla launched block or conv kernels: {launches}")
    xla.close()
    check(err < KERNEL_TOL, f"block_impl=xla disagrees with the kernel world: {err:.3e}")
    report["xla_world"] = {"s": secs, "rel_err": err, "launches": launches}
    meshes = [("mesh cuda:0 x2", ["cuda:0", "cuda:0"])]
    if torch.cuda.device_count() >= 2:
        meshes.append(("mesh over every card",
                       [f"cuda:{i}" for i in range(torch.cuda.device_count())]))
    else:
        print("[parallel] mesh over every card: 1 card: not run", flush=True)
        report["mesh_every_card"] = "1 card: not run"
    for label, devices in meshes:
        mesh = Mesh.from_devices(devices)
        pipe, got, launches, secs = serve(label, mesh=mesh)
        for g, w in zip(got, want):
            for k in ("elev", "climate"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-5,
                                           err_msg=f"{label}: {k} differs from the single world")
        per_world = forward_launches(pipe, {}, label)
        expect = {k: n * mesh.size for k, n in per_world.items()}
        check(launches == expect, f"{label}: launches {launches} != forwards x slots {expect}")
        report[label] = {"s": secs, "launches": launches, "slots": mesh.size,
                         "buckets": {"coarse": list(pipe.coarse.batch_buckets),
                                     "latent": list(pipe.latents.batch_buckets),
                                     "decoder": list(pipe.residual.batch_buckets)}}
        pipe.close()
    return report["mesh cuda:0 x2"]["launches"]


def parallel_training(torch, np, work_dir, report, card):
    """A diffusion run under NCCL at world size 1 against the same run with
    no group, bit for bit; then two gloo ranks on cuda:0 against one rank,
    within 1e-5.  cuDNN runs its deterministic algorithms here, so that two
    runs of the same work give the same bits and only the group differs."""
    import torch.distributed as dist

    from terrain_diffusion_tpu_torch.parallel import distributed
    from terrain_diffusion_tpu_torch.training.train import run_training

    register_memory_datasets()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        parallel_training_runs(torch, dist, distributed, run_training, work_dir, report, card)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def parallel_training_runs(torch, dist, distributed, run_training, work_dir, report, card):
    alone = os.path.join(work_dir, "alone")
    t0 = time.perf_counter()
    run_training(parallel_train_config(alone), max_steps=PARALLEL_STEPS, log_every=1,
                 device="cuda:0")
    report["one_process_s"] = time.perf_counter() - t0
    nccl = os.path.join(work_dir, "nccl")
    distributed.init_group("nccl", 0, 1, distributed.free_port())
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              "the NCCL group did not form")
        t0 = time.perf_counter()
        run_training(parallel_train_config(nccl), max_steps=PARALLEL_STEPS, log_every=1,
                     device="cuda")
        report["nccl_world1_s"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    a, b = checkpoint_tensors(torch, alone), checkpoint_tensors(torch, nccl)
    same = a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    print(f"[parallel] NCCL world size 1 vs no group: {len(a)} tensors, bit-equal {same} "
          f"({card})", flush=True)
    check(same, "a train run under NCCL at world size 1 differs from the run with no group")
    report["nccl_world1_bit_equal"] = same

    gloo = os.path.join(work_dir, "gloo")
    t0 = time.perf_counter()
    counters = distributed.launch(parallel_train_rank, 2, parallel_train_config(gloo),
                                  "cuda:0", backend="gloo")
    report["gloo_two_ranks_s"] = time.perf_counter() - t0
    check(all(c["step"] == PARALLEL_STEPS and c["seen"] == 4 * PARALLEL_STEPS
              for c in counters), f"gloo ranks: counters {counters}")
    c = checkpoint_tensors(torch, gloo)
    check(c.keys() == a.keys(), "two gloo ranks saved other tensors than one process")
    diff = max(float((c[k] - a[k]).abs().max()) for k in a)
    close = all(torch.allclose(c[k], a[k], rtol=1e-5, atol=1e-5) for k in a)
    print(f"[parallel] two gloo ranks on cuda:0 vs one process: max|diff| {diff:.3e} over "
          f"{len(a)} weight and Adam tensors, within rtol 1e-5 + atol 1e-5: {close} ({card})",
          flush=True)
    check(close, f"two gloo ranks on cuda:0 differ from one process: max|diff| {diff:.3e}")
    report["gloo_two_ranks_max_abs_diff"] = diff


def parallel_spatial(torch, np, decoder, report, card):
    """The row-sharded forward under NCCL at world size 1 on the 64-3
    decoder at 512x512 against its plain forward."""
    import torch.distributed as dist

    from terrain_diffusion_tpu_torch.nn.layers import with_block_impl
    from terrain_diffusion_tpu_torch.parallel import (distributed, make_mesh, shard_spatial,
                                                      spatial_model)

    g = torch.Generator().manual_seed(SEED + 40)
    x = torch.randn((1, 512, 512, 5), generator=g).cuda()
    nl = torch.full((1,), 1.2, device="cuda")
    with torch.no_grad():
        want = with_block_impl(decoder, "xla")(x, nl, [])
    distributed.init_group("nccl", 0, 1, distributed.free_port())
    try:
        sp = spatial_model(decoder)
        t0 = time.perf_counter()
        with torch.no_grad():
            got = sp(shard_spatial(make_mesh(), x, dim=1), nl, [])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    err = rel_err(got, want)
    print(f"[parallel] row-sharded 512x512 forward at NCCL world size 1 vs plain: "
          f"rel_err={err:.3e}, {secs * 1000:.1f} ms ({card})", flush=True)
    check(got.shape == want.shape and err < 2e-5,
          f"the row-sharded forward disagrees with the plain forward: {err:.3e}")
    report["spatial_world1"] = {"rel_err": err, "ms": secs * 1000}


def parallel_extract(np, work_dir, report, card):
    """``extract_grid_data`` on a seeded global 10' GeoTIFF at JAX's cell
    size: every cell file equals the raster's window."""
    from terrain_diffusion_tpu_torch.common.geotiff import Affine, read_geotiff, write_geotiff
    from terrain_diffusion_tpu_torch.data.downloading.extract import extract_grid_data
    from terrain_diffusion_tpu_torch.data.world_grid import create_equal_area_grid

    rng = np.random.default_rng(SEED + 41)
    world = Affine.from_bounds(-180.0, -90.0, 180.0, 90.0, TEN_MINUTES[1], TEN_MINUTES[0])
    raster = smooth_field(np, rng, TEN_MINUTES, 2500.0, -800.0).astype(np.float32)
    src = os.path.join(work_dir, "global_10m.tif")
    write_geotiff(src, raster, world, compress=None)
    cells = create_equal_area_grid((368640.0, 368640.0))
    out_dir = os.path.join(work_dir, "cells")
    t0 = time.perf_counter()
    extract_grid_data(src, cells, out_dir)
    secs = time.perf_counter() - t0
    names = sorted(os.listdir(out_dir))
    check(len(names) == len(cells), f"extract wrote {len(names)} of {len(cells)} cells")
    for name in names[::max(len(names) // 16, 1)]:
        arr, t, _ = read_geotiff(os.path.join(out_dir, name))
        row0 = int(round((t.f - world.f) / world.e))
        col0 = int(round((t.c - world.c) / world.a))
        check(np.array_equal(arr, raster[row0:row0 + arr.shape[0], col0:col0 + arr.shape[1]]),
              f"extract: {name} is not the raster's window")
    print(f"[parallel] extract: {len(names)} cells of a 10' global raster in {secs:.2f} s "
          f"({card})", flush=True)
    report["extract"] = {"cells": len(names), "s": secs}


def parallel_phase(torch, np, cuda_lib, fb, attn, models, card) -> dict:
    """The parallel layer on the card: block_impl="xla", the mesh world,
    NCCL at world size 1, two gloo ranks on cuda:0, the row-sharded
    forward and the cell extractor.  Returns the mesh world's launches."""
    report = {"card": card}
    launches = parallel_worlds(torch, np, cuda_lib, fb, attn, models, report, card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as work_dir:
        parallel_training(torch, np, work_dir, report, card)
        parallel_spatial(torch, np, models[2], report, card)
        parallel_extract(np, work_dir, report, card)
    print(json.dumps({"parallel": report}), flush=True)
    return launches


# ---------------------------------------------------------------------------
# atlas phase
# ---------------------------------------------------------------------------

ATLAS_TILE = 256
ATLAS_ROW = [(0, j, ATLAS_TILE, j + ATLAS_TILE) for j in range(768, 1792, ATLAS_TILE)]
ATLAS_FRESH = [(8192, -8192), (-8192, 8192)]  # cold regions for the timed turns


def stage_tensors(world) -> list:
    """The world's stage tensors: residual, coarse and each latent phase."""
    tensors, t = [world.residual, world.coarse], world.latents
    while t is not world.coarse:
        tensors.append(t)
        t = t.args[0]
    return tensors


def atlas_world(torch, np, cuda_lib, fb, attn, models, dev, dtype, label) -> tuple:
    """One type's fused world and its staged twin: the same cold tile, warm
    tile and row of four, compared on the wire and in float32.  Returns
    (the fused world's launches, its report)."""
    from terrain_diffusion_tpu_torch.pipeline.world import WorldPipeline

    def serve(world):
        out, ms = {}, {}
        for name, fn in (("cold", lambda: world.get(0, 0, ATLAS_TILE, ATLAS_TILE,
                                                    pack_wire=True)),
                         ("warm", lambda: world.get(0, 0, ATLAS_TILE, ATLAS_TILE,
                                                    pack_wire=True)),
                         ("get_many", lambda: world.get_many(ATLAS_ROW, pack_wire=True)),
                         ("float", lambda: world.get(0, 0, ATLAS_TILE, ATLAS_TILE))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name] = fn()
            ms[name] = (time.perf_counter() - t0) * 1000
        return out, ms

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fused = WorldPipeline(seed=SEED, dtype=dtype, device=dev).set_models(*models).bind()
    check(fused.noise_mode == "threefry" and fused.T == 2 and fused.decoder_tile_size == 512
          and fused.residual.f_fused is not None, f"{label}: not the fused default world")
    cuda_lib.reset_launch_counts()
    before = stage_calls(fused)
    got, fused_ms = serve(fused)
    launches = check_launches(torch, cuda_lib, fb, attn, fused, before, label,
                              dtype=fused.compute_dtype)
    calls = stage_calls(fused)
    check(calls.get("compose", 0) > 0 and "compose_elev" not in calls,
          f"{label}: the fused world did not compose in one call ({calls})")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    nbytes = sum(t.device_cache._atlas.numel() * 4 for t in stage_tensors(fused))

    staged = WorldPipeline(seed=SEED, dtype=dtype, device=dev).set_models(*models).bind()
    for t in stage_tensors(staged):
        t.f_fused = None
    staged._compose_fused = lambda *a, **k: None
    want, staged_ms = serve(staged)
    check("compose_elev" in stage_calls(staged), f"{label}: the staged twin composed fused")
    for name in ("cold", "warm", "get_many"):
        pairs = zip(got[name], want[name]) if name == "get_many" else [(got[name], want[name])]
        for k, (g, w) in enumerate(pairs):
            check(g["elev"].dtype == np.int16 and g["climate"].dtype == np.float16,
                  f"{label} {name}: not the wire types")
            check(g["elev"].tobytes() == w["elev"].tobytes()
                  and g["climate"].tobytes() == w["climate"].tobytes(),
                  f"{label} {name} {k}: fused and staged wire bytes differ")
    errs = [rel_err(torch.from_numpy(got["float"][key]), torch.from_numpy(want["float"][key]))
            for key in ("elev", "climate")]
    check(max(errs) < 1e-5, f"{label}: fused vs staged float outputs {errs} >= 1e-5")
    # each world's first tile also pays first-use costs; two fresh regions
    # in turns (fused, staged, staged, fused) compare the paths' cold tiles
    turns, tiles = {"fused": [], "staged": []}, {}
    for name, world, (i, j) in (("fused", fused, ATLAS_FRESH[0]), ("staged", staged, ATLAS_FRESH[0]),
                                ("staged", staged, ATLAS_FRESH[1]), ("fused", fused, ATLAS_FRESH[1])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tile = world.get(i, j, i + ATLAS_TILE, j + ATLAS_TILE, pack_wire=True)
        turns[name].append((time.perf_counter() - t0) * 1000)
        body = tile["elev"].tobytes() + tile["climate"].tobytes()
        check(tiles.setdefault((i, j), body) == body,
              f"{label}: fused and staged wire bytes differ at a fresh region ({i}, {j})")
    report = {"stage_calls": calls, "fused_ms": fused_ms, "staged_ms": staged_ms,
              "cold_turns_ms": turns, "float_rel_err": errs, "atlas_bytes": nbytes,
              "peak_gib": peak}
    print(f"[{label}] fused ms {json.dumps({k: round(v, 1) for k, v in fused_ms.items()})}, "
          f"staged ms {json.dumps({k: round(v, 1) for k, v in staged_ms.items()})}; "
          f"fresh cold tiles in turns: fused {', '.join(f'{t:.1f}' for t in turns['fused'])}, "
          f"staged {', '.join(f'{t:.1f}' for t in turns['staged'])} ms; "
          f"wire bytes equal, float rel err {errs[0]:.2e} / {errs[1]:.2e}; atlases "
          f"{nbytes / 2 ** 20:.1f} MiB; peak {peak:.2f} GiB (fused world alone)", flush=True)
    fused.close()
    staged.close()
    return launches, report


def atlas_phase(torch, np, cuda_lib, fb, attn, models, dev, card) -> dict:
    """The device tile atlas with the fused stage and compose calls, in
    float32 and bf16, against the staged twin.  Returns the fused worlds'
    launches by (kernel, type)."""
    launches, report = {}, {"card": card}
    for dtype, label in ((None, "atlas"), ("bf16", "atlas bf16")):
        counts, report[label] = atlas_world(torch, np, cuda_lib, fb, attn, models, dev, dtype,
                                            label)
        dt = torch.float32 if dtype is None else torch.bfloat16
        launches.update({(k, dt): v for k, v in counts.items()})
    print(json.dumps({"atlas": report}), flush=True)
    return launches


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, ROOT)
    try:
        import numpy as np

        from terrain_diffusion_tpu_torch import native, use_full_f32
        from terrain_diffusion_tpu_torch.ops import attention as attn
        from terrain_diffusion_tpu_torch.ops import cuda_lib
        from terrain_diffusion_tpu_torch.ops import fused_block as fb
    except ImportError as e:
        fail(f"run from the root of a checkout of the repository ({e})")
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    use_full_f32()
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # build afresh, so that the spill and wgmma checks below read this build's
    # ptxas report (a library left by an earlier build leaves no log)
    stale = cuda_lib.library_path()
    if os.path.exists(stale):
        os.remove(stale)
    path = cuda_lib.build_kernels()
    print(f"[build] {os.path.relpath(path, ROOT)} in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    # no spill in the conv, block and wgmma-core kernels and the attention's
    # tensor-core kernel; no wgmma serialized by ptxas
    source = function = None
    n_wgmma = 0
    for line in cuda_lib.build_log.splitlines():
        if (line.startswith("==") or "registers" in line or "spill" in line
                or "Function properties" in line or "smem" in line or "wgmma" in line):
            print(f"[build] {line.strip()}")
        source = line[3:].strip() if line.startswith("==") else source
        found = re.search(r"Function properties for (\S+)", line)
        function = found.group(1) if found else function
        n_wgmma += bool(found and "conv_wgmma_kernel" in found.group(1))
        spilled = re.search(r"([1-9]\d*) bytes spill stores", line)
        held = source in ("conv3x3.cu", "fused_block.cu") or (
            source == "attention.cu" and "pixelnorm_attention_tc" in (function or ""))
        check(not (spilled and held), f"{function} of {source} spills registers: {line.strip()}")
        check(not ("wgmma" in line and "serialized" in line),
              f"ptxas serializes the wgmma core: {line.strip()}")
    print(f"[build] {n_wgmma} wgmma-core instantiations", flush=True)
    check(n_wgmma > 0, "the build log shows no wgmma-core instantiation")
    # the native host library (Perlin FBm, portable normals), so that no phase
    # takes its numpy paths: built afresh and loaded
    t0 = time.perf_counter()
    native_path = native.build(force=True)
    check(importlib.reload(native).get_native() is not None,
          f"the native library {native_path} did not load")
    print(f"[build] {os.path.relpath(native_path, ROOT)} (g++) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def timed(name, fn):
        t0 = time.perf_counter()
        result = fn()
        print(f"[time] {name} phase {time.perf_counter() - t0:.1f} s", flush=True)
        return result

    rows = timed("kernel", lambda: kernel_phase(torch, fb, attn, cuda_lib, dev))
    timed("threefry", lambda: threefry_phase(torch, dev))
    models = timed("model build", lambda: build_models(torch, dev))
    timed("model", lambda: model_phase(torch, np, attn, models, dev))
    timed("decoder forward", lambda: decoder_forward_phase(torch, fb, models[2], dev))
    timed("api", lambda: api_phase(torch, np, cuda_lib, fb, attn, models, dev))
    atlas_launches = timed("atlas", lambda: atlas_phase(
        torch, np, cuda_lib, fb, attn, models, dev, card))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_world_") as world_dir:
        launches, f32_tile = timed("minecraft", lambda: minecraft_phase(
            torch, np, cuda_lib, fb, attn, models, dev, world_dir))
        timed("bf16 model", lambda: model_phase_bf16(torch, np, fb, attn, models, dev))
        timed("bf16 decoder forward", lambda: decoder_forward_phase(
            torch, fb, models[2], dev, "bfloat16"))
        launches_fp16 = timed("fp16 forward", lambda: fp16_forward_phase(
            torch, fb, attn, models, dev))
        launches16 = timed("bf16 minecraft", lambda: minecraft_phase_bf16(
            torch, np, cuda_lib, fb, attn, dev, world_dir, f32_tile))
        torch.cuda.empty_cache()
        train_launches, _ = timed("training", lambda: training_phase(
            torch, np, cuda_lib, fb, attn, dev, world_dir, card))
        torch.cuda.empty_cache()
        eval_launches = timed("evaluation", lambda: evaluation_phase(
            torch, np, cuda_lib, fb, attn, models, dev, world_dir, card))
        torch.cuda.empty_cache()
        surface_launches = timed("surface", lambda: surface_phase(
            torch, np, cuda_lib, fb, attn, world_dir, card))
        torch.cuda.empty_cache()
        prep_launches = timed("data prep", lambda: data_prep_phase(
            torch, np, cuda_lib, fb, attn, world_dir, card))
        torch.cuda.empty_cache()
        export_launches = timed("export", lambda: export_phase(
            torch, np, cuda_lib, fb, attn, world_dir, card))
        torch.cuda.empty_cache()
        tools_launches = timed("tools", lambda: tools_phase(
            torch, np, cuda_lib, fb, attn, world_dir, card))
        torch.cuda.empty_cache()
        parallel_launches = timed("parallel", lambda: parallel_phase(
            torch, np, cuda_lib, fb, attn, models, card))
    print(f"[time] total {time.perf_counter() - t_start:.1f} s", flush=True)

    report = []
    for suffix, counts, dt in (("", launches, torch.float32), (BF16, launches16, torch.bfloat16),
                               (FP16, launches_fp16, torch.float16)):
        for kernel, (source, replaces, case) in KERNELS.items():
            mine = [r for r in rows if r["kernel"] == kernel + suffix]
            main_case = next(r for r in mine if r["case"] == case)
            report.append({"name": kernel + suffix.replace(" ", "_"), "route": "cuda",
                           "source": source, "replaces": replaces, "launches": counts[kernel],
                           "max_abs_err": max(r["max_abs_err"] for r in mine),
                           "ms": main_case["ms"], "device_ms": main_case["device_ms"],
                           "plain_ms": main_case["plain_ms"],
                           "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
                           "library_ms": main_case["library_ms"],
                           "library_device_ms": main_case["library_device_ms"], "case": case,
                           "training_launches": train_launches[kernel] if not suffix else 0,
                           "evaluation_launches": eval_launches.get((kernel, dt), 0),
                           "surface_launches": surface_launches.get((kernel, dt), 0),
                           "data_prep_launches": prep_launches.get((kernel, dt), 0),
                           "export_launches": export_launches.get(kernel, 0) if not suffix
                           else 0,
                           "tools_launches": tools_launches.get((kernel, dt), 0),
                           "parallel_launches": parallel_launches[kernel] if not suffix
                           else 0,
                           "atlas_launches": atlas_launches.get((kernel, dt), 0)})
    check(all(r["evaluation_launches"] > 0 for r in report[:len(KERNELS)]),
          "a float32 kernel was not launched on the evaluation path")
    check(all(r["surface_launches"] > 0 for r in report[:2 * len(KERNELS)]),
          "a float32 or bf16 kernel was not launched on the surface paths")
    check(all(r["data_prep_launches"] > 0 for r in report[:2]),
          "the block or conv kernel was not launched by the data-preparation encode")
    check(all(r["export_launches"] > 0 for r in report[:2]),
          "the loaded decoder program launched no block or conv kernel")
    check(all(r["tools_launches"] > 0 for r in report[:len(KERNELS)]),
          "a float32 kernel was not launched by the dev tools")
    check(all(r["parallel_launches"] > 0 for r in report[:len(KERNELS)]),
          "a float32 kernel was not launched by the mesh world")
    check(all(r["atlas_launches"] > 0 for r in report[:2 * len(KERNELS)]),
          "a float32 or bf16 kernel was not launched by the atlas phase's fused worlds")
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
