"""The row-sharded forward: one large map split into bands of rows, one
band per rank of the default process group (counterpart of JAX's
``shard_spatial`` and ``spatial_model``).

JAX shards a spatial axis with a ``NamedSharding`` and lets XLA's SPMD
partitioner add a halo exchange to every conv that reads across the cut.
Eager PyTorch has no partitioner, so the port writes the exchange itself:

- ``shard_spatial(mesh, x, dim=1)`` gives the rank its band;
- ``spatial_model(model)`` gives a copy of an ``EDMUnet2D`` or an
  ``EDMAutoencoder`` (sharing its parameters) with the block and conv
  kernels off, as JAX strips ``block_impl`` and ``attention_impl``.  Its
  3x3 SAME convs pad each band with its neighbours' edge rows (an
  ``all_gather`` of every band's first and last rows; zeros at the image's
  edges), then convolve VALID in H and SAME in W.  Attention all-gathers
  the rows, attends over the whole map and keeps its band.  Pixel norm,
  the 1x1 convs, the 2x2 downsample and the nearest up stay local, which
  holds where every level's band has whole rows: the height must divide by
  the world size times 2^(levels - 1) (JAX pads uneven shards instead);
  anything else raises ``ValueError`` naming the rule;
- ``gather_bands(y, dim=1)`` puts the bands back together on every rank.

The result of a forward is each rank's band of the output.  The exchange
uses ``torch.distributed`` collectives without autograd: this is an
inference path, as JAX's test of it is.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D
from terrain_diffusion_tpu_torch.nn.layers import (MPConv, UNetBlock, shared_copy,
                                                   with_block_impl)
from terrain_diffusion_tpu_torch.ops.attention import pixelnorm_attention_reference
from terrain_diffusion_tpu_torch.ops.nhwc import conv2d_nhwc
from terrain_diffusion_tpu_torch.parallel.mesh import Mesh


def _rule(height: int, world: int, levels: int) -> str:
    return (f"the row-sharded forward needs a height that divides by the world size "
            f"times 2^(levels - 1) = {world} x {2 ** (levels - 1)}; got {height}")


def shard_spatial(mesh: Mesh, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's band of ``x`` along ``dim`` (a spatial axis): equal bands
    in rank order, over a process group's mesh (``make_mesh()``)."""
    if not mesh.group:
        raise ValueError("the row-sharded forward runs one band per rank of a process "
                         "group: make the mesh with make_mesh() inside the group")
    world, size = mesh.size, x.shape[dim]
    if size % world:
        raise ValueError(f"the row-sharded forward needs equal bands: a height of {size} "
                         f"does not divide by the world size {world}")
    per = size // world
    return x.narrow(dim, mesh.rank * per, per).contiguous()


def gather_bands(y: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Every rank's band of ``y`` (equal shapes), joined along ``dim`` in
    rank order, on every rank."""
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, y.contiguous())
    return torch.cat(parts, dim=dim)


def exchange_halo(x: torch.Tensor, rows: int) -> torch.Tensor:
    """NHWC band ``x`` with ``rows`` rows of each neighbouring band above
    and below it, and zeros past the image's first and last rows."""
    if x.shape[1] < rows:
        raise ValueError(f"a band of {x.shape[1]} rows cannot give a halo of {rows}")
    edges = gather_bands(torch.cat([x[:, :rows], x[:, -rows:]], dim=1), dim=0)
    edges = edges.reshape(-1, *x.shape[:1], 2 * rows, *x.shape[2:])  # (world, N, 2r, W, C)
    rank, world = dist.get_rank(), dist.get_world_size()
    zeros = torch.zeros_like(x[:, :rows])
    above = edges[rank - 1][:, rows:] if rank > 0 else zeros
    below = edges[rank + 1][:, :rows] if rank < world - 1 else zeros
    return torch.cat([above, x, below], dim=1)


class HaloMPConv(MPConv):
    """An ``MPConv`` over a band of rows: SAME in W, and in H over the band
    padded with its neighbours' rows."""

    def forward(self, x, gain=1.0):
        if self.weight.dim() != 4 or self.weight.shape[-1] == 1:  # linear or 1x1: local
            return super().forward(x, gain)
        w = self.prepared_weight(gain).to(x.dtype)
        p = w.shape[-1] // 2
        return conv2d_nhwc(exchange_halo(x, p), w, padding=(0, p), groups=self.groups)


class BandUNetBlock(UNetBlock):
    """A ``UNetBlock`` over a band of rows: its attention attends over the
    whole map, gathered from every band."""

    def _attention(self, x, kernels: bool = True):
        y = gather_bands(self.attn_qkv(x))
        out = pixelnorm_attention_reference(y, self.num_heads, round_normed=True)
        rank, h = dist.get_rank(), x.shape[1]
        return self.attn_proj(out[:, rank * h:(rank + 1) * h].to(x.dtype))


def _check_band(unet: EDMUnet2D, args, kwargs):
    x = args[0] if args else kwargs["x"]
    levels = len(unet.config.model_channel_mults or (1, 2, 3, 4))
    world = dist.get_world_size()
    if x.shape[1] % 2 ** (levels - 1):
        raise ValueError(_rule(x.shape[1] * world, world, levels))


def spatial_model(model):
    """A copy of ``model`` (sharing its parameters) that runs on bands of
    rows over the default process group, with the block and conv kernels
    off; its forward takes and gives this rank's band."""
    for m in model.modules():
        if isinstance(m, MPConv) and m.no_padding:
            raise ValueError("the row-sharded forward takes SAME convs only (no_padding=False)")
    sp = with_block_impl(model, "xla")
    if sp is model:
        sp = shared_copy(model)
    for m in sp.modules():
        if type(m) is MPConv:
            m.__class__ = HaloMPConv
        elif type(m) is UNetBlock:
            m.__class__ = BandUNetBlock
            m.attention_impl = "xla"
        if isinstance(m, EDMUnet2D):
            m.register_forward_pre_hook(_check_band, with_kwargs=True)
    return sp
