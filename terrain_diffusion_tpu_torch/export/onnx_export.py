"""Export EDMUnet2D models to ONNX - first-party, no `onnx` package needed.

Counterpart of ``terrain_diffusion_tpu.export.onnx_export`` and of the
reference's ONNX export (`onnx/export.py:24-250`), which serves the
game-mod consumers (Minecraft Fabric mod / Unity demo) that run the
pipeline U-Nets through onnxruntime without Python.  The I/O contract
matches the reference exactly:

  * one `.onnx` file per sub-model (coarse_model / base_model / decoder_model)
  * inputs  ``x`` (N,C,H,W float32, dynamic batch), ``noise_labels`` (N,),
    ``cond_i`` per conditional input; output ``output`` (N,C,H,W)
  * opsets 13 to 17 (17 by default), inference only (no logvar head,
    dropout off)

The graph is built directly from the model's block plan and its weights
as the JAX package's parameter tree (``torch_compat.params_to_jax``):
every magnitude-preserving weight normalization is *folded into the
initializers* at export time, in numpy, from the same arrays and in the
same order as the JAX exporter, so the two packages write the same bytes
for the same weights, but for the initializers' type: the port rounds
each fold to float32, where the JAX exporter (under NumPy 2) writes
float64, which ONNX runtimes reject beside float32 inputs.

Serialization is `onnx_proto.py` (first-party wire format); verification
is `onnx_ref_runtime.py` (numpy executor) against the port's forward on
the command's device, in float32 with TF32 off.  Every block option of
``nn/layers.py`` exports but learned conv resampling, which raises as in
JAX.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import click
import numpy as np
import torch

from terrain_diffusion_tpu_torch.export import onnx_proto as P
from terrain_diffusion_tpu_torch.nn.torch_compat import params_to_jax

_INT64_MAX = (1 << 63) - 1
_SILU_GAIN = 1.0 / 0.596


# ---------------------------------------------------------------------------
# Graph builder
# ---------------------------------------------------------------------------

class GraphBuilder:
    """Accumulates nodes/initializers; tracks static (C, H, W) per value."""

    def __init__(self, name: str):
        self.name = name
        self.nodes: List[P.NodeProto] = []
        self.initializers: List[P.TensorProto] = []
        self.inputs: List[P.ValueInfoProto] = []
        self.outputs: List[P.ValueInfoProto] = []
        self.shapes: Dict[str, Tuple[int, ...]] = {}  # static dims after batch
        self._n = 0
        self._const_cache: Dict[tuple, str] = {}

    # -- naming ------------------------------------------------------------
    def fresh(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    # -- values ------------------------------------------------------------
    def add_input(self, name: str, shape, elem_type: int = P.FLOAT,
                  static_dims: Optional[Tuple[int, ...]] = None):
        self.inputs.append(P.value_info(name, elem_type, shape))
        if static_dims is not None:
            self.shapes[name] = tuple(static_dims)

    def add_output(self, name: str, shape, elem_type: int = P.FLOAT):
        self.outputs.append(P.value_info(name, elem_type, shape))

    def init_tensor(self, arr: np.ndarray, hint: str) -> str:
        name = self.fresh(hint)
        self.initializers.append(P.tensor_from_numpy(arr, name))
        return name

    def const(self, value, dtype=np.float32) -> str:
        arr = np.asarray(value, dtype=dtype)
        key = (arr.dtype.str, arr.shape, arr.tobytes())
        if key not in self._const_cache:
            self._const_cache[key] = self.init_tensor(arr, "const")
        return self._const_cache[key]

    # -- nodes ---------------------------------------------------------------
    def emit(self, op: str, inputs: Sequence[str], n_out: int = 1,
             out_shape=None, **attrs):
        outs = [self.fresh(op.lower()) for _ in range(n_out)]
        node = P.NodeProto(op_type=op, input=list(inputs), output=outs,
                           name=self.fresh(f"n_{op}"))
        for k, v in attrs.items():
            node.attribute.append(P.make_attribute(k, v))
        self.nodes.append(node)
        if out_shape is not None:
            if n_out == 1:
                self.shapes[outs[0]] = tuple(out_shape)
            else:
                for o, s in zip(outs, out_shape):
                    self.shapes[o] = tuple(s)
        return outs[0] if n_out == 1 else tuple(outs)

    def rename(self, src: str, dst: str):
        """Emit Identity so a value surfaces under a required output name."""
        node = P.NodeProto(op_type="Identity", input=[src], output=[dst],
                           name=self.fresh("n_Identity"))
        self.nodes.append(node)
        if src in self.shapes:
            self.shapes[dst] = self.shapes[src]

    def model(self, opset: int = 17, doc: str = "") -> P.ModelProto:
        # the producer names the project, the same in both packages, so
        # that the files of the same weights are the same bytes
        graph = P.GraphProto(name=self.name, node=self.nodes,
                             initializer=self.initializers,
                             input=self.inputs, output=self.outputs)
        return P.ModelProto(
            ir_version=8, producer_name="terrain_diffusion_tpu",
            producer_version="1.0", graph=graph, doc_string=doc,
            opset_import=[P.OperatorSetIdProto(domain="", version=opset)])

    # -- math helpers (shape-tracked, NCHW activations) ---------------------
    def shape(self, name: str) -> Tuple[int, ...]:
        return self.shapes[name]

    def mul_scalar(self, x: str, s: float) -> str:
        if s == 1.0:
            return x
        return self.emit("Mul", [x, self.const(s)], out_shape=self.shape(x))

    def add_tensors(self, a: str, b: str) -> str:
        return self.emit("Add", [a, b], out_shape=self.shape(a))

    def silu(self, x: str) -> str:
        sig = self.emit("Sigmoid", [x], out_shape=self.shape(x))
        y = self.emit("Mul", [x, sig], out_shape=self.shape(x))
        return self.mul_scalar(y, _SILU_GAIN)

    def leaky_relu(self, x: str, alpha: float) -> str:
        y = self.emit("LeakyRelu", [x], alpha=alpha, out_shape=self.shape(x))
        return self.mul_scalar(y, 1.0 / math.sqrt((1 + alpha**2) / 2))

    def activation(self, x: str, kind: str) -> str:
        if kind == "silu":
            return self.silu(x)
        if kind == "leaky_relu":
            return self.leaky_relu(x, 0.2)
        raise NotImplementedError(f"activation {kind!r} not supported in export")

    def pixel_norm(self, x: str, axis: int, eps: float = 1e-4) -> str:
        """x / (eps + sqrt(mean_axis(x^2))) - `ops/mp.py::normalize` with dim=axis."""
        sq = self.emit("Mul", [x, x], out_shape=self.shape(x))
        mean = self.emit("ReduceMean", [sq], axes=[axis], keepdims=1)
        rms = self.emit("Sqrt", [mean])
        denom = self.emit("Add", [rms, self.const(eps)])
        return self.emit("Div", [x, denom], out_shape=self.shape(x))

    def mp_sum(self, parts: List[str], weights) -> str:
        w = np.asarray(weights, dtype=np.float64)
        norm = float(np.linalg.norm(w))
        out = self.mul_scalar(parts[0], float(w[0]) / norm)
        for p, wi in zip(parts[1:], w[1:]):
            out = self.add_tensors(out, self.mul_scalar(p, float(wi) / norm))
        return out

    def mp_concat_ch(self, parts: List[str], w: float) -> str:
        """mp_concat over the channel axis (1), `ops/mp.py::mp_concat`."""
        wv = np.array([1.0 - w, w], dtype=np.float64)
        chans = [self.shape(p)[0] for p in parts]
        c = math.sqrt(sum(chans) / float(np.sum(wv**2)))
        scaled = [self.mul_scalar(p, float(c / math.sqrt(ch) * wi))
                  for p, ch, wi in zip(parts, chans, wv)]
        _, h, wd = self.shape(parts[0])
        out = self.emit("Concat", scaled, axis=1,
                        out_shape=(sum(chans), h, wd))
        return out

    def clip(self, x: str, lo: float, hi: float) -> str:
        return self.emit("Clip", [x, self.const(lo), self.const(hi)],
                         out_shape=self.shape(x))


# ---------------------------------------------------------------------------
# Weight folding (normalize + gain/sqrt(fan_in) baked into initializers)
# ---------------------------------------------------------------------------

def _normalize_np(w: np.ndarray, dim=None, eps: float = 1e-4) -> np.ndarray:
    """numpy twin of `ops/mp.py::normalize` (f32, global or per-dim)."""
    w32 = w.astype(np.float32)
    if dim is None:
        norm = np.sqrt(np.sum(np.square(w32, dtype=np.float32)))
        norm_numel = 1
    else:
        norm = np.sqrt(np.sum(np.square(w32), axis=dim, keepdims=True))
        norm_numel = w32.size // w32.shape[dim]
    return w32 / (eps + norm * np.sqrt(norm_numel / w32.size))


# The folds run the JAX exporter's numpy code, in which NumPy 2 promotes
# to float64 (the norm's float64 scale), and each folded initializer is
# then rounded to float32: ONNX's Conv, MatMul and Gather take one type T
# for both operands, and the inputs are float32.  (The JAX exporter writes
# these initializers as float64, a graph onnxruntime rejects.)

def _folded_conv_weight(p: dict, gain: float = 1.0) -> np.ndarray:
    """HWIO param -> normalized, gain-scaled OIHW float32 numpy weight."""
    w = np.asarray(p["w"], dtype=np.float32)
    fan_in = int(np.prod(w.shape[:-1]))
    w = _normalize_np(w) * (gain / math.sqrt(fan_in))
    return np.transpose(w, (3, 2, 0, 1)).astype(np.float32)  # HWIO -> OIHW


def _folded_linear_weight(p: dict, gain: float = 1.0) -> np.ndarray:
    w = np.asarray(p["w"], dtype=np.float32)  # (in, out)
    fan_in = w.shape[0]
    return (_normalize_np(w) * (gain / math.sqrt(fan_in))).astype(np.float32)


# ---------------------------------------------------------------------------
# Layer emitters (mirror `nn/layers.py` forward semantics, NCHW)
# ---------------------------------------------------------------------------

def _conv(g: GraphBuilder, x: str, p: dict, *, gain: float = 1.0,
          groups: int = 1, no_padding: bool = False) -> str:
    w = _folded_conv_weight(p, gain)
    cout, _cin_g, kh, kw = w.shape
    wname = g.init_tensor(w, "w")
    pads = [0, 0, 0, 0] if no_padding else [kh // 2, kw // 2, kh // 2, kw // 2]
    _, h, wd = g.shape(x)
    oh = h - (kh - 1) if no_padding else h
    ow = wd - (kw - 1) if no_padding else wd
    return g.emit("Conv", [x, wname], kernel_shape=[kh, kw], pads=pads,
                  strides=[1, 1], group=groups, out_shape=(cout, oh, ow))


def _linear(g: GraphBuilder, x: str, p: dict, *, gain: float = 1.0,
            out_dims: Optional[Tuple[int, ...]] = None) -> str:
    w = _folded_linear_weight(p, gain)
    wname = g.init_tensor(w, "w")
    return g.emit("MatMul", [x, wname],
                  out_shape=out_dims if out_dims is not None else (w.shape[1],))


def _fourier(g: GraphBuilder, x: str, p: dict) -> str:
    """MPFourier on a (N,) input: cos(x*f + p) * sqrt(2)."""
    freqs = np.asarray(p["freqs"], dtype=np.float32)
    phases = np.asarray(p["phases"], dtype=np.float32)
    x2 = g.emit("Unsqueeze", [x, g.const([1], np.int64)], out_shape=(1,))
    y = g.emit("Mul", [x2, g.const(freqs)], out_shape=(freqs.size,))
    y = g.emit("Add", [y, g.const(phases)], out_shape=(freqs.size,))
    y = g.emit("Cos", [y], out_shape=(freqs.size,))
    return g.mul_scalar(y, math.sqrt(2.0))


def _positional(g: GraphBuilder, x: str, p: dict) -> str:
    freqs = np.asarray(p["freqs"], dtype=np.float32)
    x2 = g.emit("Unsqueeze", [x, g.const([1], np.int64)], out_shape=(1,))
    y = g.emit("Mul", [x2, g.const(freqs)], out_shape=(freqs.size,))
    s = g.emit("Sin", [y], out_shape=(freqs.size,))
    c = g.emit("Cos", [y], out_shape=(freqs.size,))
    out = g.emit("Concat", [s, c], axis=1, out_shape=(2 * freqs.size,))
    return g.mul_scalar(out, math.sqrt(2.0))


def _resample(g: GraphBuilder, x: str, mode: str) -> str:
    """Parameter-free pooling resample (`nn/layers.py::resample`)."""
    c, h, w = g.shape(x)
    if mode == "keep":
        return x
    if mode == "down":
        return g.emit(
            "Slice",
            [x, g.const([0, 0], np.int64), g.const([_INT64_MAX] * 2, np.int64),
             g.const([2, 3], np.int64), g.const([2, 2], np.int64)],
            out_shape=(c, (h + 1) // 2, (w + 1) // 2))
    if mode == "up":
        scales = g.const([1.0, 1.0, 2.0, 2.0])
        return g.emit("Resize", [x, "", scales], mode="nearest",
                      coordinate_transformation_mode="asymmetric",
                      nearest_mode="floor", out_shape=(c, h * 2, w * 2))
    raise NotImplementedError(f"resample mode {mode!r} not supported in export")


def _attention(g: GraphBuilder, x: str, p: dict, num_heads: int) -> str:
    """Pixel-norm attention, reference layout (`UNetBlock._attention`)."""
    c, h, w = g.shape(x)
    ch = c // num_heads
    hw = h * w
    y = _conv(g, x, p["attn_qkv"])  # (N, 3C, H, W)
    y = g.emit("Reshape", [y, g.const([0, num_heads, ch, 3, hw], np.int64)],
               out_shape=(num_heads, ch, 3, hw))
    y = g.pixel_norm(y, axis=2)
    q, k, v = g.emit("Split", [y], n_out=3, axis=3,
                     out_shape=[(num_heads, ch, 1, hw)] * 3)
    sq_axes = g.const([3], np.int64)
    q = g.emit("Squeeze", [q, sq_axes], out_shape=(num_heads, ch, hw))
    k = g.emit("Squeeze", [k, sq_axes], out_shape=(num_heads, ch, hw))
    v = g.emit("Squeeze", [v, sq_axes], out_shape=(num_heads, ch, hw))
    qt = g.emit("Transpose", [q], perm=[0, 1, 3, 2],
                out_shape=(num_heads, hw, ch))
    k = g.mul_scalar(k, 1.0 / math.sqrt(ch))
    logits = g.emit("MatMul", [qt, k], out_shape=(num_heads, hw, hw))
    wts = g.emit("Softmax", [logits], axis=-1, out_shape=(num_heads, hw, hw))
    wtsT = g.emit("Transpose", [wts], perm=[0, 1, 3, 2],
                  out_shape=(num_heads, hw, hw))
    out = g.emit("MatMul", [v, wtsT], out_shape=(num_heads, ch, hw))
    out = g.emit("Reshape", [out, g.const([0, c, h, w], np.int64)],
                 out_shape=(c, h, w))
    return _conv(g, out, p["attn_proj"])


def _unet_block(g: GraphBuilder, x: str, emb: Optional[str], p: dict, *,
                mode: str = "enc", conv_type: str = "default",
                resample_mode: str = "keep", attention: bool = False,
                channels_per_head: int = 64, res_balance: float = 0.3,
                attn_balance: float = 0.3, clip_act: Optional[float] = 256.0,
                no_padding: bool = False, activation: str = "silu",
                skip_input: Optional[str] = None, concat_w: float = 0.3,
                dropout: float = 0.0, expansion_factor: int = 1,
                resample_type: str = "pooling", **_unused) -> str:
    """One MP U-Net block, inference path of `nn/layers.py::UNetBlock`."""
    del dropout  # inference export: dropout off by definition
    if resample_type == "conv" and resample_mode != "keep":
        raise NotImplementedError(
            "resample_type='conv' (MPConvResample) is not supported by the "
            "ONNX exporter; production pipeline models use pooling resample")
    out_channels = p["conv_res1"]["w"].shape[-1]
    num_heads = out_channels // channels_per_head if attention else 0

    x = _resample(g, x, resample_mode)
    if skip_input is not None:
        x = g.mp_concat_ch([x, skip_input], w=concat_w)
    if mode == "enc":
        if "conv_skip" in p:
            x = _conv(g, x, p["conv_skip"])
        x = g.pixel_norm(x, axis=1)

    if conv_type == "mobile":
        y = _conv(g, g.activation(x, activation), p["conv_res0_pw"])
        y_ch = g.shape(y)[0]
        y = _conv(g, g.activation(y, activation), p["conv_res0_dw"],
                  groups=y_ch, no_padding=no_padding)
    else:
        y = _conv(g, g.activation(x, activation), p["conv_res0"],
                  no_padding=no_padding)
    if "emb_linear" in p and emb is not None:
        c = _linear(g, emb, p["emb_linear"], gain=float(np.asarray(p["emb_gain"])))
        c = g.emit("Add", [c, g.const(1.0)], out_shape=g.shape(c))
        # c / sqrt(mean(c^2) + 1e-8) - eps inside the sqrt
        # (`UNetBlock._emb_scale`), unlike pixel_norm's eps + sqrt(mean)
        sq = g.emit("Mul", [c, c], out_shape=g.shape(c))
        mean = g.emit("ReduceMean", [sq], axes=[1], keepdims=1)
        denom = g.emit("Sqrt", [g.emit("Add", [mean, g.const(1e-8)])])
        c = g.emit("Div", [c, denom], out_shape=g.shape(c))
        y_shape = g.shape(y)
        cb = g.emit("Unsqueeze", [c, g.const([2, 3], np.int64)],
                    out_shape=(g.shape(c)[0], 1, 1))
        y = g.emit("Mul", [y, cb], out_shape=y_shape)
        y = g.activation(y, activation)
    else:
        y = g.activation(y, activation)
    y = _conv(g, y, p["conv_res1"], no_padding=no_padding)

    if mode == "dec" and "conv_skip" in p:
        x = _conv(g, x, p["conv_skip"])

    xs, ys = g.shape(x), g.shape(y)
    if xs[1:] != ys[1:]:  # no_padding crop (`UNetBlock.forward`)
        dh, dw = xs[1] - ys[1], xs[2] - ys[2]
        x = g.emit(
            "Slice",
            [x, g.const([dh // 2, dw // 2], np.int64),
             g.const([xs[1] - (dh - dh // 2), xs[2] - (dw - dw // 2)], np.int64),
             g.const([2, 3], np.int64), g.const([1, 1], np.int64)],
            out_shape=(xs[0], ys[1], ys[2]))
    x = g.mp_sum([x, y], [1.0 - res_balance, res_balance])

    if num_heads > 0:
        a = _attention(g, x, p, num_heads)
        x = g.mp_sum([x, a], [1.0 - attn_balance, attn_balance])
    if clip_act is not None:
        x = g.clip(x, -clip_act, clip_act)
    return x


# ---------------------------------------------------------------------------
# Model exporter
# ---------------------------------------------------------------------------

def build_unet_graph(model, params: Optional[dict] = None, *,
                     image_size: Optional[int] = None,
                     graph_name: str = "edm_unet") -> GraphBuilder:
    """Build the full EDMUnet2D inference graph (the forward of
    `nn/edm_unet.py`); ``params`` is ``params_to_jax(model)``, computed
    when not given."""
    if params is None:
        params = params_to_jax(model)
    cfg = model.config
    size = image_size if image_size is not None else cfg.image_size
    g = GraphBuilder(graph_name)

    g.add_input("x", ["batch", cfg.in_channels, size, size],
                static_dims=(cfg.in_channels, size, size))
    has_noise = model.noise_dims > 0
    if has_noise:
        g.add_input("noise_labels", ["batch"], static_dims=())
    cond_names = []
    for i, (typ, dim, _w) in enumerate(cfg.conditional_inputs):
        name = f"cond_{i}"
        if typ == "float":
            g.add_input(name, ["batch"], static_dims=())
        elif typ == "tensor":
            g.add_input(name, ["batch", dim], static_dims=(dim,))
        elif typ == "embedding":
            g.add_input(name, ["batch"], elem_type=P.INT64, static_dims=())
        else:
            raise ValueError(f"unknown conditional input type {typ}")
        cond_names.append(name)

    # --- embeddings (`EDMUnet2D.compute_embeddings`) -----------------------
    emb = None
    embeds, weights = [], []
    if has_noise:
        if cfg.fourier_scale == "pos":
            nf = _positional(g, "noise_labels", params["noise_fourier"])
        else:
            nf = _fourier(g, "noise_labels", params["noise_fourier"])
        embeds.append(_linear(g, nf, params["noise_linear"]))
        weights.append(1.0)
    for i, (typ, _dim, w) in enumerate(cfg.conditional_inputs):
        cp = params["conditional_layers"][str(i)]
        if typ == "float":
            e = _linear(g, _fourier(g, cond_names[i], cp["fourier"]), cp["linear"])
        elif typ == "tensor":
            e = g.silu(_linear(g, cond_names[i], cp["linear"]))
        else:  # embedding: take(normalize(w), idx) (`MPEmbedding`)
            table = _normalize_np(np.asarray(cp["embed"]["w"], np.float32)).astype(np.float32)
            e = g.emit("Gather", [g.init_tensor(table, "embed"), cond_names[i]],
                       axis=0, out_shape=(table.shape[1],))
        embeds.append(e)
        weights.append(float(w))
    if embeds:
        emb = g.silu(g.mp_sum(embeds, weights))

    # --- trunk --------------------------------------------------------------
    bk = dict(cfg.block_kwargs or {})
    for runtime_key in ("block_impl", "attention_impl", "halo_mode"):
        bk.pop(runtime_key, None)

    # ones channel: Pad channel dim end by 1 with value 1.0
    x = g.emit("Pad",
               ["x", g.const([0, 0, 0, 0, 0, 1, 0, 0], np.int64), g.const(1.0)],
               mode="constant", out_shape=(cfg.in_channels + 1, size, size))

    skips = []
    for name, kind, _cin, _cout, opts in model.enc_plan:
        if kind == "conv":
            x = _conv(g, x, params["enc"][name])
        else:
            x = _unet_block(g, x, emb, params["enc"][name], **{**bk, **opts})
        skips.append(x)
    for name, _kind, _cin, _cout, opts in model.dec_plan:
        skip = skips.pop() if "block" in name else None
        x = _unet_block(g, x, emb, params["dec"][name], **{**bk, **opts},
                        skip_input=skip, concat_w=cfg.concat_balance)

    gain = float(np.asarray(params["out_gain"])) if "out_gain" in params else 1.0
    x = _conv(g, x, params["out_conv"], gain=gain)
    g.rename(x, "output")
    # declared dims come from the tracked shape — under no_padding the
    # spatial size shrinks below `size`
    g.add_output("output", ["batch", *g.shape("output")])
    return g


# the emitted op forms (Split with implicit equal split, ReduceMean with
# axes as an attribute, Squeeze/Unsqueeze/Pad/Slice/Clip with tensor
# operands) are valid exactly for opsets 13..17
_MIN_OPSET, _MAX_OPSET = 13, 17

# graphs above this spatial size verify via a second small export: the
# numpy interpreter at decoder resolution would hold hundreds of MB of
# full-res f32 intermediates and loop for minutes
_MAX_VERIFY_SIZE = 128
_VERIFY_SIZE = 64


def export_unet(model, out_path: str, *, image_size: Optional[int] = None,
                opset: int = 17, verify: bool = True,
                verify_tol: float = 5e-3) -> dict:
    """Export one port ``EDMUnet2D``; optionally verify it against the
    model's forward on the model's device (NHWC).

    The file lands at out_path only after verification passes (writes go
    to a temp sibling first), so a failed export never leaves a stale
    artifact.  Large-resolution graphs (decoder at 512px) are verified via
    an equivalent small-size export built from the same weights through
    the same code path (`verified_at` in the returned entry records the
    size).  The entry also gives the numpy runtime's seconds
    (`runtime_s`).
    """
    if not _MIN_OPSET <= opset <= _MAX_OPSET:
        raise ValueError(
            f"opset {opset} unsupported: emitted op forms are valid for "
            f"opsets {_MIN_OPSET}..{_MAX_OPSET}")
    params = params_to_jax(model)
    g = build_unet_graph(model, params, image_size=image_size,
                         graph_name=os.path.basename(out_path))
    proto = g.model(
        opset=opset,
        doc="terrain_diffusion_tpu EDMUnet2D "
            "(weights pre-normalized; inference only)")
    tmp_path = out_path + ".tmp"
    P.save_model(proto, tmp_path)
    entry = {
        "path": os.path.basename(out_path),
        "opset": opset,
        "inputs": [vi.name for vi in g.inputs],
        "bytes": os.path.getsize(tmp_path),
    }
    try:
        if verify:
            size = image_size if image_size is not None else model.config.image_size
            if size > _MAX_VERIFY_SIZE:
                small_path = out_path + ".verify.tmp"
                gs = build_unet_graph(model, params, image_size=_VERIFY_SIZE,
                                      graph_name="verify")
                P.save_model(gs.model(opset=opset), small_path)
                try:
                    diff, out_std, secs = verify_export(small_path, model,
                                                        image_size=_VERIFY_SIZE)
                finally:
                    os.remove(small_path)
                entry["verified_at"] = _VERIFY_SIZE
            else:
                diff, out_std, secs = verify_export(tmp_path, model, image_size=image_size)
                entry["verified_at"] = size
            entry["max_abs_diff"] = diff
            # out_std == 0 means out_gain is zero (fresh-init weights) and
            # the comparison is vacuous - surface it rather than claim parity
            entry["output_std"] = out_std
            entry["runtime_s"] = secs
            if diff > verify_tol:
                raise AssertionError(
                    f"ONNX export mismatch: max|diff|={diff:.3e} > {verify_tol}")
            entry["verified"] = out_std > 0.0
    except BaseException:
        os.remove(tmp_path)
        raise
    os.replace(tmp_path, out_path)
    return entry


def verify_inputs(model, batch: int, size: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """The ONNX feed ``verify_export`` draws: NCHW ``x``, the noise labels
    and each conditional input, from a numpy seed."""
    cfg = model.config
    rng = np.random.default_rng(seed)
    feed = {"x": rng.standard_normal((batch, cfg.in_channels, size, size)
                                     ).astype(np.float32)}
    if model.noise_dims > 0:
        feed["noise_labels"] = rng.standard_normal((batch,)).astype(np.float32)
    for i, (typ, dim, _w) in enumerate(cfg.conditional_inputs):
        if typ == "float":
            v = rng.standard_normal((batch,)).astype(np.float32)
        elif typ == "tensor":
            v = rng.standard_normal((batch, dim)).astype(np.float32)
        else:
            v = rng.integers(0, dim, (batch,)).astype(np.int64)
        feed[f"cond_{i}"] = v
    return feed


def model_forward_nchw(model, feed: Dict[str, np.ndarray]) -> np.ndarray:
    """The port's forward of an ONNX feed on the model's device, in float32
    with TF32 off; the NCHW output as numpy."""
    from terrain_diffusion_tpu_torch import use_full_f32

    use_full_f32()
    dev = next(model.parameters()).device
    n_cond = len(model.config.conditional_inputs)
    x = torch.from_numpy(np.ascontiguousarray(np.transpose(feed["x"], (0, 2, 3, 1)))).to(dev)
    noise = (torch.from_numpy(feed["noise_labels"]).to(dev)
             if model.noise_dims > 0 else None)
    conds = [torch.from_numpy(feed[f"cond_{i}"]).to(dev) for i in range(n_cond)]
    with torch.no_grad():
        want = model(x, noise, conds)
    return np.transpose(want.float().cpu().numpy(), (0, 3, 1, 2))


def verify_export(path: str, model, *, batch: int = 2,
                  image_size: Optional[int] = None,
                  seed: int = 0) -> Tuple[float, float, float]:
    """Run the exported graph on the numpy runtime vs the port's forward.

    Returns (max_abs_diff, reference_output_std, numpy runtime seconds)."""
    from terrain_diffusion_tpu_torch.export.onnx_ref_runtime import run_model

    size = image_size if image_size is not None else model.config.image_size
    feed = verify_inputs(model, batch, size, seed)
    t0 = time.perf_counter()
    got = run_model(P.load_model(path), feed)["output"]
    secs = time.perf_counter() - t0
    want = model_forward_nchw(model, feed)
    return float(np.max(np.abs(got - want))), float(np.std(want)), secs


# ---------------------------------------------------------------------------
# CLI (mirrors reference `onnx/export.py:210-250`)
# ---------------------------------------------------------------------------

_MODEL_SUBFOLDERS = ("coarse_model", "base_model", "decoder_model")


@click.command("onnx-export")
@click.argument("model_path")
@click.option("--output", "-o", default="onnx_export", show_default=True)
@click.option("--opset", default=17, show_default=True)
@click.option("--verify/--no-verify", default=True, show_default=True,
              help="Check the export against the model's forward on the "
                   "first-party numpy runtime.")
@click.option("--models", "-m", multiple=True,
              type=click.Choice(_MODEL_SUBFOLDERS),
              default=_MODEL_SUBFOLDERS)
@click.option("--device", default="cuda", show_default=True,
              help="where the verifying forward runs; --device cpu runs on the CPU")
def main(model_path, output, opset, verify, models, device):
    """Export WorldPipeline EDMUnet2D sub-models to ONNX.

    MODEL_PATH is a pipeline directory with coarse_model/ base_model/
    decoder_model/ subfolders (as written by WorldPipeline.save_pretrained).
    Returns the manifest.
    """
    from terrain_diffusion_tpu_torch.common.cli_helpers import click_check_device
    from terrain_diffusion_tpu_torch.nn import torch_compat

    click_check_device(device)
    os.makedirs(output, exist_ok=True)
    manifest = {}
    manifest_path = os.path.join(output, "manifest.json")

    def flush():
        with open(manifest_path + ".tmp", "w") as f:
            json.dump(manifest, f, indent=2)
        os.replace(manifest_path + ".tmp", manifest_path)

    flush()
    for name in models:
        sub = os.path.join(model_path, name)
        if not os.path.isdir(sub):
            click.echo(f"  [skip] {name}: {sub} not found")
            continue
        model = torch_compat.load_model(sub, device=device)
        # coarse/base run on 64px tiles in the pipeline regardless of the
        # training image_size (reference export.py:236)
        size = 64 if name in ("coarse_model", "base_model") else None
        out_path = os.path.join(output, f"{name}.onnx")
        entry = export_unet(model, out_path, image_size=size, opset=opset, verify=verify)
        manifest[name] = entry
        flush()  # manifest always reflects exactly the verified artifacts
        click.echo(f"  exported {name} -> {out_path}"
                   + (f" (max|diff|={entry['max_abs_diff']:.2e})"
                      if verify else ""))
    return manifest


if __name__ == "__main__":
    main()
