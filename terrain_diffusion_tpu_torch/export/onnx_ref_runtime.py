"""Reference numpy executor for the ONNX graphs the port exports.

The port's own copy of ``terrain_diffusion_tpu.export.onnx_ref_runtime``.
With no `onnxruntime` at hand, exported models are verified by executing
them with this small interpreter and comparing against the U-Net forward.
It implements exactly the opset-17 subset `onnx_export.py` emits (the
standard semantics for each op, so a real onnxruntime will agree):

    Conv MatMul Mul Add Sub Div Sqrt Cos Sin Sigmoid LeakyRelu Softmax
    Concat Reshape Transpose Slice Clip Pad Resize ReduceMean Gather
    Unsqueeze Squeeze Split Identity

Deliberately simple and allocation-happy: it is a correctness oracle for
tests and `--verify`, not a serving path (non-Python consumers load the
.onnx in onnxruntime, as the reference's consumers do,
`onnx/export.py:177-206`).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from terrain_diffusion_tpu_torch.export import onnx_proto as P


def _attrs(node: P.NodeProto) -> dict:
    return {a.name: P.attribute_value(a) for a in node.attribute}


# ---------------------------------------------------------------------------
# Op implementations
# ---------------------------------------------------------------------------

def _conv(x, w, *, pads, strides, group):
    n, cin, h, wd = x.shape
    cout, cin_g, kh, kw = w.shape
    ph0, pw0, ph1, pw1 = pads
    xp = np.pad(x, ((0, 0), (0, 0), (ph0, ph1), (pw0, pw1)))
    sh, sw = strides
    oh = (xp.shape[2] - kh) // sh + 1
    ow = (xp.shape[3] - kw) // sw + 1
    out = np.empty((n, cout, oh, ow), dtype=np.float32)
    cpg_out = cout // group
    for gi in range(group):
        xs = xp[:, gi * cin_g:(gi + 1) * cin_g]
        # im2col: (N, cin_g*kh*kw, oh*ow)
        cols = np.empty((n, cin_g * kh * kw, oh * ow), dtype=np.float32)
        idx = 0
        for ci in range(cin_g):
            for dy in range(kh):
                for dx in range(kw):
                    patch = xs[:, ci, dy:dy + sh * oh:sh, dx:dx + sw * ow:sw]
                    cols[:, idx] = patch.reshape(n, -1)
                    idx += 1
        wg = w[gi * cpg_out:(gi + 1) * cpg_out].reshape(cpg_out, -1)
        out[:, gi * cpg_out:(gi + 1) * cpg_out] = (
            wg @ cols).reshape(n, cpg_out, oh, ow)
    return out


def _resize_nearest(x, scales):
    # nearest / asymmetric / floor: out[i] = in[floor(i / scale)]
    out_shape = [int(np.floor(s * d)) for s, d in zip(scales, x.shape)]
    idx = [np.minimum((np.arange(o) / s).astype(np.int64), d - 1)
           for o, s, d in zip(out_shape, scales, x.shape)]
    return x[np.ix_(*idx)]


def _slice(data, starts, ends, axes=None, steps=None):
    rank = data.ndim
    axes = list(range(rank)) if axes is None else [int(a) % rank for a in axes]
    steps = [1] * len(starts) if steps is None else [int(s) for s in steps]
    sl = [slice(None)] * rank
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        st, en = int(st), int(en)
        en = min(en, np.iinfo(np.int32).max * 2)  # clamp sentinel ends
        sl[ax] = slice(st, en, sp)
    return data[tuple(sl)]


def _reshape(data, shape):
    out = []
    for i, d in enumerate(shape):
        if d == 0:
            out.append(data.shape[i])
        else:
            out.append(int(d))
    return data.reshape(out)


def _pad(data, pads, value):
    rank = data.ndim
    widths = [(int(pads[i]), int(pads[i + rank])) for i in range(rank)]
    return np.pad(data, widths, constant_values=float(value))


def _softmax(x, axis):
    m = np.max(x, axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / np.sum(e, axis=axis, keepdims=True)


# ---------------------------------------------------------------------------
# Interpreter
# ---------------------------------------------------------------------------

def run_model(model: P.ModelProto, feeds: Dict[str, np.ndarray],
              outputs: List[str] | None = None) -> Dict[str, np.ndarray]:
    graph = model.graph
    env: Dict[str, np.ndarray] = {}
    for init in graph.initializer:
        env[init.name] = P.tensor_to_numpy(init)
    for name, arr in feeds.items():
        env[name] = np.asarray(arr)

    wanted = outputs or [vi.name for vi in graph.output]
    # liveness: drop each intermediate after its last consumer, so big
    # graphs don't retain every node output for the whole run
    remaining_uses: Dict[str, int] = {}
    for node in graph.node:
        for name in node.input:
            if name:
                remaining_uses[name] = remaining_uses.get(name, 0) + 1
    for name in wanted:
        remaining_uses[name] = remaining_uses.get(name, 0) + 1

    for node in graph.node:
        op = node.op_type
        at = _attrs(node)
        ins = [env[n] if n else None for n in node.input]

        if op == "Conv":
            out = _conv(ins[0].astype(np.float32), ins[1],
                        pads=at.get("pads", [0, 0, 0, 0]),
                        strides=at.get("strides", [1, 1]),
                        group=at.get("group", 1))
        elif op == "MatMul":
            out = ins[0] @ ins[1]
        elif op == "Mul":
            out = ins[0] * ins[1]
        elif op == "Add":
            out = ins[0] + ins[1]
        elif op == "Sub":
            out = ins[0] - ins[1]
        elif op == "Div":
            out = ins[0] / ins[1]
        elif op == "Sqrt":
            out = np.sqrt(ins[0])
        elif op == "Cos":
            out = np.cos(ins[0])
        elif op == "Sin":
            out = np.sin(ins[0])
        elif op == "Sigmoid":
            out = 1.0 / (1.0 + np.exp(-np.clip(ins[0], -88.0, 88.0)))
        elif op == "LeakyRelu":
            alpha = at.get("alpha", 0.01)
            out = np.where(ins[0] >= 0, ins[0], alpha * ins[0])
        elif op == "Softmax":
            out = _softmax(ins[0], at.get("axis", -1))
        elif op == "Concat":
            out = np.concatenate(ins, axis=at["axis"])
        elif op == "Reshape":
            out = _reshape(ins[0], ins[1])
        elif op == "Transpose":
            out = np.transpose(ins[0], at["perm"])
        elif op == "Slice":
            out = _slice(ins[0], ins[1], ins[2],
                         ins[3] if len(ins) > 3 else None,
                         ins[4] if len(ins) > 4 else None)
        elif op == "Clip":
            out = np.clip(ins[0], ins[1], ins[2])
        elif op == "Pad":
            out = _pad(ins[0], ins[1], ins[2] if len(ins) > 2 else 0.0)
        elif op == "Resize":
            assert at.get("mode") == "nearest", "only nearest Resize emitted"
            out = _resize_nearest(ins[0], np.asarray(ins[2], dtype=np.float64))
        elif op == "ReduceMean":
            out = np.mean(ins[0], axis=tuple(at["axes"]),
                          keepdims=bool(at.get("keepdims", 1)))
        elif op == "Gather":
            out = np.take(ins[0], ins[1].astype(np.int64),
                          axis=at.get("axis", 0))
        elif op == "Unsqueeze":
            out = np.expand_dims(ins[0], tuple(int(a) for a in ins[1]))
        elif op == "Squeeze":
            out = np.squeeze(ins[0], tuple(int(a) for a in ins[1]))
        elif op == "Split":
            axis = at.get("axis", 0)
            n_out = len(node.output)
            parts = np.split(ins[0], n_out, axis=axis)
            for name, part in zip(node.output, parts):
                env[name] = part
            out = None
        elif op == "Identity":
            out = ins[0]
        else:
            raise NotImplementedError(f"op {op} not implemented in reference "
                                      "runtime")
        if op != "Split":
            env[node.output[0]] = out

        for name in node.input:
            if not name:
                continue
            remaining_uses[name] -= 1
            if remaining_uses[name] == 0:
                env.pop(name, None)

    return {name: env[name] for name in wanted}
