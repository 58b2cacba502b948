"""The port's export surface against the JAX package's, on the CPU.

- ONNX (``terrain_diffusion_tpu_torch.export.onnx_export``): for the same
  weights the port writes the same bytes as JAX's ``export_unet``, for an
  attention model with all three conditional-input types, a mobile +
  leaky_relu + positional model and a no_padding model; its file runs on
  the port's numpy runtime within JAX's bar of 5e-3 max|diff| of both the
  JAX forward and the port's forward (the measured values are printed);
  and the contract cases of ``tests/test_onnx_export.py`` hold.
- The U-Net block options (``nn/layers.py``): mobile convs, expansion
  factor 2, no_padding, leaky_relu, conv_type "fused" and learned conv
  resampling, each within 1e-4 max|diff| / max|ref| of the JAX forward (the
  per-U-Net bar), with the parameter tree of ``params_to_jax`` shaped as
  JAX's ``init``.
- ``torch.export`` (``export/torch_export.py``) and both commands through
  the group with ``--device cpu``: the programs hold the registered kernel
  operators, load back bit-equal to eager, and the decoder's is within 1e-4
  of the JAX forward.

Weights are drawn once per model from a torch seed (with live block gains,
out gains and resample weights, so that no comparison is vacuous), cross
to the JAX layout through ``params_to_jax`` and back to a fresh port model
through ``params_from_jax``.  Inputs come from numpy seeds.  The JAX
forwards are jitted (one compile a model, not one per op).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from terrain_diffusion_tpu.export import onnx_export as jax_onnx
from terrain_diffusion_tpu.nn.edm_unet import EDMUnet2D as JaxUNet
from terrain_diffusion_tpu.nn.edm_unet import EDMUnetConfig as JaxConfig

from terrain_diffusion_tpu_torch import __main__ as port_main
from terrain_diffusion_tpu_torch import use_full_f32
from terrain_diffusion_tpu_torch.export import onnx_export, onnx_proto as P, torch_export
from terrain_diffusion_tpu_torch.export.onnx_ref_runtime import run_model
from terrain_diffusion_tpu_torch.nn.edm_unet import EDMUnet2D, EDMUnetConfig
from terrain_diffusion_tpu_torch.nn.layers import FUSED_MIN_PIXELS
from terrain_diffusion_tpu_torch.nn.torch_compat import (load_model, params_from_jax,
                                                         params_to_jax, save_model)
from terrain_diffusion_tpu_torch.ops import attention as attn
from terrain_diffusion_tpu_torch.ops import fused_block as fb

ONNX_TOL = 5e-3  # JAX's verify_tol: the numpy runtime sums in another order
UNET_TOL = 1e-4

_SMALL = dict(image_size=16, model_channels=16, model_channel_mults=(1, 2), layers_per_block=1,
              midblock_attention=False, logvar_channels=16)
CONFIGS = {
    "attention": dict(_SMALL, in_channels=3, out_channels=2, attn_resolutions=(8,),
                      midblock_attention=True, block_kwargs={"channels_per_head": 16},
                      conditional_inputs=(("float", 8, 0.2), ("tensor", 6, 0.3),
                                          ("embedding", 5, 0.1))),
    "mobile": dict(_SMALL, in_channels=2, fourier_scale="pos",
                   block_kwargs={"conv_type": "mobile", "expansion_factor": 2,
                                 "activation": "leaky_relu"}),
    # no_padding composes only with encode_only nets (as in JAX)
    "no_padding": dict(_SMALL, in_channels=2, model_channels=8, model_channel_mults=(1,),
                       layers_per_block=2, encode_only=True, logvar_channels=8,
                       fourier_scale="pos", block_kwargs={"no_padding": True}),
    "conv_resample": dict(_SMALL, in_channels=2, model_channels=8, logvar_channels=8,
                          block_kwargs={"resample_type": "conv", "resample_filter": 2,
                                        "resample_skip_weight": 0.3, "conv_type": "fused",
                                        "expansion_factor": 2}),
}
ONNX_MODELS = ("attention", "mobile", "no_padding")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while this module runs (six pytest-xdist
    workers share the CPU)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    use_full_f32()
    yield
    torch.set_num_threads(threads)


def _lively(model, seed):
    """Non-zero block gains, out gain and resample weights (an init leaves
    the gains at 0, where the output is 0, and the resample weights at 1)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("emb_gain"):
                p.copy_(torch.randn((), generator=g) * 0.5)
            elif name == "out_gain":
                p.fill_(0.7)
            elif name.endswith("resample.weight"):
                p.copy_(torch.randn(p.shape, generator=g))
    return model.eval()


def _port(cfg: dict, seed: int):
    return _lively(EDMUnet2D(EDMUnetConfig(**cfg), device="cpu",
                             generator=torch.Generator().manual_seed(seed)), seed + 1)


def _inputs(model, batch, size, seed):
    """An ONNX feed (NCHW) and the same inputs as NHWC arrays."""
    feed = onnx_export.verify_inputs(model, batch, size, seed)
    x = np.ascontiguousarray(np.transpose(feed["x"], (0, 2, 3, 1)))
    conds = [feed[f"cond_{i}"] for i in range(len(model.config.conditional_inputs))]
    return feed, x, feed.get("noise_labels"), conds


def _jax_forward(jmodel, tree, x, noise, conds):
    out = jax.jit(lambda p, x, n, c: jmodel.apply(p, x, n, c))(tree, x, noise, conds)
    return np.asarray(out)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.fixture(scope="module")
def models():
    """name -> (JAX model, JAX-layout tree, port model loaded from the tree,
    NHWC inputs, the JAX forward on them)."""
    out = {}
    for i, (name, cfg) in enumerate(CONFIGS.items()):
        tree = params_to_jax(_port(cfg, 10 * i))
        model = EDMUnet2D(EDMUnetConfig(**cfg), device="cpu",
                          generator=torch.Generator().manual_seed(99))
        model.load_state_dict(params_from_jax(model, tree))
        jmodel = JaxUNet(JaxConfig(**cfg))
        feed, x, noise, conds = _inputs(model, 2, cfg["image_size"], 1)
        out[name] = (jmodel, tree, model.eval(), feed,
                     _jax_forward(jmodel, tree, x, noise, conds))
    return out


def _port_forward(model, feed):
    return onnx_export.model_forward_nchw(model, feed)


# --- the block options -------------------------------------------------------

@pytest.mark.parametrize("name", ["mobile", "no_padding", "conv_resample"])
def test_block_options_match_jax(models, name):
    """mobile + expansion 2 + leaky_relu; no_padding; learned conv
    resampling + conv_type "fused" + expansion 2: the port's U-Net against
    JAX's forward on the same weights and inputs."""
    _jmodel, _tree, model, feed, want = models[name]
    got = np.transpose(_port_forward(model, feed), (0, 2, 3, 1))
    assert got.shape == want.shape
    rel = _rel(got, want)
    print(f"{name}: port vs JAX max|diff|/max|ref| = {rel:.3e}")
    assert rel < UNET_TOL


@pytest.mark.parametrize("name", list(CONFIGS))
def test_params_to_jax_is_shaped_as_jax_init(models, name):
    jmodel, tree, *_ = models[name]
    want = jax.eval_shape(jmodel.init, jax.random.key(0))
    got = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), tree)
    # JAX's tree carries the logvar head in its init; the name map covers it too
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert jax.tree.leaves(got) == jax.tree.leaves(want)


def test_params_to_jax_inverts_params_from_jax(models):
    _jmodel, tree, model, *_ = models["conv_resample"]
    back = params_to_jax(model)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_kernels_take_only_default_blocks():
    """JAX's block_eligible: every other block runs the plain path."""
    from terrain_diffusion_tpu_torch.nn.layers import UNetBlock

    kw = dict(device="cpu", generator=torch.Generator().manual_seed(0))
    assert UNetBlock(8, 8, 4, **kw).kernel_block
    for opts in ({"conv_type": "mobile"}, {"conv_type": "fused"}, {"expansion_factor": 2},
                 {"no_padding": True}, {"activation": "leaky_relu"}):
        assert not UNetBlock(8, 8, 4, **kw, **opts).kernel_block, opts


# --- ONNX --------------------------------------------------------------------

def _float32_initializers(blob: bytes) -> bytes:
    """An ONNX file with every float64 initializer rounded to float32."""
    proto = P.ModelProto.decode(blob)
    proto.graph.initializer = [
        P.tensor_from_numpy(P.tensor_to_numpy(t).astype(np.float32), t.name)
        if t.data_type == P.DOUBLE else t for t in proto.graph.initializer]
    return proto.encode()


@pytest.mark.parametrize("name", ONNX_MODELS)
def test_onnx_file_equals_jax_byte_for_byte(models, tmp_path, name):
    """The port's file is JAX's, byte for byte, once JAX's float64 folded
    weights (NumPy 2 promotes its folds; ONNX runtimes reject float64
    weights beside float32 inputs) are rounded to float32, the type the
    port writes: this holds the proto writer and the folding."""
    jmodel, tree, model, *_ = models[name]
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    ours.mkdir(), theirs.mkdir()
    entry = onnx_export.export_unet(model, str(ours / "m.onnx"))
    jax_onnx.export_unet(jmodel, tree, str(theirs / "m.onnx"), verify=False)
    port_blob, jax_blob = (ours / "m.onnx").read_bytes(), (theirs / "m.onnx").read_bytes()
    types = {t.data_type for t in P.load_model(str(ours / "m.onnx")).graph.initializer}
    assert P.DOUBLE not in types and P.FLOAT in types
    assert port_blob == _float32_initializers(jax_blob)
    assert entry["verified"] and entry["output_std"] > 0.0
    assert entry["max_abs_diff"] < ONNX_TOL
    if name == "no_padding":  # the declared output dims track the VALID convs
        dims = P.load_model(str(ours / "m.onnx")).graph.output[0].type.tensor_type.shape.dim
        n, h, w, c = models[name][4].shape
        assert [d.dim_value for d in dims[1:]] == [c, h, w] and h < 16


@pytest.mark.parametrize("name", ONNX_MODELS)
def test_numpy_runtime_matches_both_forwards(models, tmp_path, name):
    _jmodel, _tree, model, feed, want = models[name]
    path = str(tmp_path / "m.onnx")
    onnx_export.export_unet(model, path, verify=False)
    got = run_model(P.load_model(path), feed)["output"]
    d_jax = float(np.max(np.abs(got - np.transpose(want, (0, 3, 1, 2)))))
    d_port = float(np.max(np.abs(got - _port_forward(model, feed))))
    print(f"{name}: numpy runtime vs JAX max|diff| = {d_jax:.3e}, vs port {d_port:.3e}")
    assert d_jax < ONNX_TOL and d_port < ONNX_TOL


def test_proto_roundtrip(models):
    """encode -> decode -> encode is byte-identical (writer and reader agree)."""
    model = models["attention"][2]
    blob = onnx_export.build_unet_graph(model).model().encode()
    reparsed = P.ModelProto.decode(blob)
    assert reparsed.encode() == blob
    assert reparsed.opset_import[0].version == 17 and reparsed.ir_version == 8
    assert [vi.name for vi in reparsed.graph.input] == [
        "x", "noise_labels", "cond_0", "cond_1", "cond_2"]
    x_dims = reparsed.graph.input[0].type.tensor_type.shape.dim
    assert x_dims[0].dim_param == "batch"
    assert [d.dim_value for d in x_dims[1:]] == [3, 16, 16]


def test_opset_out_of_range_rejected(models, tmp_path):
    path = str(tmp_path / "x.onnx")
    for opset in (12, 18):
        with pytest.raises(ValueError, match="opset"):
            onnx_export.export_unet(models["attention"][2], path, opset=opset)
    assert not os.path.exists(path)


def test_failed_verify_leaves_no_artifact(models, tmp_path):
    path = str(tmp_path / "bad.onnx")
    with pytest.raises(AssertionError, match="mismatch"):
        onnx_export.export_unet(models["attention"][2], path, verify_tol=-1.0)
    assert not os.path.exists(path) and not os.path.exists(path + ".tmp")


def test_large_graph_verifies_via_small_export(models, tmp_path):
    path = str(tmp_path / "big.onnx")
    entry = onnx_export.export_unet(models["mobile"][2], path, image_size=256)
    assert entry["verified_at"] == 64 and entry["verified"]
    x_dims = P.load_model(path).graph.input[0].type.tensor_type.shape.dim
    assert [d.dim_value for d in x_dims[1:]] == [2, 256, 256]
    assert not os.path.exists(path + ".verify.tmp")


def test_learned_conv_resampling_raises_in_the_exporter(models):
    with pytest.raises(NotImplementedError, match="resample_type"):
        onnx_export.build_unet_graph(models["conv_resample"][2])


# --- torch.export and the commands -------------------------------------------

# a decoder whose 128x128 blocks take the fused-block kernel, with the in and
# out convs on the conv kernel and the midblock's 32x32 attention on the
# attention kernel
DECODER = dict(image_size=128, in_channels=5, out_channels=1, model_channels=8,
               model_channel_mults=(1, 1, 2), layers_per_block=1, attn_resolutions=(),
               midblock_attention=True, concat_balance=0.5, noise_emb_dims=8,
               fourier_scale="pos", logvar_channels=8,
               block_kwargs={"channels_per_head": 8, "attention_impl": "pallas"})
PIPELINE = {
    "coarse_model": dict(image_size=16, in_channels=11, out_channels=6, model_channels=8,
                         model_channel_mults=(1,), layers_per_block=1, attn_resolutions=(),
                         midblock_attention=False, concat_balance=0.5,
                         conditional_inputs=tuple(("float", 8, 0.2) for _ in range(5)),
                         fourier_scale="pos", noise_emb_dims=8, logvar_channels=8),
    "base_model": dict(image_size=64, in_channels=5, out_channels=5, model_channels=8,
                       model_channel_mults=(1, 2), layers_per_block=1, attn_resolutions=(),
                       midblock_attention=False, concat_balance=0.5,
                       conditional_inputs=(("tensor", 58, 1.0),), fourier_scale="pos",
                       noise_emb_dims=8, logvar_channels=8),
    "decoder_model": DECODER,
}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A tiny pipeline saved in the reference layout, then ``export`` and
    ``onnx-export`` through the group on the CPU: (pipeline dir, export
    dir, onnx dir, export manifest, onnx manifest).  Both run with
    ``--no-verify``: the tests load every file back themselves (the ONNX
    verify runs in ``test_onnx_file_equals_jax_byte_for_byte``)."""
    root = tmp_path_factory.mktemp("export")
    pipe = str(root / "pipeline")
    for i, (name, cfg) in enumerate(PIPELINE.items()):
        save_model(_port(cfg, 100 + 10 * i), os.path.join(pipe, name))
    out_pt2, out_onnx = str(root / "pt2"), str(root / "onnx")
    pt2 = CliRunner().invoke(port_main.cli, ["export", pipe, out_pt2, "--decoder-tile", "128",
                                             "--device", "cpu", "--no-verify"])
    assert pt2.exit_code == 0, pt2.output
    onnx = CliRunner().invoke(port_main.cli, ["onnx-export", pipe, "-o", out_onnx,
                                              "--device", "cpu", "--no-verify"])
    assert onnx.exit_code == 0, onnx.output
    with open(os.path.join(out_pt2, "manifest.json")) as f:
        m_pt2 = json.load(f)
    with open(os.path.join(out_onnx, "manifest.json")) as f:
        m_onnx = json.load(f)
    return pipe, out_pt2, out_onnx, m_pt2, m_onnx


@pytest.fixture(scope="module")
def programs(exported):
    """name -> (the loaded program, the eager model it was exported from)."""
    pipe, out, *_ = exported
    return {name: (torch.export.load(os.path.join(out, f"{name}.pt2")),
                   load_model(os.path.join(pipe, name), device="cpu"))
            for name in PIPELINE}


def test_export_command_writes_programs_that_load_back(exported, programs):
    _pipe, out, _onnx, manifest, _ = exported
    assert list(manifest) == ["coarse_model", "base_model", "decoder_model"]
    want_inputs = {"coarse_model": [[1, 64, 64, 11]] + [[1]] * 6,
                   "base_model": [[1, 64, 64, 5], [1], [1, 58]],
                   "decoder_model": [[1, 128, 128, 5], [1]]}
    assert sorted(os.listdir(out)) == ["base_model.pt2", "coarse_model.pt2",
                                       "decoder_model.pt2", "manifest.json"]
    rng = np.random.default_rng(4)
    for name, entry in manifest.items():
        assert entry["path"] == f"{name}.pt2" and "verified" not in entry
        assert entry["inputs"] == want_inputs[name]
        assert entry["bytes"] == os.path.getsize(os.path.join(out, entry["path"]))
        # the same operators run: the loaded program equals eager bit for bit
        program, model = programs[name]
        args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                for s in entry["inputs"]]
        with torch.no_grad():
            got = program.module()(*args)
            want = torch_export.UNetForward(model)(*args)
        assert torch.equal(got, want), name


def test_onnx_export_command_writes_files_that_load_back(exported):
    _pipe, _pt2, out, _, manifest = exported
    assert list(manifest) == ["coarse_model", "base_model", "decoder_model"]
    for name, entry in manifest.items():
        assert entry["path"] == f"{name}.onnx" and entry["opset"] == 17
        proto = P.load_model(os.path.join(out, entry["path"]))
        assert [vi.name for vi in proto.graph.input] == entry["inputs"]
        assert entry["bytes"] == os.path.getsize(os.path.join(out, entry["path"]))
        # coarse and base export at the pipeline's 64-px tiles, the decoder
        # at its own size
        dims = proto.graph.input[0].type.tensor_type.shape.dim
        assert dims[2].dim_value == (64 if name != "decoder_model" else 128)


def test_exported_decoder_carries_the_kernels(programs):
    """The loaded decoder program holds the three registered operators, runs
    bit-equal to eager and within 1e-4 of the JAX forward."""
    program, decoder = programs["decoder_model"]
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    model = torch_export.UNetForward(decoder)
    # the blocks whose output map is 128 x 128 (the level's name), none below
    assert 128 * 128 >= FUSED_MIN_PIXELS > 64 * 64
    n_fused = sum(name.startswith("128x128") for name, kind, *_ in
                  decoder.enc_plan + decoder.dec_plan if kind == "block")
    assert targets.count("tdt.fused_block.default") == n_fused > 0
    assert targets.count("tdt.conv3x3.default") == 2
    assert targets.count("tdt.pixelnorm_attention.default") == 1
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 128, 128, 5)).astype(np.float32)
    noise = rng.standard_normal((1,)).astype(np.float32)
    with torch.no_grad():
        got = program.module()(torch.from_numpy(x), torch.from_numpy(noise))
        want = model(torch.from_numpy(x), torch.from_numpy(noise))
    assert torch.equal(got, want)
    tree = params_to_jax(decoder)
    ref = _jax_forward(JaxUNet(JaxConfig(**DECODER)), tree, x, noise, [])
    rel = _rel(got.numpy(), ref)
    print(f"loaded decoder program vs JAX max|diff|/max|ref| = {rel:.3e}")
    assert rel < UNET_TOL


def test_wrappers_reach_the_kernels_through_the_operators():
    """One route: each wrapper calls its tdt operator, whose CPU
    implementation is the plain version and whose Meta implementation
    gives the output's shape and type."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 8, 8, 4), generator=g)
    w = torch.randn((3, 3, 4, 6), generator=g) * 0.1
    w0, w1 = (torch.randn((3, 3, 6, 6), generator=g) * 0.1 for _ in range(2))
    wskip = torch.randn((4, 6), generator=g) * 0.1
    qkv = torch.randn((2, 4, 4, 48), generator=g)
    block = dict(mode="enc", clip_act=None)
    cases = [  # (wrapper call, operator, its arguments, plain version)
        (lambda: fb.conv3x3(x, w), torch.ops.tdt.conv3x3.default, (x, w),
         fb.conv3x3_reference(x, w)),
        (lambda: fb.fused_block(x, w0, w1, None, wskip, **block),
         torch.ops.tdt.fused_block.default,
         (x, w0, w1, None, wskip, None, "enc", True, 0.3, None, None, 1),
         fb.fused_block_reference(x, w0, w1, None, wskip, **block)),
        (lambda: attn.fused_pixelnorm_attention(qkv, 2),
         torch.ops.tdt.pixelnorm_attention.default, (qkv, 2, 1e-4),
         attn.pixelnorm_attention_reference(qkv, 2)),
    ]
    for call, op, op_args, plain in cases:
        got = call()
        assert torch.equal(got, op(*op_args)) and torch.equal(got, plain)
        meta = op(*[a.to("meta") if isinstance(a, torch.Tensor) else a for a in op_args])
        assert meta.shape == got.shape and meta.dtype == got.dtype


@pytest.mark.parametrize("command", ["export", "onnx-export"])
def test_commands_default_to_the_card(command, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    args = [command, str(tmp_path), str(tmp_path / "out")] if command == "export" else \
        [command, str(tmp_path), "-o", str(tmp_path / "out")]
    result = CliRunner().invoke(port_main.cli, args)
    assert result.exit_code != 0 and "--device cpu" in result.output
