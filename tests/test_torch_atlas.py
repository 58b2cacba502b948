"""The port's device tile atlas and its runtime against the JAX package's,
on the CPU.

The same operation sequences, window functions and inputs (numpy, from a
seed) go through ``terrain_diffusion_tpu.runtime.infinite_tensor`` and
``terrain_diffusion_tpu_torch.runtime.infinite_tensor``.  Bars: slot
assignments, LRU order, atlas rows, geometry arrays and assembled regions
bit-equal (the port adds the same float32 tiles in the same order as JAX);
window outputs read through either package bit-equal.
"""
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terrain_diffusion_tpu.runtime import InfiniteTensor as JaxInfiniteTensor
from terrain_diffusion_tpu.runtime import TensorWindow as JaxTensorWindow
from terrain_diffusion_tpu.runtime import infinite_tensor as jit_mod

from terrain_diffusion_tpu_torch.ops.noise_field import gaussian_noise_patch
from terrain_diffusion_tpu_torch.ops.windows import linear_weight_window
from terrain_diffusion_tpu_torch.runtime import infinite_tensor as it_mod
from terrain_diffusion_tpu_torch.runtime.infinite_tensor import (DeviceTileAtlas, InfiniteTensor,
                                                                 ensure_regions_multi)
from terrain_diffusion_tpu_torch.runtime.tile_store import MemoryTileStore
from terrain_diffusion_tpu_torch.runtime.window import TensorWindow


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread while this module runs: six pytest-xdist
    workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- DeviceTileAtlas -----------------------------------------------------------

def _lru(atlas):
    return list(atlas._slots.items())


def test_atlas_slots_and_lru_order_match_jax(rng):
    """reserve / put_batch / slot / grow_to / clear in one sequence: equal
    slot assignments, LRU order and rows at every step."""
    port, ref = DeviceTileAtlas(4, device="cpu"), jit_mod.DeviceTileAtlas(4)
    rows = rng.standard_normal((12, 2, 3, 3)).astype(np.float32)
    idx = [(0, k, -k) for k in range(12)]
    steps = [("put", idx[0:3], rows[0:3]), ("slot", idx[1]), ("put", idx[3:5], rows[3:5]),
             ("reserve", idx[5:6]), ("slot", idx[0]), ("put", idx[6:8], rows[6:8]),
             ("grow", 10), ("put", idx[8:12], rows[8:12]), ("slot", idx[9]),
             ("put", idx[2:4], rows[2:4] + 1), ("clear",), ("put", idx[4:7], rows[4:7])]
    for step in steps:
        op = step[0]
        if op == "put":
            port.put_batch(step[1], torch.from_numpy(step[2]))
            ref.put_batch(step[1], jnp.asarray(step[2]))
        elif op == "slot":
            assert port.slot(step[1]) == ref.slot(step[1])
        elif op == "reserve":
            np.testing.assert_array_equal(port.reserve(step[1], (2, 3, 3)),
                                          ref.reserve(step[1], (2, 3, 3)))
        elif op == "grow":
            assert port.grow_to(step[1]) == ref.grow_to(step[1]) == 16
        else:
            port.clear()
            ref.clear()
        assert _lru(port) == _lru(ref), step
        assert len(port) == len(ref)
        live = [st for _, st in _lru(port) if port._atlas is not None]
        if live and op != "reserve":  # a reserved slot holds no row yet
            np.testing.assert_array_equal(port.fetch_rows(live).numpy(), ref.fetch_rows(live))
    assert port._atlas.dtype == torch.float32 and port._atlas.device.type == "cpu"


def test_atlas_rows_survive_growth_and_the_budget_caps_it():
    """The JAX test's sequence (tests/test_infinite_tensor.py, the grow_to
    test): rows written before growth stay addressable, new slots are
    usable, and max_bytes caps growth below a power of two."""
    rows = np.arange(4 * 2 * 3 * 3, dtype=np.float32).reshape(4, 2, 3, 3)
    out = {}
    for name, cls, wrap in (("port", DeviceTileAtlas, torch.from_numpy),
                            ("jax", jit_mod.DeviceTileAtlas, jnp.asarray)):
        at = cls(4)
        at.put_batch([(0, 0, k) for k in range(4)], wrap(rows))
        assert at.grow_to(10) == 16 and at.capacity == 16
        got = np.asarray(at.fetch_rows([at.slot((0, 0, k)) for k in range(4)]))
        np.testing.assert_array_equal(got, rows)
        at.put_batch([(1, 0, 0)], wrap(rows[:1] + 100))
        np.testing.assert_array_equal(np.asarray(at.fetch_rows([at.slot((1, 0, 0))]))[0],
                                      rows[0] + 100)
        small = cls(2, max_bytes=72 * 5)  # a row is 2*3*3*4 = 72 bytes
        small.put_batch([(0, 0, 0)], wrap(rows[:1]))
        assert small.grow_to(100) == 5
        assert cls(2, max_bytes=72 * 5).grow_to(100, (2, 3, 3)) == 5  # before the pool exists
        out[name] = (_lru(at), _lru(small))
    assert out["port"] == out["jax"]


def test_atlas_put_batch_writes_only_the_real_rows():
    """Bucket padding rows past len(idxs) are not written."""
    at = DeviceTileAtlas(3, device="cpu")
    batch = torch.arange(5 * 2, dtype=torch.float32).reshape(5, 2, 1, 1)
    at.put_batch([(0, 0, 0), (0, 0, 1)], batch)  # 3 padding rows
    assert len(at) == 2
    np.testing.assert_array_equal(at.fetch_rows([0, 1]).numpy(), batch[:2].numpy())
    np.testing.assert_array_equal(at._atlas[2].numpy(), np.zeros((2, 1, 1), np.float32))


# --- assemble_from_atlas and the geometry -------------------------------------

@pytest.mark.parametrize("case", [
    # (atlas rows, channels, tile, region, K, batch)
    (9, 3, (8, 8), (11, 13), 6, 3),
    (16, 7, (4, 4), (4, 4), 16, 2),
    (5, 2, (16, 12), (7, 30), 4, 4),
], ids=["partial", "coarse-like", "wide"])
def test_assemble_from_atlas_bit_equal_jax(rng, case):
    """Random atlases, invalid entries, partial overlaps and offsets from
    -(tile - 1) to the far edge: the port's regions equal JAX's bit for bit."""
    n, c, (th, tw), (rh, rw), K, B = case
    atlas = (rng.standard_normal((n, c, th, tw)) * 10).astype(np.float32)
    slots = rng.integers(0, n, (B, K)).astype(np.int32)
    offs = np.stack([rng.integers(-th + 1, rh, (B, K)), rng.integers(-tw + 1, rw, (B, K))],
                    axis=-1).astype(np.int32)
    valid = (rng.random((B, K)) < 0.7).astype(np.float32)
    got = it_mod.assemble_from_atlas(torch.from_numpy(atlas), slots, offs, valid, (c, rh, rw))
    want = jit_mod.assemble_from_atlas(jnp.asarray(atlas), jnp.asarray(slots),
                                       jnp.asarray(offs), jnp.asarray(valid), (c, rh, rw))
    assert got.shape == (B, c, rh, rw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _windows():
    return [((7, 4, 4), (7, 1, 1), (0, -1, -1)), ((6, 64, 64), (6, 32, 32), None),
            ((2, 64, 64), (2, 48, 48), None)]


@pytest.mark.parametrize("win", _windows(), ids=["coarse", "latent", "decoder"])
def test_static_k_and_traced_geometry_equal_jax(rng, win):
    size, stride, offset = win
    pw, jw = TensorWindow(size, stride, offset), JaxTensorWindow(size, stride, offset)
    c = size[0]
    boxes = []
    for _ in range(3):
        y, x = (int(v) for v in rng.integers(-200, 200, 2))
        boxes.append(((0, c), (y, y + 37), (x, x + 21)))
    for box in boxes:
        assert it_mod._static_k(pw, box) == jit_mod._static_k(jw, box)
    slots = {}

    def slot_of(idx):  # deterministic slots for every window
        return slots.setdefault(tuple(idx), len(slots) % 97)

    got = it_mod._traced_geometry(pw, boxes, slot_of)
    slots.clear()
    want = jit_mod._traced_geometry(jw, boxes, slot_of)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # a window without a slot, and partial channel coverage, give None
    assert it_mod._traced_geometry(pw, boxes, lambda idx: None) is None
    part = [((0, c - 1),) + boxes[0][1:]]
    assert it_mod._traced_geometry(pw, part, slot_of) is None
    assert jit_mod._traced_geometry(jw, part, slot_of) is None


# --- the runtime -----------------------------------------------------------------

TILE, STRIDE = 16, 8


def _leaf_rows(ctxs, seed, ch):
    """Weighted noise windows plus the weight channel, (B, ch + 1, T, T)."""
    vals = np.stack([gaussian_noise_patch(seed, int(c[1]) * STRIDE, int(c[2]) * STRIDE,
                                          TILE, TILE, channels=ch, tile_h=TILE, tile_w=TILE)
                     for c in ctxs])
    w = linear_weight_window(TILE)
    return np.concatenate([vals * w[None, None], np.broadcast_to(w, (len(ctxs), 1, TILE, TILE))],
                          axis=1).astype(np.float32)


def _child_rows(regions):
    """A child window from its parent region: the normalized values halved."""
    vals = (regions[:, :2] / regions[:, 2:3]) * np.float32(0.5)
    w = linear_weight_window(TILE)
    return np.concatenate([vals * w[None, None], np.broadcast_to(w, (len(regions), 1, TILE, TILE))],
                          axis=1).astype(np.float32)


def _win(ch, pkg="port"):
    cls = TensorWindow if pkg == "port" else JaxTensorWindow
    return cls((ch + 1, TILE, TILE), (ch + 1, STRIDE, STRIDE))


def _port_chain(cap, defer, store=None, leaf_only=False, seed=9):
    store = store if store is not None else MemoryTileStore()
    kw = dict(batch_buckets=(1, 2, 4), tile_store=store, device="cpu",
              device_cache_tiles=cap, defer_host=defer)
    leaf = InfiniteTensor(lambda ctxs: torch.from_numpy(_leaf_rows(ctxs, seed, 2)), _win(2),
                          tensor_id="leaf", shape=(3, None, None), **kw)
    if leaf_only:
        return leaf, None
    child = InfiniteTensor(lambda ctxs, r: torch.from_numpy(_child_rows(r.numpy())), _win(2),
                           args=(leaf,), args_windows=(_win(2),), tensor_id="child",
                           shape=(3, None, None), **kw)
    return leaf, child


def _jax_chain(cap, defer, seed=9):
    kw = dict(batch_size=4, vectorized=True, batch_buckets=(1, 2, 4), device_cache_tiles=cap,
              defer_host=defer)
    leaf = JaxInfiniteTensor((3, None, None), lambda ctxs: jnp.asarray(_leaf_rows(ctxs, seed, 2)),
                             _win(2, "jax"), **kw)
    child = JaxInfiniteTensor((3, None, None),
                              lambda ctxs, r: jnp.asarray(_child_rows(np.asarray(r))),
                              _win(2, "jax"), args=(leaf,), args_windows=(_win(2, "jax"),), **kw)
    return leaf, child


@pytest.mark.parametrize("cap", [64, 1], ids=["resident", "evicting"])
def test_read_device_matches_read_and_jax(cap):
    """read_device assembles from the pool and equals read() bit for bit;
    with a one-slot pool the misses go through the store.  Both equal
    JAX's read_device."""
    leaf, _ = _port_chain(cap, defer=False, leaf_only=True, seed=5)
    ranges = [(0, 3), (-10, 30), (-10, 30)]
    host = leaf[:, -10:30, -10:30]
    assert len(leaf.device_cache) > 0
    with torch.no_grad():
        dev = leaf.read_device(ranges).numpy()
    np.testing.assert_array_equal(dev, host)
    jleaf, _ = _jax_chain(cap, defer=False, seed=5)
    np.testing.assert_array_equal(dev, np.asarray(jleaf.read_device(ranges)))
    leaf.clear_cache()
    assert len(leaf.device_cache) == 0 and len(leaf.tile_store._data) == 0


def test_deferred_host_chain_feeds_the_child_from_the_pool():
    """defer_host: the child takes its parent regions from the leaf's pool
    (no store read of a leaf window), the leaf's windows reach the store
    only when a host read gathers them, and every output equals the eager
    chain's and JAX's deferred chain's."""
    store = MemoryTileStore()
    leaf, child = _port_chain(64, defer=True, store=store)
    with mock.patch.object(InfiniteTensor, "_assemble", autospec=True,
                           side_effect=InfiniteTensor._assemble) as spy:
        out_d = child[:, -5:30, -5:30]
    assert [c.args[0].tensor_id for c in spy.call_args_list] == ["child"]
    assert not any(k[0] == "leaf" for k in store._data)
    leaf_host = leaf[:, 0:20, 0:20]
    assert any(k[0] == "leaf" for k in store._data)  # gathered by the host read
    _, child_e = _port_chain(64, defer=False)
    np.testing.assert_array_equal(out_d, child_e[:, -5:30, -5:30])
    jleaf, jchild = _jax_chain(64, defer=True)
    np.testing.assert_array_equal(out_d, jchild[:, -5:30, -5:30])
    np.testing.assert_array_equal(leaf_host, jleaf[:, 0:20, 0:20])


def test_plan_grows_the_atlas_instead_of_thrashing():
    """A plan whose working set exceeds the configured capacity grows each
    pool (never one-window evaluations), and its outputs equal a roomy
    chain's and JAX's."""
    calls = []
    orig = InfiniteTensor._evaluate_chunk

    def patched(self, chunk):
        calls.append(len(chunk))
        return orig(self, chunk)

    leaf, child = _port_chain(4, defer=True)
    region = [(0, 3), (0, 200), (0, 200)]
    with mock.patch.object(InfiniteTensor, "_evaluate_chunk", patched):
        with torch.no_grad():
            child.ensure_regions([region])
    assert calls and 1 not in calls, calls
    assert leaf.device_cache.capacity > 4
    got = child[:, 0:200, 0:200]
    _, roomy = _port_chain(2048, defer=True)
    np.testing.assert_array_equal(got, roomy[:, 0:200, 0:200])
    jleaf, jchild = _jax_chain(4, defer=True)
    jchild.ensure_regions([region])
    assert jleaf.device_cache.capacity == leaf.device_cache.capacity
    np.testing.assert_array_equal(got, jchild[:, 0:200, 0:200])


def test_fused_evaluation_writes_the_pool_in_one_call():
    """A child with f_fused: once its parent windows are resident, each
    chunk runs as one f_fused call (no staged call) writing into the
    child's pool; the outputs equal the staged chain's bit for bit."""
    calls = {"f": 0, "fused": 0}

    def fused(ctxs, out_atlas, out_slots, arg_views):
        calls["fused"] += 1
        regions = it_mod.assemble_from_atlas(*arg_views[0], (3, TILE, TILE))
        out = torch.from_numpy(_child_rows(regions.numpy()))
        out_atlas.index_copy_(0, torch.as_tensor(out_slots), out[:len(out_slots)])

    def staged(ctxs, r):
        calls["f"] += 1
        return torch.from_numpy(_child_rows(r.numpy()))

    store = MemoryTileStore()
    leaf, _ = _port_chain(64, defer=True, store=store, leaf_only=True)
    child = InfiniteTensor(staged, _win(2), args=(leaf,), args_windows=(_win(2),),
                           batch_buckets=(1, 2, 4), tile_store=store, tensor_id="child",
                           device="cpu", shape=(3, None, None), device_cache_tiles=64,
                           defer_host=True, f_fused=fused)
    got = child[:, -5:30, -5:30]
    assert calls["fused"] > 0 and calls["f"] == 0
    _, child_e = _port_chain(64, defer=False)
    np.testing.assert_array_equal(got, child_e[:, -5:30, -5:30])
    # f_fused needs defer_host, and defer_host a device cache
    plain = InfiniteTensor(staged, _win(2), tile_store=MemoryTileStore(), tensor_id="t",
                           device="cpu", device_cache_tiles=0, defer_host=True, f_fused=fused)
    assert plain.device_cache is None and not plain.defer_host and plain.f_fused is None
    eager = InfiniteTensor(staged, _win(2), tile_store=MemoryTileStore(), tensor_id="t",
                           device="cpu", device_cache_tiles=8, f_fused=fused)
    assert eager.f_fused is None


def test_ensure_regions_multi_merges_roots():
    """A plan over two roots evaluates the parent in one pass covering
    both, where per-root plans take two; outputs are equal either way, and
    equal JAX's."""
    def build():
        return _port_chain(0, defer=False)

    def spy(tensor, log):
        orig = tensor._evaluate_windows
        tensor._evaluate_windows = lambda idxs: (log.append(list(idxs)), orig(idxs))[1]

    child_box = [(0, 3), (0, 32), (0, 32)]
    parent_box = [(0, 3), (0, 96), (0, 96)]
    p1, c1 = build()
    seq = []
    spy(p1, seq)
    with torch.no_grad():
        c1.ensure_regions([child_box])
        p1.ensure_regions([parent_box])
    assert len(seq) == 2 and seq[1]
    p2, c2 = build()
    multi = []
    spy(p2, multi)
    with torch.no_grad():
        ensure_regions_multi([(c2, [child_box]), (p2, [parent_box])])
    assert len(multi) == 1
    assert sorted(multi[0]) == sorted(set(seq[0]) | set(seq[1]))
    np.testing.assert_array_equal(c1[:, 0:32, 0:32], c2[:, 0:32, 0:32])
    np.testing.assert_array_equal(p1[:, 0:96, 0:96], p2[:, 0:96, 0:96])
    jp, jc = _jax_chain(0, defer=False)
    jit_mod.ensure_regions_multi([(jc, [child_box]), (jp, [parent_box])])
    np.testing.assert_array_equal(c2[:, 0:32, 0:32], jc[:, 0:32, 0:32])
    np.testing.assert_array_equal(p2[:, 0:96, 0:96], jp[:, 0:96, 0:96])
