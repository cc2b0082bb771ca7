"""Port parity, the rest of the weight wire: raw e4m3 mode, per-tensor-
type codecs (``type_key_fn``), the serving manifest and the
chunk-sharded open, against the JAX reference.

Both packages wire the same numpy-seeded f32 leaves under the same
codecs (the reference's registry loaded from the port's JSON, so the
scheme-ids agree). The
reference runs its pure codec (``use_kernels=False``); the port runs
K1/K2's plain versions on the CPU. Every comparison is exact: words,
codes and bf16 scale bits, manifests as JSON, and opened values bit for
bit, in both directions between the packages and on 4 gloo ranks.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import weights as jweights
from repro.core import CodecRegistry as JRegistry
from repro.serving import codec_from_manifest as j_codec_from_manifest
from repro.serving import open_params as j_open
from repro.serving import serving_manifest as j_manifest
from repro.serving.kv_cache import KVCacheSpec as JKVCacheSpec
from repro_torch.comm import weights as tweights
from repro_torch.comm.calibrate import histogram_of_quantized
from repro_torch.convert import wire_from_numpy, wire_to_numpy
from repro_torch.core import CodecRegistry
from repro_torch.launch.mesh import data_parallel, make_test_mesh, use_mesh
from repro_torch.serving import (KVCacheSpec, codec_from_manifest,
                                 open_params, serving_manifest)
from tests.torch_dist import assert_same_tree, flat_tree, run_ranks
from tests.torch_dist import one_cpu_thread

one_cpu_thread()

TYPES = ("ffn1", "ffn2", "kv/layer0")


def _type_key(path: str) -> str:
    return path.split("/")[-1]


def _registries():
    """The same three codecs in both packages, the reference's loaded
    from the port's JSON (so the scheme-ids agree): the two weight types
    calibrated on their own leaves, a KV layer's on a third sample."""
    leaves = _leaves()
    kv = np.random.default_rng(9).standard_normal(1 << 14).astype(np.float32)
    tr = CodecRegistry()
    for name, x in zip(TYPES, (leaves["a"]["ffn1"], leaves["b"]["ffn2"], kv)):
        tr.register(name, np.maximum(
            histogram_of_quantized(torch.from_numpy(x)), 1.0))
    return JRegistry.from_json_dict(tr.to_json_dict()), tr


def _leaves(seed: int = 0, padded: bool = True):
    """Numpy leaves: an ffn1 leaf of whole chunks, a sparse ffn2 leaf
    (75000 symbols a group, so its last chunk is padded, or 64 whole
    chunks with ``padded=False``), and a norm too small for the wire."""
    rng = np.random.default_rng(seed)
    w2 = rng.standard_normal((2, 300, 250) if padded else (2, 512, 128))
    w2[rng.random(w2.shape) < 0.6] = 0.0
    return {"a": {"ffn1": rng.standard_normal((2, 256, 256))
                  .astype(np.float32)},
            "b": {"ffn2": w2.astype(np.float32)},
            "norm": np.ones((2, 64), np.float32)}


@functools.lru_cache(maxsize=None)
def _wire(mode: str):
    """(reference wire, its codec, port wire, its codec) of
    :func:`_leaves`; callers replace a codec's fields, never set them."""
    jr, tr = _registries()
    leaves = _leaves()
    jw, jwc = jweights.compress_groups(
        jax.tree.map(jnp.asarray, leaves), jr, mode=mode,
        type_key_fn=_type_key)
    tw, twc = tweights.compress_groups(
        _torch(leaves), tr, mode=mode,
        type_key_fn=_type_key)
    return jw, jwc, tw, twc


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("mode", ["qlc", "e4m3"])
def test_compress_groups_modes_and_type_keys_match_reference(mode):
    """Words (qlc) or codes (e4m3), bf16 scales and the per-leaf meta
    equal the reference's, each leaf on the codec its type names; the
    opened values are the reference's and the same in both modes."""
    jw, jwc, tw, twc = _wire(mode)
    assert_same_tree(jw, tw)
    assert sorted(jwc.meta) == sorted(twc.meta) == ["a/ffn1", "b/ffn2"]
    for key, jm in jwc.meta.items():
        tm = twc.meta[key]
        assert (tm.group_shape, tm.n_symbols, tm.n_chunks,
                tm.capacity_words, tm.mode, tm.scheme_id) == \
            (tuple(jm.group_shape), jm.n_symbols, jm.n_chunks,
             jm.capacity_words, jm.mode, jm.scheme_id), key
    assert twc.meta["a/ffn1"].scheme_id != twc.meta["b/ffn2"].scheme_id
    assert twc.meta["b/ffn2"].scheme_id == twc.registry["ffn2"].scheme_id
    opened = open_params(tw, twc)
    assert_same_tree(j_open(jw, jwc), opened)
    _, _, tq, tqc = _wire("qlc")
    assert_same_tree(open_params(tq, tqc), opened)


@pytest.mark.parametrize("with_kv", [False, True], ids=["wire", "wire+kv"])
def test_serving_manifest_round_trips_between_packages(with_kv):
    """Either package's manifest equals the other's as JSON and opens
    the other's wire (carried by ``convert``) bit for bit, with and
    without the KV cache's recipe."""
    jw, jwc, tw, twc = _wire("qlc")
    jwc, twc = (dataclasses.replace(wc, transport="ring", axis="data")
                for wc in (jwc, twc))
    jkw = {"kv_spec": JKVCacheSpec(block_tokens=16)} if with_kv else {}
    tkw = {"kv_spec": KVCacheSpec(block_tokens=16)} if with_kv else {}
    jm = json.loads(json.dumps(j_manifest(jwc, **jkw)))
    tm = json.loads(json.dumps(serving_manifest(twc, **tkw)))
    assert tm == jm
    if with_kv:
        assert tm["kv"]["scheme_ids"] == \
            {"kv/layer0": twc.registry["kv/layer0"].scheme_id}
    want = open_params(tw, twc)
    # reference -> port: its wire and manifest, opened by the port
    pw, pwc = wire_from_numpy(jax.tree.map(np.asarray, jw), jm,
                              device="cpu")
    assert_same_tree(tw, pw)
    assert (pwc.transport, pwc.axis, pwc.use_kernels) == \
        ("ring", "data", False)
    assert_same_tree(want, open_params(pw, pwc))
    # port -> reference: the port's wire and manifest, opened there
    rw, rm = wire_to_numpy(tw, twc)
    assert_same_tree(jax.tree.map(np.asarray, jw), rw)
    assert_same_tree(want, j_open(rw, j_codec_from_manifest(rm)))


def test_manifest_channel_placement():
    """The channel placement in the manifest (the reference's
    ``tests/test_channel.py`` case): transport, axis and kernel toggle
    round-trip, an explicit toggle wins, a manifest without placement
    gets the historic default, an axis-bound channel defaults to ring and
    a local one binds no group."""
    _, _, tw, twc = _wire("qlc")
    twc = dataclasses.replace(twc, use_kernels=True, transport="ring",
                              axis="data")
    m = serving_manifest(twc)
    assert m["channel"] == {"transport": "ring", "axis": "data",
                            "use_kernels": True}
    wc2 = codec_from_manifest(m)
    assert (wc2.transport, wc2.axis, wc2.use_kernels) == \
        ("ring", "data", True)
    assert not codec_from_manifest(m, use_kernels=False).use_kernels
    legacy = {k: v for k, v in m.items() if k != "channel"}
    wc3 = codec_from_manifest(legacy)
    assert wc3.use_kernels and wc3.transport is None
    assert wc3.channel().axis is None and wc3.channel().group is None
    with data_parallel("cpu") as world:
        with use_mesh(make_test_mesh(model=1)):
            ch = wc3.channel(axis_name="data", axis_size=1)
            with pytest.raises(ValueError, match="axis_size"):
                wc3.channel(axis_name="data", axis_size=8)
        assert ch.group is world and ch.transport.kind == "ring"
        # a channel on a group of one opens like the whole wire
        assert_same_tree(open_params(tw, twc), open_params(tw, wc3, channel=ch))
    with pytest.raises(ValueError, match="process group"):
        twc.open_group_sharded(tw)
    with pytest.raises(ValueError, match="wire mode"):
        tweights.compress_groups({"w": torch.zeros(2, 1 << 16)},
                                 twc.registry, mode="fp8")


@pytest.mark.parametrize("mode", ["qlc", "e4m3"])
def test_wire_shape_structs_match_reference(mode):
    jr, tr = _registries()
    leaves = _leaves()
    jw, jwc = jweights.wire_shape_structs(
        jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                     leaves), jr, 200, mode=mode, type_key_fn=_type_key)
    tw, twc = tweights.wire_shape_structs(
        _torch(leaves), tr, 200, mode=mode,
        type_key_fn=_type_key)
    dtypes = {"uint32": torch.int32, "uint8": torch.uint8,
              "bfloat16": torch.bfloat16, "float32": torch.float32}
    fj, ft = flat_tree(jw), flat_tree(tw)
    assert sorted(fj) == sorted(ft)
    for key, s in fj.items():
        t = ft[key]
        assert tuple(t.shape) == tuple(s.shape), key
        assert t.dtype == dtypes[str(s.dtype)], key
        if isinstance(t, torch.Tensor) and key.count("/") > 1:
            assert t.device.type == "meta", key
    assert {k: (m.n_chunks, m.capacity_words, m.mode, m.scheme_id)
            for k, m in twc.meta.items()} == \
        {k: (m.n_chunks, m.capacity_words, m.mode, m.scheme_id)
         for k, m in jwc.meta.items()}


def test_open_group_sharded_on_gloo_ranks():
    """Each of 4 gloo ranks holds a quarter of every leaf's chunks and
    opens the whole tree: ring (one and two pieces a hop), one-shot and
    the codec's own channel (ring, and the "auto" policy), in qlc and
    e4m3 mode, all bit-equal to the whole open."""
    variants = ["ring", "ring x2", "oneshot", "channel", "channel auto"]
    _, tr = _registries()
    wires, want = [], []
    for mode in ("qlc", "e4m3"):
        tw, twc = tweights.compress_groups(_torch(_leaves(padded=False)), tr,
                                           mode=mode, type_key_fn=_type_key)
        wires.append((tw, serving_manifest(twc)))
        want.append(open_params(tw, twc))
    for res in run_ranks("wire_sharded", 4, wires=wires, variants=variants):
        for w, opened in zip(want, res):
            for v in variants:
                assert_same_tree(w, opened[v])
