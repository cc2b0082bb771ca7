"""Port parity, checkpoints: ``repro_torch.checkpoint.CheckpointManager``
against ``repro.checkpoint.CheckpointManager`` on the same numpy leaves.

A checkpoint written by either package restores in the other bit for
bit, the two write byte-identical leaf files, manifests and registries,
and decide raw-or-QLC alike; corruption, missing leaves, shape
mismatches, the opt-out, garbage collection, the ``latest`` pointer, a
crash mid-save and the pre-container ``"counts"`` layout behave as the
reference's. The port's ``Trainer`` resumes bit-exact from its own
checkpoints on one gloo rank, compressed and baseline, and two ranks
write and resume one checkpoint. Every comparison is exact.
"""
import concurrent.futures
import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.core import distributions
from repro_torch.checkpoint import CheckpointManager as TManager
from repro_torch.checkpoint.manager import flatten_with_paths
from tests.torch_dist import one_cpu_thread

one_cpu_thread()

STEP_DIR = "step_0000000001"


def _leaves_np(seed: int = 0):
    """The same leaves as numpy: u8 symbols (one QLC'd, one small and
    raw), f32, bf16 and fp8 bit patterns, an int32 scalar."""
    rng = np.random.default_rng(seed)
    bf = (rng.standard_normal(24).astype(np.float32).view(np.uint32)
          >> 16).astype(np.uint16)
    return {
        "codes": distributions.ffn1_symbols(1 << 16, seed=3).reshape(64,
                                                                     1024),
        "small": rng.integers(0, 256, 100, dtype=np.uint8),
        "w": rng.standard_normal((8, 8)).astype(np.float32),
        "bf16": bf,
        "fp8": distributions.ffn1_symbols(1 << 14, seed=4),
        "step": np.int32(7),
    }


def _jax_tree(a):
    return {"params": {"codes": jnp.asarray(a["codes"]),
                       "w": jnp.asarray(a["w"]),
                       "b": jnp.asarray(a["bf16"].view(ml_dtypes.bfloat16))},
            "opt": ({"small": jnp.asarray(a["small"]),
                     "step": jnp.asarray(a["step"])},
                    jnp.asarray(a["fp8"].view(ml_dtypes.float8_e4m3fn)))}


def _torch_tree(a):
    return {"params": {"codes": torch.from_numpy(a["codes"].copy()),
                       "w": torch.from_numpy(a["w"].copy()),
                       "b": torch.from_numpy(a["bf16"].view(np.int16).copy()
                                             ).view(torch.bfloat16)},
            "opt": ({"small": torch.from_numpy(a["small"].copy()),
                     "step": torch.tensor(int(a["step"]),
                                          dtype=torch.int32)},
                    torch.from_numpy(a["fp8"].copy()).view(
                        torch.float8_e4m3fn))}


def _bits(x) -> np.ndarray:
    """Any leaf's raw bytes, shape kept (bf16 and fp8 by their bits)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        elif x.dtype == torch.float8_e4m3fn:
            x = x.view(torch.uint8)
        return x.numpy()
    a = np.asarray(x)
    if a.dtype.itemsize == 2 and a.dtype.kind not in "iu":
        return a.view(np.int16)
    if a.dtype.itemsize == 1:
        return a.view(np.uint8)
    return a


def _same_tree(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert list(fa) == list(fb)
    for k in fa:
        x, y = _bits(fa[k]), _bits(fb[k])
        assert x.shape == y.shape and x.tobytes() == y.tobytes(), k


def _manifest(root):
    with open(os.path.join(root, STEP_DIR, "manifest.json")) as f:
        return json.load(f)


def test_path_keys_match_jax():
    """Sorted dict keys, tuple indices, named-tuple fields, no leaf for
    None, in jax.tree_util's order."""
    import collections
    import jax
    Pair = collections.namedtuple("Pair", ["lo", "hi"])
    tree = {"z": [1, (2, None)], "a": Pair(lo=3, hi={"y": 4, "b": 5})}
    want = [jax.tree_util.keystr(p, simple=True, separator="/")
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert list(flatten_with_paths(tree)) == want
    assert list(flatten_with_paths(tree).values()) == jax.tree.leaves(tree)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoints_cross_over(tmp_path, direction):
    a = _leaves_np()
    jt, tt = _jax_tree(a), _torch_tree(a)
    if direction == "jax_to_torch":
        JManager(str(tmp_path)).save(1, jt, extra={"step": 1})
        got, extra = TManager(str(tmp_path)).restore(tt, device="cpu")
        assert got["params"]["b"].dtype == torch.bfloat16
        assert got["opt"][1].dtype == torch.float8_e4m3fn
        _same_tree(got, tt)
    else:
        TManager(str(tmp_path)).save(1, tt, extra={"step": 1})
        got, extra = JManager(str(tmp_path)).restore(jt)
        _same_tree(got, jt)
    assert extra == {"step": 1}
    meta = _manifest(str(tmp_path))["leaves"]
    assert "qlc" in meta["params/codes"] and "qlc" in meta["opt/1"]
    assert "qlc" not in meta["opt/0/small"]
    assert meta["params/b"]["dtype"] == "bfloat16"
    assert meta["opt/1"]["dtype"] == "float8_e4m3fn"


def test_files_are_byte_identical(tmp_path):
    """Every leaf file, the manifest and the registry: the same bytes."""
    a = _leaves_np(1)
    JManager(str(tmp_path / "j")).save(1, _jax_tree(a), extra={"step": 1})
    TManager(str(tmp_path / "t")).save(1, _torch_tree(a), extra={"step": 1})
    jd, td = tmp_path / "j" / STEP_DIR, tmp_path / "t" / STEP_DIR
    names = sorted(os.listdir(jd))
    assert names == sorted(os.listdir(td))
    assert "registry.json" in names and len(names) == 6 + 2
    for name in names:
        assert (jd / name).read_bytes() == (td / name).read_bytes(), name
    assert _manifest(str(tmp_path / "j")) == _manifest(str(tmp_path / "t"))


@pytest.mark.parametrize("case,want_qlc", [
    ("ffn1_2^13", False), ("ffn1_2^14", True), ("ffn1_2^16", True),
    ("uniform_2^14", False)])
def test_raw_or_qlc_decision_matches(tmp_path, case, want_qlc):
    """The 8192-symbol leaf makes an 8204-byte container, not below its
    8192 raw bytes, so both keep it raw; 2^14 and 2^16 shrink; uniform
    bytes never do."""
    kind, n = case.split("_2^")
    n = 1 << int(n)
    codes = (distributions.ffn1_symbols(n, seed=5).copy() if kind == "ffn1"
             else np.random.default_rng(2).integers(0, 256, n,
                                                    dtype=np.uint8))
    JManager(str(tmp_path / "j")).save(1, {"c": jnp.asarray(codes)})
    TManager(str(tmp_path / "t")).save(1, {"c": torch.from_numpy(codes)})
    mj = _manifest(str(tmp_path / "j"))["leaves"]["c"]
    mt = _manifest(str(tmp_path / "t"))["leaves"]["c"]
    assert mj == mt
    assert ("qlc" in mt) == want_qlc
    f = mt["file"]
    assert (tmp_path / "j" / STEP_DIR / f).read_bytes() == \
        (tmp_path / "t" / STEP_DIR / f).read_bytes()
    got, _ = TManager(str(tmp_path / "j")).restore(
        {"c": torch.zeros(n, dtype=torch.uint8)}, device="cpu")
    np.testing.assert_array_equal(got["c"].numpy(), codes)


@pytest.mark.parametrize("word", ["header", "body"])
def test_flipped_container_word_raises_ioerror(tmp_path, word):
    """A flipped word of a 2^16-symbol QLC leaf: the header no longer
    parses, or the decoded bytes fail the checksum; IOError in both
    packages."""
    codes = distributions.ffn1_symbols(1 << 16, seed=5).copy()
    TManager(str(tmp_path)).save(1, {"codes": torch.from_numpy(codes)})
    meta = _manifest(str(tmp_path))["leaves"]["codes"]
    assert "qlc" in meta
    path = os.path.join(str(tmp_path), STEP_DIR, meta["file"])
    arr = np.load(path)
    arr.reshape(-1)[0 if word == "header" else 16 + 5] ^= np.uint32(0xFFFF)
    np.save(path, arr)
    with pytest.raises(IOError):
        TManager(str(tmp_path)).restore(
            {"codes": torch.from_numpy(codes)}, device="cpu")
    with pytest.raises(IOError):
        JManager(str(tmp_path)).restore({"codes": jnp.asarray(codes)})


def test_missing_leaf_and_shape_mismatch(tmp_path):
    cm = TManager(str(tmp_path))
    cm.save(1, {"a": torch.zeros(3)})
    with pytest.raises(KeyError):
        cm.restore({"a": torch.zeros(3), "b": torch.zeros(3)}, device="cpu")
    with pytest.raises(ValueError):
        cm.restore({"a": torch.zeros(4)}, device="cpu")


def test_checksum_detects_a_changed_raw_leaf(tmp_path):
    cm = TManager(str(tmp_path))
    cm.save(1, {"w": torch.ones(8, 8)})
    meta = _manifest(str(tmp_path))["leaves"]["w"]
    path = os.path.join(str(tmp_path), STEP_DIR, meta["file"])
    arr = np.load(path)
    arr[0, 0] += 1
    np.save(path, arr)
    with pytest.raises(IOError):
        cm.restore({"w": torch.ones(8, 8)}, device="cpu")


def test_qlc_opt_out_matches_reference(tmp_path):
    codes = distributions.ffn1_symbols(1 << 14, seed=5).copy()
    JManager(str(tmp_path / "j"), qlc_codes=False).save(
        1, {"c": jnp.asarray(codes)})
    TManager(str(tmp_path / "t"), qlc_codes=False).save(
        1, {"c": torch.from_numpy(codes)})
    mt = _manifest(str(tmp_path / "t"))["leaves"]["c"]
    assert "qlc" not in mt
    assert mt == _manifest(str(tmp_path / "j"))["leaves"]["c"]
    assert not os.path.exists(tmp_path / "t" / STEP_DIR / "registry.json")


def test_gc_and_latest_pointer(tmp_path):
    cm = TManager(str(tmp_path), keep=2)
    for step in (5, 17, 9):
        cm.save(step, {"s": torch.tensor(step)})
    assert cm.latest_step() == 9          # the pointer follows save order
    assert cm.all_steps() == [9, 17]
    got, _ = cm.restore({"s": torch.tensor(0)}, device="cpu")
    assert int(got["s"]) == 9
    got, _ = cm.restore({"s": torch.tensor(0)}, step=17, device="cpu")
    assert int(got["s"]) == 17
    assert JManager(str(tmp_path)).latest_step() == 9


def test_no_partial_checkpoint_after_a_crash(tmp_path):
    cm = TManager(str(tmp_path))
    cm.save(1, {"x": torch.ones(3)})

    class Boom:
        def __array__(self, *a, **k):
            raise RuntimeError("simulated serialization crash")

    with pytest.raises(RuntimeError):
        cm.save(2, {"x": Boom()})
    assert cm.latest_step() == 1
    assert sorted(os.listdir(str(tmp_path))) == ["latest", STEP_DIR]
    got, _ = cm.restore({"x": torch.zeros(3)}, device="cpu")
    assert torch.equal(got["x"], torch.ones(3))


def test_legacy_counts_layout_restores_in_both(tmp_path):
    """A pre-container checkpoint: the leaf's words as coded by TABLE1
    tables built from the histogram in its meta."""
    from repro_torch.core import TABLE1, build_tables
    from repro_torch.core import codec
    k, n = 256, 8 * 256 - 37
    codes = distributions.ffn1_symbols(8 * 256, seed=9)[:n]
    counts = np.bincount(codes, minlength=256).astype(np.float64) + 1.0
    tables = build_tables(counts, TABLE1)
    padded = np.zeros(8 * k, np.uint8)
    padded[:n] = codes
    chunks = torch.from_numpy(padded.reshape(8, k))
    cap = -(-int(codec.encode_chunk_bits(chunks, tables.enc_len).max())
            // 32)
    words, _ = codec.encode_chunks(chunks, tables, cap)
    cdir = tmp_path / STEP_DIR
    cdir.mkdir()
    np.save(cdir / "legacy.npy", words.numpy().view(np.uint32))
    manifest = {"step": 1, "extra": {}, "leaves": {"c": {
        "file": "legacy.npy", "shape": [n], "dtype": "uint8",
        "sum": __import__("hashlib").md5(codes.tobytes()).hexdigest(),
        "qlc": {"counts": counts.tolist(), "chunk": k, "n": n}}}}
    (cdir / "manifest.json").write_text(json.dumps(manifest))
    got, _ = TManager(str(tmp_path)).restore(
        {"c": torch.zeros(n, dtype=torch.uint8)}, device="cpu")
    np.testing.assert_array_equal(got["c"].numpy(), codes)
    jgot, _ = JManager(str(tmp_path)).restore({"c": jnp.zeros(n, jnp.uint8)})
    np.testing.assert_array_equal(np.asarray(jgot["c"]), codes)


@pytest.mark.parametrize("comm", ["qlc", "baseline"])
def test_trainer_resume_is_bit_exact(tmp_path, comm):
    """Reduced phi3 (d_model 64) on one gloo rank,
    ``checkpoint_every=3``: 6 steps straight equal, bit for bit, 3
    steps, a restore from the checkpoint and 3 more (the reference's
    ``TestCheckpointResume``)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.launch.mesh import data_parallel
    from repro_torch.launch.train import calibrate_registry
    from repro_torch.models import init_params
    from repro_torch.models.transformer import tree_map
    from repro_torch.training import (OptConfig, Trainer, TrainerConfig,
                                      TrainConfig, init_compressed_opt_state,
                                      make_baseline_step,
                                      make_compressed_step,
                                      make_zero1_fallback)
    from repro_torch.training import optimizer as optm
    cfg = reduced(get_config("phi3-mini-3.8b"), dtype="float32")
    opt_cfg = OptConfig(lr=1e-3, total_steps=6, warmup_steps=2)
    data = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=32, global_batch=4))
    with data_parallel("cpu") as group:
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        base = make_baseline_step(cfg, opt_cfg, TrainConfig(), group=group)
        if comm == "qlc":
            reg = calibrate_registry(cfg, params, data.batch_at(0), group)
            step = make_compressed_step(cfg, opt_cfg, TrainConfig(), group,
                                        reg)
            opt0 = init_compressed_opt_state(params, group, reg, opt_cfg)
            fallback = make_zero1_fallback(base, step, group)
        else:
            step, fallback = base, None
            opt0 = optm.init_state(params, opt_cfg)

        def trainer(total, sub):
            return Trainer(TrainerConfig(
                total_steps=total, checkpoint_dir=str(tmp_path / sub),
                checkpoint_every=3), step, fallback_step_fn=fallback)

        def fresh():
            return tree_map(torch.clone, params), tree_map(torch.clone, opt0)

        pa, oa = trainer(6, "a").run(*fresh(), data)
        trainer(3, "b").run(*fresh(), data)
        t3 = trainer(6, "b")
        p_res, o_res, start = t3.restore_or(*fresh())
        assert start == 3
        pb, ob = t3.run(p_res, o_res, data, start_step=start)
    assert sorted(os.listdir(tmp_path / "a")) == \
        ["latest", "step_0000000003", "step_0000000006"]
    _same_tree((pa, oa), (pb, ob))
    assert not torch.equal(pa["embed"], params["embed"])


def test_two_ranks_resume_from_their_own_checkpoints(tmp_path):
    """Two gloo ranks through ``launch.train.train(checkpoint_dir=...)``
    write one directory (no ``rank_<r>``), the compressed state as one
    ``[2, 1, seg]`` leaf. With the newest step (4 of 4) removed, as if
    the run had died while committing it, both ranks resume at step 2
    and end with the uninterrupted run's parameters, bit for bit. A
    one-rank run's compressed checkpoint is refused by two ranks, and
    the two ranks' by one rank: ValueError naming both layouts."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.train import train
    from tests.torch_dist import run_ranks
    cfg_kw = dict(d_model=64, dtype="float32")
    root, single = tmp_path / "two", tmp_path / "one"
    kw = dict(comm="qlc", steps=2, seq_len=16, global_batch=4,
              device="cpu", checkpoint_every=2)
    cfg = reduced(get_config("phi3-mini-3.8b"), **cfg_kw)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(run_ranks, "train_resume", 2, cfg_kw=cfg_kw,
                            steps=4, every=2, root=str(root),
                            single_root=str(single))
        train(cfg, checkpoint_dir=str(single), **kw)
        out = world.result()
    assert sorted(os.listdir(root)) == ["latest", "step_0000000002",
                                         "step_0000000004"]
    for start, first, second, refused, names in out:
        assert names == ["latest", "step_0000000002", "step_0000000004"]
        assert start == 2
        np.testing.assert_array_equal(first, second)
        assert "saved on a 1 x 1 layout and this run is 2 x 1" in refused
    np.testing.assert_array_equal(out[0][1], out[1][1])
    with open(root / "step_0000000002" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["leaves"]["1/m"]["shape"][:2] == [2, 1]
    assert manifest["extra"]["layout"] == {"data": 2, "model": 1}
    with pytest.raises(ValueError, match="saved on a 2 x 1 layout and this "
                                         "run is 1 x 1"):
        train(cfg, checkpoint_dir=str(root), **kw)
