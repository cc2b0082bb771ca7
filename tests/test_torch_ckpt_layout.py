"""Port, one checkpoint for any layout: ``launch.train.train(
checkpoint_dir=...)`` over ``data x model`` layouts of gloo CPU ranks
writes one directory of whole leaves, the reference's format, and every
rank cuts its part from it on restore.

Two worlds started side by side (``tests/torch_dist``): one of 2 ranks
saves reduced phi3's baseline state at 2 x 1 and restores it at 1 x 2,
and splits byte-width leaves (QLC'd whole by rank 0); one of 4 ranks
runs the compressed step at 2 x 2 (straight, and saved and resumed; on
the wire's raw e4m3 twin, since a checkpoint does not depend on the
wire: the QLC wire's resume is ``tests/test_torch_tp.py``'s and
``chip_smoke.py``'s), an interrupted save, the compressed state's
refusal at 1 x 4 and 4 x 1, a corrupt leaf, the per-rank layout's
refusal, and, once the world of 2 has saved, restores the baseline
state at 4 x 1 and 2 x 2; the pytest process restores it at 1 x 1.
Every comparison is exact: a restored part against
``convert.shard_params`` of the saved whole tree, a resumed run against
the straight one. The cross-package cases (either package's checkpoint
restored by the other, compressed 2 x 2 and baseline (2, 1)) run in
``tests/test_torch_tp.py``'s worlds and reference subprocess.
"""
import concurrent.futures
import json
import os

import numpy as np
import pytest
import torch

from repro.core import distributions
from repro_torch.checkpoint import Layout
from repro_torch.checkpoint import manager
from repro_torch.checkpoint.manager import (_checksum, _host_array, _mapped,
                                            _save_npy, _write_part)
from repro_torch.configs import get_config, reduced
from repro_torch.convert import shard_params
from repro_torch.launch.train import train
from tests.torch_dist import (assert_same_tree, numpy_tree, opt_numpy,
                              run_ranks)
from tests.torch_dist import one_cpu_thread

one_cpu_thread()

CFG = dict(d_model=64, dtype="float32")
BASE = dict(steps=1, seq_len=16, global_batch=4)
COMP = dict(steps=2, seq_len=16, global_batch=4, lr=1e-3)


def _cfg():
    return reduced(get_config("phi3-mini-3.8b"), **CFG)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The world of 2 and the world of 4, in threads side by side (the
    second waits for the first's baseline checkpoint) -> (world of 2's
    results, world of 4's, the baseline checkpoint's directory, the
    compressed one's)."""
    root = tmp_path_factory.mktemp("ckpt_layout")
    base, four = str(root / "base"), str(root / "four")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        w2 = pool.submit(run_ranks, "ckpt_world2", 2, cfg_kw=CFG,
                         train_kw=BASE, root=base, codes=_codes(),
                         codes_root=str(root / "codes"))
        w4 = pool.submit(run_ranks, "ckpt_world4", 4, cfg_kw=CFG,
                         train_kw=COMP, root=four, base_root=base,
                         base_kw=BASE)
        return (w2.result(), w4.result(), base, os.path.join(four, "comp"),
                str(root / "codes"))


def _codes():
    """2^14 skewed e4m3 symbols as u8 [16, 1024]: they shrink as QLC."""
    return distributions.ffn1_symbols(1 << 14, seed=7).reshape(16, 1024)


def _tree(params, opt):
    return {"p": params, "m": opt["m"], "v": opt["v"]}


def _cut(state, cfg, m, model):
    """A whole baseline state (params, opt) cut to model rank ``m``."""
    params, opt = state
    return (shard_params(params, cfg, m, model),
            {"m": shard_params(opt["m"], cfg, m, model),
             "v": shard_params(opt["v"], cfg, m, model),
             "step": opt["step"]})


@pytest.mark.parametrize("layout", ["1x1", "4x1", "1x2", "2x2"])
def test_baseline_restores_on_any_layout(worlds, layout):
    """The baseline state saved at 2 x 1 after a step restores at 1 x 1,
    4 x 1, 1 x 2 and 2 x 2: every rank starts at step 1 with its cut of
    the saved tree, bit for bit (parameters, both AdamW trees, the
    step)."""
    w2, w4, base, *_ = worlds
    cfg = _cfg()
    saved = w2[0]["2x1"][:2]
    for other in w2[1:]:
        assert_same_tree(_tree(*other["2x1"][:2]), _tree(*saved))
    data, model = map(int, layout.split("x"))
    if layout == "1x1":
        res = train(cfg, comm="baseline", device="cpu", checkpoint_dir=base,
                    **BASE)
        ranks = [(numpy_tree(res["params"]), opt_numpy(res["opt_state"]),
                  res["start_step"])]
    else:
        ranks = [r[layout] for r in (w2 if layout == "1x2" else w4)]
    assert len(ranks) == data * model
    for rank, (params, opt, start) in enumerate(ranks):
        assert start == BASE["steps"]
        want = _cut(saved, cfg, rank % model, model)
        assert_same_tree(_tree(params, opt), _tree(*want))
        assert opt["step"] == want[1]["step"] == BASE["steps"]
    assert sorted(os.listdir(base)) == ["latest", "step_0000000001"]


def test_compressed_resumes_on_its_own_layout(worlds):
    """Compressed at 2 x 2: a step, a checkpoint, and a resumed launch's
    second step end bit-equal to 2 steps straight on every rank; the
    checkpoint holds ``1/m`` and ``1/v`` as ``[2, 2, seg]`` and the
    layout in ``extra``."""
    _, w4, _, comp, _ = worlds
    for r in w4:
        (p0, o0, s0), (p1, o1, s1) = r["straight"], r["resumed"]
        assert (s0, s1) == (0, COMP["steps"] - 1)
        assert_same_tree(_tree(p0, o0), _tree(p1, o1))
        assert o0["step"] == o1["step"] == COMP["steps"]
    with open(os.path.join(comp, f"step_{COMP['steps']:010d}",
                           "manifest.json")) as f:
        manifest = json.load(f)
    seg = w4[0]["straight"][1]["m"].shape[0]
    for k in ("1/m", "1/v"):
        assert manifest["leaves"][k]["shape"] == [2, 2, seg]
    assert manifest["extra"]["layout"] == {"data": 2, "model": 2}
    assert manifest["extra"]["step"] == COMP["steps"]


@pytest.mark.parametrize("layout", ["1x4", "4x1"])
def test_compressed_refused_on_another_layout(worlds, layout):
    """The 2 x 2 compressed state at 1 x 4 or 4 x 1: every rank raises
    ValueError naming both layouts before its first step (none hangs:
    the world returned)."""
    _, w4, *_ = worlds
    data, model = layout.split("x")
    for r in w4:
        msg = r[f"refused {layout}"]
        assert msg is not None and "1/m" in msg
        assert "saved on a 2 x 2 layout" in msg
        assert f"this run is {data} x {model}" in msg


def test_interrupted_save_keeps_the_previous_step(worlds):
    """Rank 2 fails while writing its row of the next step: every rank
    raises, no temp directory is left, ``latest`` stays at the last good
    step, and it restores bit-equal to the state that saved it."""
    _, w4, *_ = worlds
    step = COMP["steps"]
    for rank, r in enumerate(w4):
        failed, latest, names = r["interrupted"]
        assert "simulated failure while writing a part" in failed
        if rank != 2:
            assert failed.startswith("rank 2: ")
        assert latest == step
        assert names == ["latest", f"step_{step - 1:010d}",
                         f"step_{step:010d}"]
        (p0, o0, _), (p1, o1, s1) = r["resumed"], r["again"]
        assert s1 == step
        assert_same_tree(_tree(p0, o0), _tree(p1, o1))


def test_corrupt_leaf_raises_on_every_rank(worlds):
    """One flipped byte in a leaf of the 2 x 2 checkpoint: the rank that
    checks that leaf's md5 finds it, and every rank raises IOError naming
    the leaf before any of them uses the state."""
    _, w4, *_ = worlds
    for r in w4:
        assert r["corrupt"] is not None
        assert "checksum mismatch for 0/embed" in r["corrupt"]


def test_per_rank_layout_refused(worlds):
    """A directory of ``rank_<r>`` subdirectories (the port's earlier
    per-rank checkpoints) raises ValueError naming it, on every rank."""
    _, w4, *_ = worlds
    for r in w4:
        assert "per-rank layout" in r["old"] and "rank_00000" in r["old"]


def test_split_byte_leaves_are_qlc_and_restore_in_both(worlds):
    """Byte-width leaves split over two ranks (u8 rows, fp8 columns, a
    ``[1, 2, k]`` u8 row leaf): rank 0 frames each whole leaf as a QLC
    container (``registry.json`` beside the manifest); each rank restores
    its own part, and both packages restore the whole leaves, bit for
    bit."""
    import jax.numpy as jnp
    import ml_dtypes
    from repro.checkpoint import CheckpointManager as JManager
    from repro_torch.checkpoint import CheckpointManager
    w2, _, _, _, root = worlds
    codes = _codes()
    n, k = codes.shape
    for rank, r in enumerate(w2):
        got = r["codes"]
        np.testing.assert_array_equal(
            got["codes"], codes[rank * n // 2:(rank + 1) * n // 2])
        np.testing.assert_array_equal(
            got["fp8"], codes[:, rank * k // 2:(rank + 1) * k // 2])
        np.testing.assert_array_equal(got["rows"], codes[rank])
    cdir = os.path.join(root, "step_0000000001")
    with open(os.path.join(cdir, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    assert all("qlc" in leaves[key] for key in ("codes", "fp8"))
    assert leaves["fp8"]["dtype"] == "float8_e4m3fn"
    assert leaves["rows"]["shape"] == [1, 2, k]
    assert os.path.exists(os.path.join(cdir, "registry.json"))
    want = {"codes": codes, "fp8": codes, "rows": codes[:2][None]}
    got, _ = CheckpointManager(root).restore(
        {"codes": torch.zeros(n, k, dtype=torch.uint8),
         "fp8": torch.zeros(n, k, dtype=torch.float8_e4m3fn),
         "rows": torch.zeros(1, 2, k, dtype=torch.uint8)}, device="cpu")
    jgot, _ = JManager(root).restore(
        {"codes": jnp.zeros((n, k), jnp.uint8),
         "fp8": jnp.zeros((n, k), ml_dtypes.float8_e4m3fn),
         "rows": jnp.zeros((1, 2, k), jnp.uint8)})
    for key, w in want.items():
        np.testing.assert_array_equal(got[key].view(torch.uint8).numpy(), w)
        np.testing.assert_array_equal(
            np.asarray(jgot[key]).view(np.uint8), w)


@pytest.mark.parametrize("piece", [None, 24], ids=["whole", "24B"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_leaf_files_are_np_save_files(tmp_path, monkeypatch, dtype,
                                            piece):
    """Parts written by the ranks of a 2 x 2 layout, one at a time into
    the same files (leaves cut along dim 1 and dim 0 from the first model
    row, and a ``[data, model, seg]`` leaf row by row), moved to the
    host whole or 24 bytes at a time: the files are ``np.save``'s of the
    whole leaves byte for byte (bf16 under the void descr ``<V2``) and
    their md5s are the whole leaves'."""
    if piece is not None:
        monkeypatch.setattr(manager, "_PIECE", piece)
    gen = torch.Generator().manual_seed(0)
    leaves = {"w": torch.randn(3, 8, 5, generator=gen).to(dtype),
              "e": torch.randn(6, 7, generator=gen).to(dtype),
              "r": torch.randn(2, 2, 6, generator=gen).to(dtype)}
    for rank in range(4):
        lay = Layout(data=2, model=2, rank=rank, cut={"w": 1, "e": 0},
                     rows=frozenset({"r"}))
        d, m = divmod(rank, 2)
        parts = {"w": leaves["w"][:, 4 * m:4 * m + 4],
                 "e": leaves["e"][3 * m:3 * m + 3], "r": leaves["r"][d, m]}
        for key, part in parts.items():
            if lay.writes(key):
                meta = _write_part(str(tmp_path), f"{key}.npy", part, lay,
                                   key)
                assert meta["shape"] == list(leaves[key].shape)
    for name, t in leaves.items():
        arr = _host_array(t)[0]
        with open(tmp_path / f"{name}_ref.npy", "wb") as f:
            _save_npy(f, arr)
        assert (tmp_path / f"{name}.npy").read_bytes() == \
            (tmp_path / f"{name}_ref.npy").read_bytes()
        assert _checksum(_mapped(str(tmp_path), f"{name}.npy")) \
            == _checksum(arr)
