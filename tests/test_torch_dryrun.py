"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's, and the compressed step's device-side escape merge.

One reference subprocess (``tests/md_util.run_md``, 4 fake devices)
lowers and compiles the reference's ``build_lowering`` for reduced
phi3-mini-3.8b (seq 64, batch 8) on a (2, 2) ``data x model`` mesh, for
the train cell on the QLC wire, prefill and decode, and walks each HLO
(``hlo_walk.analyze``, and each collective with its loop trip counts);
the port counts the same cells on a fake world of 4 (``build_cell``
under ``count()``). Product FLOPs a rank agree within 5 % (the
reference's blocked attention and the port's differ in a few small
products; no remat in the reduced config). For the train cell, where
both hold tensor-parallel parameters, the parameter and optimizer bytes
a rank are equal and the collective bytes over the data axis, the QLC
wire's, agree within 10 %. Over the model axis the collectives are held
call for call: the activations' all-reduces are as many on both sides,
of the same shape, and their bytes equal once two stated differences
are undone (XLA's CPU backend promotes a bf16 all-reduce to f32, and it
all-reduces the summands of a column-parallel product's input gradient
as one tuple where the port all-reduces their sum); the loss's
collectives differ by design and are held by name (the port gathers the
logits over the row, the reference reduces ``log_softmax``'s max and
sum). Prefill and decode compare FLOPs only (the reference holds FSDP
parameters there). About 30 s serial."""
import concurrent.futures
import dataclasses
import gzip
import hashlib
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.comm import compressed as tcomp
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import LONG_500K, DECODE_32K, ShapeConfig
from repro_torch.core import TABLE1, build_tables
from repro_torch.launch import dryrun, reanalyze
from repro_torch.models.transformer import pytree_leaves
from tests.md_util import run_md
from tests.torch_dist import one_cpu_thread

one_cpu_thread()

SEQ, BATCH = 64, 8
CELLS = (("train", "qlc"), ("prefill", "baseline"), ("decode", "baseline"))
FLOPS_TOL = 0.05
WIRE_TOL = 0.10
#: the 2 x 2 mesh's data-axis and model-axis device groups, as XLA
#: writes them
_DATA_GROUPS = ("{{0,2},{1,3}}", "[2,2]<=[2,2]T(1,0)")
_MODEL_GROUPS = ("{{0,1},{2,3}}", "[2,2]<=[4]")

REFERENCE = """
import json, re
import jax, numpy as np
assert len(jax.devices()) == 4, jax.devices()   # before dryrun sets 512
from repro.launch import dryrun as jd
from repro.configs import get_config, reduced
from repro.configs.base import ShapeConfig
from repro.roofline import hlo_walk
from repro.parallel import sharding as shd
from repro.launch.mesh import make_test_mesh
COLL = re.compile(r"=\\s*(?P<type>\\(.*?\\)|\\S+)\\s+(?P<op>all-reduce|"
                  r"all-gather|all-to-all|reduce-scatter|collective-permute)"
                  r"(?:-start)?\\(.*?replica_groups=(?P<rg>\\{{[^ ]*?\\}}\\}}|"
                  r"\\[[^ ,]*\\]<=\\[[^ ,]*\\](?:T\\([^ ,]*\\))?)")
cfg = reduced(get_config("phi3-mini-3.8b"))
mesh = make_test_mesh(model=2)
out = {{}}
for kind, comm in {cells}:
    with shd.use_mesh(mesh):
        fn, args = jd.build_lowering(cfg, ShapeConfig("s", {seq}, {batch},
                                                      kind), mesh, comm)
        hlo = fn.lower(*args).compile().as_text()
    shd.set_rules(None)
    c = hlo_walk.analyze(hlo)
    groups = {{}}
    for m in COLL.finditer(hlo):
        groups[m.group("rg")] = groups.get(m.group("rg"), 0.0) + \\
            hlo_walk._shape_bytes(m.group("type"))
    nbytes = lambda tree: float(sum(
        np.prod(l.sharding.shard_shape(l.shape)) * l.dtype.itemsize
        for l in jax.tree.leaves(tree)))
    out[kind] = {{"flops": c.flops, "coll": dict(c.coll), "groups": groups,
                 "params": nbytes(args[0]),
                 "opt": nbytes({{k: v for k, v in args[1].items()
                                if k != "step"}}) if kind == "train" else 0.0,
                 "calls": collective_calls(hlo)}}
print("RESULT" + json.dumps(out))
"""

#: each collective of the HLO with its loop trip count (the product of
#: its enclosing whiles'), group, reduction and op name
CALLS = """
def collective_calls(hlo):
    comps, entry = hlo_walk.parse_hlo(hlo)
    calls = []
    def walk(name, mult):
        comp = comps.get(name)
        for ins in comp.instrs if comp is not None else ():
            if ins.op == "while":
                body = hlo_walk._CALLS.search(ins.rest)
                cond = hlo_walk._COND.search(ins.rest)
                trip = (hlo_walk._trip_count(comps[cond.group(1)])
                        if cond and cond.group(1) in comps else 1)
                if body:
                    walk(body.group(1), mult * trip)
            elif ins.op in ("fusion", "call", "map", "reduce", "scatter",
                            "select-and-scatter", "reduce-window", "sort",
                            "conditional"):
                for c in hlo_walk._CALLS.findall(ins.rest):
                    walk(c, mult)
            elif (ins.op.split("-start")[0] in hlo_walk.COLLECTIVE_OPS
                  and not ins.op.endswith("-done")):
                rg = re.search(r"replica_groups=(\\S+?),? ", ins.rest)
                red = re.search(r"to_apply=%?([\\w.\\-]+)", ins.rest)
                name_m = re.search(r'op_name="([^"]*)"', ins.rest)
                calls.append({{
                    "mult": mult, "kind": ins.op.split("-start")[0],
                    "group": rg.group(1) if rg else None,
                    "promoted": bool(red and "promoted" in red.group(1)),
                    "name": name_m.group(1) if name_m else "",
                    "operands": [[dt, [int(d) for d in dims.split(",") if d]]
                                 for dt, dims in
                                 hlo_walk._SHAPE.findall(ins.type_str)]}})
    walk(entry, 1)
    return calls
"""


@pytest.fixture(scope="module")
def counts():
    """The reference's subprocess, in a thread beside the port's counts."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        script = REFERENCE.format(cells=CELLS, seq=SEQ, batch=BATCH)
        script = script.replace("out = {}", CALLS.format() + "out = {}", 1)
        ref = pool.submit(run_md, script, 4)
        got = _port_counts()
        text = ref.result()
    return json.loads(text.split("RESULT", 1)[1]), got


@pytest.fixture(scope="module")
def reference(counts):
    return counts[0]


@pytest.fixture(scope="module")
def port(counts):
    return counts[1]


def _port_counts():
    """The port's counts of the same cells on a fake world of 4, and the
    train cell's parameter and optimizer bytes a rank."""
    cfg = reduced(get_config("phi3-mini-3.8b"))
    dryrun._fake_world(4)
    try:
        mesh, _ = dryrun._mesh_for(4)
        groups = {"data": mesh.data_group.group_name,
                  "model": mesh.model_group.group_name}
        out = {}
        for kind, comm in CELLS:
            rec, _ = dryrun.count_cell(cfg, ShapeConfig("s", SEQ, BATCH,
                                                        kind), mesh, comm)
            out[kind] = rec
        from repro_torch.launch.mesh import use_mesh
        from repro_torch.parallel import sharding as shd
        shape = ShapeConfig("s", SEQ, BATCH, "train")
        rules, _ = dryrun.cell_rules(cfg, shape, mesh, "qlc")
        tables = dryrun.cell_tables("train")
        with shd.use_rules(rules), use_mesh(mesh), FakeTensorMode():
            _, (params, opt, _) = dryrun.build_cell(cfg, shape, mesh, "qlc",
                                                    "cpu", tables)
            nb = lambda ts: float(sum(t.numel() * t.element_size()  # noqa
                                      for t in ts))
            sizes = {"params": nb(pytree_leaves(params)),
                     "opt": nb([opt["m"], opt["v"]])}
    finally:
        dist.destroy_process_group()
    return out, groups, sizes


@pytest.mark.parametrize("kind", [k for k, _ in CELLS])
def test_product_flops_match_reference(reference, port, kind):
    got, want = port[0][kind].flops, reference[kind]["flops"]
    print(f"{kind}: product FLOPs a rank, port {got:.6g}, reference "
          f"{want:.6g}")
    assert abs(got - want) <= FLOPS_TOL * want


def _port_model_calls(shapes: dict):
    """The port's model-axis collectives from ``coll_groups[...]["shapes"]``:
    ``[(kind, dtype, dims, count)]``."""
    out = []
    for key, n in shapes.items():
        kind, dtype, dims = key.split(" ", 2)
        out.append((kind, dtype, json.loads(dims), n))
    return out


def test_train_cell_state_bytes_and_wire_match_reference(reference, port):
    rec, groups, sizes = port[0]["train"], port[1], port[2]
    ref = reference["train"]
    print("collective bytes a rank by kind:")
    for k in sorted(set(ref["coll"]) | set(rec.coll)):
        print(f"  {k:20s} port {rec.coll.get(k, 0):>10.0f}  reference "
              f"{ref['coll'].get(k, 0):>10.0f}")
    print(f"  total                port {rec.coll_total:>10.0f}  reference "
          f"{sum(ref['coll'].values()):>10.0f}")
    wire = rec.coll_groups[groups["data"]]["bytes"]
    ref_wire = sum(v for g, v in ref["groups"].items() if g in _DATA_GROUPS)
    print(f"  data axis (the wire) port {wire:.0f}, reference {ref_wire:.0f};"
          f" model axis port {rec.coll_groups[groups['model']]['bytes']:.0f}")
    assert sizes["params"] == ref["params"]
    assert sizes["opt"] == ref["opt"]
    assert ref_wire > 0 and abs(wire - ref_wire) <= WIRE_TOL * ref_wire

    # The model axis, call for call.
    cfg = reduced(get_config("phi3-mini-3.8b"))
    mine = _port_model_calls(rec.coll_groups[groups["model"]]["shapes"])
    theirs = [c for c in ref["calls"] if c["group"] in _MODEL_GROUPS]
    print("model axis, port:", mine)
    print("model axis, reference:", [(c["mult"], c["kind"], c["promoted"],
                                      c["operands"], c["name"][-60:])
                                     for c in theirs])
    act = [c for c in mine if c[0] == "all-reduce" and len(c[2]) == 3]
    ref_act = [c for c in theirs if c["kind"] == "all-reduce"
               and "log_softmax" not in c["name"]
               and any(len(d) == 3 for _, d in c["operands"])]
    dims = {tuple(d) for _, _, d, _ in act}
    assert len(dims) == 1, dims
    # as many activation all-reduces, each of one [batch, seq, d_model]
    assert sum(n for *_, n in act) == sum(c["mult"] for c in ref_act) > 0
    # each of the reference's holds [batch, seq, d_model] summands and at
    # most per-token pieces beside them (the embedding's mask, the loss's
    # per-token sum, fused into the same tuple)
    b_s = int(np.prod(next(iter(dims))[:2]))
    for c in ref_act:
        assert any(tuple(d) in dims for _, d in c["operands"]), c
        assert all(tuple(d) in dims or int(np.prod(d)) <= b_s
                   for _, d in c["operands"]), c
    # promoted to f32 by XLA exactly where the port all-reduces bf16
    assert sum(n for _, dt, _, n in act if dt == "bfloat16") == sum(
        c["mult"] for c in ref_act if c["promoted"])
    one = int(np.prod(next(iter(dims))))
    port_act = sum(n * one * (2 if dt == "bfloat16" else 4)
                   for _, dt, _, n in act)
    ref_act_bytes = sum(c["mult"] * one * (2 if c["promoted"] else 4)
                        for c in ref_act)
    print(f"  model-axis activation all-reduces: port {port_act} B, "
          f"reference {ref_act_bytes} B with its promotion undone and one "
          f"summand a call")
    assert port_act == ref_act_bytes
    # the loss: the port gathers the rank's logits over the row, the
    # reference reduces log_softmax's max and sum over its vocab shard
    gathers = [c for c in mine if c[0] == "all-gather"]
    local_b = BATCH // 2
    assert sum(int(np.prod(d)) * n for _, _, d, n in gathers) == \
        local_b * SEQ * cfg.vocab_size
    assert not any(c["kind"] == "all-gather" for c in theirs)
    assert {"reduce_max", "reduce_sum"} <= {
        c["name"].rsplit("/", 1)[-1] for c in theirs
        if "log_softmax" in c["name"]}
    # everything else on the model axis is a scalar on both sides
    rest = [c for c in mine if c not in act and c not in gathers]
    assert all(int(np.prod(d)) <= 1 for _, _, d, _ in rest), rest
    ref_rest = [c for c in theirs if c not in ref_act
                and "log_softmax" not in c["name"]]
    assert all(int(np.prod(d)) <= 1 for c in ref_rest
               for _, d in c["operands"]), ref_rest


def test_compressed_step_counts_its_kernels(port):
    """The compressed step traced on fake tensors over 2 x 2 (no host read
    in its wire): K1 encodes the gradient and parameter pieces, K2 decodes
    them."""
    calls = port[0]["train"].kernel_calls()
    assert calls["K1"] == 2 and calls["K2"] >= 2, calls
    assert calls["K3"] == calls["K4"] == calls["K5"] == calls["K6"] == 0


def _clustered_wire(pool_per_1k: int):
    """Four rows of 16 chunks; rows 1-3 hold runs of heavy-tailed chunks
    (3, 4 and 1 escapes), row 0 none. At 256 pool slots per 1k (4 a row)
    row 2's pool is full and row 0's empty; at 128 (2 a row) rows 1 and 2
    overflow."""
    rng = np.random.default_rng(11)
    k, n = 1024, 16
    x = (rng.standard_normal((4, n * k)) * 0.5).astype(np.float32)
    for row, chunks in ((1, (3, 4, 5)), (2, (10, 11, 12, 13)), (3, (0,))):
        for c in chunks:
            x[row, c * k:(c + 1) * k] = (rng.standard_cauchy(k) * 50
                                         ).astype(np.float32)
    codes = tcomp._quantize(torch.from_numpy(x[0]), tcomp.CommConfig())[0]
    counts = np.bincount(codes.numpy(), minlength=256).astype(np.float64)
    tables = build_tables(counts + 1, TABLE1)
    cfg = tcomp.CommConfig(chunk_symbols=k, capacity_words=230,
                           pool_slots_per_1k=pool_per_1k)
    payload, scales = tcomp._compress_values(torch.from_numpy(x), tables,
                                             cfg)
    acc = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    return payload, scales, tables, cfg, acc


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.int32).numpy().tobytes()
                          ).hexdigest()


#: the values (plain, accumulate form) and ``ok`` of the host-read decode
#: that the device-side merge replaced; past an overflowed pool, the
#: reference's last-pool-row values
CLUSTERED = {
    256: ("c7006aa62cad70a580143f6da039e04a5dac7947634353ac4124a821ce1e85a5",
          "97898135968ea8ee55aaec7ac7d6947c1f013e9a7c4072c6493f459ee37482c3",
          [True, True, True, True]),
    128: ("ca55bf0c385f2830d48f237921e245cf006622ed9d9114cb5167a04dfaadcc0e",
          "f55b1e6e6079b4d534b5ca476ac02d68c975cf56141bba6798cf9a8f9d10e07f",
          [True, False, False, True]),
}


@pytest.mark.parametrize("pool_per_1k", sorted(CLUSTERED))
def test_clustered_escapes_decode_as_before(pool_per_1k):
    """The wire's value decode and its accumulate form give the values
    and ``ok`` the host-read decode gave, bit for bit, with a pool that
    holds every escape and with one that overflows. The route is the
    card's too (K2, the fixed-slot merge, the overflow select)."""
    payload, scales, tables, cfg, acc = _clustered_wire(pool_per_1k)
    plain, acc_digest, want_ok = CLUSTERED[pool_per_1k]
    assert payload.flags.sum(-1).tolist() == [0, 3, 4, 1]
    v, ok = tcomp._decompress_values(payload, scales, tables, cfg)
    a, ok2 = tcomp._accumulate_values(acc, payload, scales, tables, cfg)
    assert ok.tolist() == ok2.tolist() == want_ok
    assert _digest(v) == plain and _digest(a) == acc_digest


def test_seeded_cell_runs_on_real_data_and_its_wire_shapes_the_count(
        monkeypatch):
    """``build_cell(seed=...)``, the card's profiled step: the synthetic
    stream's batch, and a decode's weights on their real QLC wire; the
    dry run given that wire's slots (``wire_capacities``) counts K2 as
    often, and with as many bytes, as the real step calls it."""
    from repro_torch.comm.weights import wire_capacities
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.roofline.op_count import kernel_bytes
    cfg = reduced(get_config("phi3-mini-3.8b"), d_model=256, d_ff=512,
                  num_layers=2)
    calls = []
    real_k2 = ops.decode_dequantize

    def k2(*args, **kw):
        calls.append(kernel_bytes("decode_dequantize", *args, **kw))
        return real_k2(*args, **kw)

    dryrun._fake_world(1)
    try:
        mesh, _ = dryrun._mesh_for(1)
        train = ShapeConfig("s", 32, 4, "train")
        with use_mesh(mesh):
            _, (_, _, batch) = dryrun.build_cell(cfg, train, mesh, "qlc",
                                                 "cpu",
                                                 dryrun.cell_tables("train"),
                                                 seed=3)
        want = SyntheticDataset(DataConfig(cfg.vocab_size, 32, 4,
                                           seed=3)).batch_at(0)
        assert torch.equal(batch["tokens"], torch.from_numpy(want["tokens"]))
        shape = ShapeConfig("s", 32, 4, "decode")
        rules, _ = dryrun.cell_rules(cfg, shape, mesh, "qlc")
        with shd.use_rules(rules), use_mesh(mesh):
            step, live = dryrun.build_cell(cfg, shape, mesh, "qlc", "cpu",
                                           dryrun.cell_tables("decode"),
                                           seed=0)
            monkeypatch.setattr(ops, "decode_dequantize", k2)
            logits, _ = step()
            monkeypatch.setattr(ops, "decode_dequantize", real_k2)
        assert bool(torch.isfinite(logits).all())
        caps = wire_capacities(live[0]["groups"])
        assert caps and set(caps.values()) != {dryrun.cell_tables(
            "decode")[1].capacity_words}
        rec, _ = dryrun.count_cell(cfg, shape, mesh, "qlc", wire_caps=caps)
    finally:
        dist.destroy_process_group()
    assert rec.kernel_calls()["K2"] == len(calls) > 0
    assert rec.kernel_bytes()["K2"] == sum(calls)


def test_run_cell_writes_the_reference_keys_and_reanalyzes(tmp_path):
    """A cell through ``run_cell`` (phi3 at reduced widths on a fake 2 x 2
    world): the reference's JSON keys plus ``fits`` and ``rules_differ``,
    the op record beside it, and ``reanalyze`` rebuilding the same
    ``roofline`` from that record alone."""
    small = dict(d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
                 d_ff=128, vocab_size=256, num_layers=2)
    out = tmp_path / "cell.json"
    res = dryrun.run_cell("phi3-mini-3.8b", "train_4k", comm="qlc",
                          overrides=small, world=4,
                          ops_out=str(out).replace(".json", ".ops.json.gz"),
                          shape_overrides={"seq_len": SEQ,
                                           "global_batch": BATCH})
    res["overrides"], res["shape_overrides"] = small, {"seq_len": SEQ,
                                                       "global_batch": BATCH}
    out.write_text(json.dumps(res, default=str))
    assert {"arch", "shape", "mesh", "comm", "chips", "memory", "roofline",
            "ok", "fits", "rules_differ"} <= set(res)
    assert res["ok"] and res["fits"] and res["chips"] == 4
    assert res["kernels"]["K1"] == 2
    assert res["memory"]["peak_bytes"] >= res["memory"][
        "argument_size_in_bytes"] > 0
    with gzip.open(str(out).replace(".json", ".ops.json.gz"), "rt") as f:
        assert json.load(f)["ops"]
    again = reanalyze.reanalyze(str(out))
    assert again["roofline"] == json.loads(json.dumps(res["roofline"]))
    assert not os.path.exists(str(out).replace(".json", ".hlo.gz"))


def test_cell_rules_name_what_the_port_does_differently():
    """A decode cell runs under the reference's decode rules (the cache's
    sequence over ``model`` where the KV heads do not divide it, over
    ``("data", "model")`` at a batch of 1), and a baseline or decode
    cell's rules carry the reference's FSDP parameter overrides, so
    ``rules_differ`` is empty; the compressed train cell keeps TP-only
    parameters (no overrides), as the reference's does."""
    from repro_torch.parallel.sharding import FSDP_PARAM_OVERRIDES
    mesh = dataclasses.make_dataclass("M", [("shape", dict)])(
        {"data": 16, "model": 16})
    coder = get_config("deepseek-coder-33b")
    rules, differ = dryrun.cell_rules(coder, DECODE_32K, mesh, "baseline")
    assert rules.rules["kv_seq"] == "model"
    assert rules.param_overrides == FSDP_PARAM_OVERRIDES
    rules, differ2 = dryrun.cell_rules(get_config("jamba-1.5-large-398b"),
                                       LONG_500K, mesh, "baseline")
    assert rules.rules["kv_seq"] == ("data", "model")
    assert rules.rules["batch"] is None
    assert rules.param_overrides == FSDP_PARAM_OVERRIDES
    assert differ == [] and differ2 == []
    rules, differ = dryrun.cell_rules(
        get_config("phi3-mini-3.8b"), ShapeConfig("t", 8, 8, "train"), mesh,
        "baseline")
    assert differ == []
    assert rules.param_overrides == FSDP_PARAM_OVERRIDES
    rules, differ = dryrun.cell_rules(
        get_config("phi3-mini-3.8b"), ShapeConfig("t", 8, 8, "train"), mesh,
        "qlc")
    assert differ == [] and not rules.param_overrides


@pytest.mark.parametrize("batch", [8, 1], ids=["model", "data_model"])
def test_decode_cell_holds_its_part_of_the_kv_cache(batch):
    """A decode cell whose 3 KV heads do not divide the model axis, on a
    fake 2 x 2 world: at batch 8 (``kv_seq -> model``, the batch over
    ``data``) a rank's KV cache is ``1 / (data * model)`` of the whole,
    its positions ``1 / model``; at batch 1 (``kv_seq -> ("data",
    "model")``) ``1 / 4`` of the whole, in positions. The counted step
    all-gathers the partial attentions once a layer over the sequence
    shard's group: the model row, or the world. ``kv_cache_bytes``, which
    the dry run writes, counts the same bytes."""
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import init_decode_states
    from repro_torch.models.attention import KVCache
    from repro_torch.parallel import sharding as shd
    cfg = reduced(get_config("chatglm3-6b"), num_heads=6, num_kv_heads=3)
    shape = ShapeConfig("d", SEQ, batch, "decode")

    def kv_bytes(states):
        return sum(t.numel() * t.element_size() for st in states.values()
                   if isinstance(st, KVCache) for t in (st.k, st.v))
    whole = kv_bytes(init_decode_states(cfg, batch, SEQ, "meta"))
    dryrun._fake_world(4)
    try:
        mesh, _ = dryrun._mesh_for(4)
        rules, differ = dryrun.cell_rules(cfg, shape, mesh, "baseline")
        with shd.use_rules(rules), use_mesh(mesh), FakeTensorMode():
            _, (_, states, _, _) = dryrun.build_cell(
                cfg, shape, mesh, "baseline", "cpu", None)
            local = kv_bytes(states)
            k = states["l0"].k
        assert dryrun.kv_cache_bytes(cfg, shape, mesh, "baseline") == local
        rec, _ = dryrun.count_cell(cfg, shape, mesh, "baseline")
        group = mesh.model_group if batch > 1 else mesh.world_group
        gathers = rec.coll_groups[group.group_name]["shapes"]
        size = group.size()
    finally:
        dist.destroy_process_group()
    assert local * 4 == whole
    assert k.shape[2] == SEQ // (2 if batch > 1 else 4)
    assert k.shape[3] == cfg.num_kv_heads
    # one result a rank of the group, each [b, 1, KV, G, head_dim + 2]
    part = [n for key, n in gathers.items() if key.startswith("all-gather")
            and key.endswith(f", {cfg.resolved_head_dim + 2}]")]
    assert sum(part) == cfg.num_layers * size, gathers
