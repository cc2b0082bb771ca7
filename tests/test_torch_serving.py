"""Port parity, serving slice: calibrate -> compress (K1) -> open (K2) ->
decode -> Engine, on a reduced phi3-mini-3.8b, against the JAX reference.

The reduced config keeps d_model 128 and d_ff 512 so the FFN leaves reach
the wire's 65536-symbol minimum (the ``reduced()`` defaults would leave
every leaf dense). Both packages get the same weights: the reference
initializes them and ``repro_torch.convert.params_from_numpy`` carries
them over. Logits agree to rtol 1e-4 / atol 1e-5, which covers f32
matmul summation order; everything on the wire is bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.calibrate import histogram_of_tree as j_hist
from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.core import CodecRegistry as JRegistry
from repro.models import decode_step as j_decode_step
from repro.models import init_decode_states as j_init_states
from repro.models import init_params as j_init_params
from repro.serving import Engine as JEngine
from repro.serving import GenerationRequest as JRequest
from repro.serving import compress_params_for_serving as j_compress
from repro.serving import open_params as j_open
from repro.serving import prefill as j_prefill
from repro_torch.comm.calibrate import histogram_of_tree as t_hist
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import CodecRegistry
from repro_torch.launch.serve import serve
from repro_torch.models import decode_step, init_decode_states
from repro_torch.models.transformer import tree_map
from repro_torch.quant import e4m3
from repro_torch.serving import (compress_params_for_serving, open_params,
                                 prefill)
from tests.torch_dist import one_cpu_thread

one_cpu_thread()

KW = dict(d_model=128, d_ff=512, dtype="float32")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


@pytest.fixture(scope="module")
def slice_():
    jcfg = j_reduced(j_get_config("phi3-mini-3.8b"), **KW)
    cfg = reduced(get_config("phi3-mini-3.8b"), **KW)
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jreg, treg = JRegistry(), CodecRegistry()
    jh, th = j_hist(jp), t_hist(tp)
    jreg.register("default", jh)
    treg.register("default", th)
    jw, jwc = j_compress(jp, jreg)
    tw, twc = compress_params_for_serving(tp, treg)
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, jh=jh, th=th, jw=jw,
                jwc=jwc, tw=tw, twc=twc, jopen=j_open(jw, jwc),
                topen=open_params(tw, twc))


def test_histogram_of_tree_matches(slice_):
    np.testing.assert_array_equal(slice_["jh"], slice_["th"])
    n = sum(int(np.prod(a.shape)) // 32 * 32
            for a in jax.tree.leaves(slice_["jp"]))
    assert slice_["th"].sum() == n


def test_compress_groups_matches(slice_):
    jwc, twc = slice_["jwc"], slice_["twc"]
    assert sorted(jwc.meta) == sorted(twc.meta)
    assert len(twc.meta) == 3           # the FFN leaves of the one group
    for key, jm in jwc.meta.items():
        tm = twc.meta[key]
        assert (tm.group_shape, tm.n_symbols, tm.n_chunks,
                tm.capacity_words, tm.mode, tm.scheme_id) == \
            (tuple(jm.group_shape), jm.n_symbols, jm.n_chunks,
             jm.capacity_words, jm.mode, jm.scheme_id), key
        assert str(tm.dtype).removeprefix("torch.") == str(jm.dtype)
    jf, tf = _flat(slice_["jw"]), _flat(slice_["tw"])
    assert sorted(jf) == sorted(tf)
    for key, a in jf.items():
        a, b = np.asarray(a), tf[key]
        if key.endswith("/words"):
            np.testing.assert_array_equal(a, b.numpy().view(np.uint32))
        elif key.endswith("/scales"):
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                a.astype(np.float32).view(np.uint32),
                b.float().numpy().view(np.uint32))
        else:
            np.testing.assert_array_equal(a, b.numpy(), err_msg=key)


def test_open_params_bit_equal(slice_):
    jf, tf = _flat(slice_["jopen"]), _flat(slice_["topen"])
    assert sorted(jf) == sorted(tf)
    for key, a in jf.items():
        assert tf[key].dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a).view(np.uint32),
                                      tf[key].numpy().view(np.uint32),
                                      err_msg=key)


def test_decode_step_logits_match(slice_):
    """A 6-token prompt prefilled through decode steps, then one more
    step: every compared logit within f32 summation-order tolerance."""
    jcfg, cfg = slice_["jcfg"], slice_["cfg"]
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 6))
    jl, js = j_prefill(slice_["jopen"], jcfg, jnp.asarray(prompt, jnp.int32),
                       j_init_states(jcfg, 2, 16))
    tl, ts = prefill(slice_["topen"], cfg, torch.from_numpy(prompt),
                     init_decode_states(cfg, 2, 16, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-5)
    tok = np.argmax(np.asarray(jl), axis=-1).astype(np.int32)[:, None]
    pos = np.full((2, 1), 6, np.int32)
    jl2, _ = j_decode_step(slice_["jopen"], jcfg, jnp.asarray(tok), js,
                           jnp.asarray(pos))
    tl2, _ = decode_step(slice_["topen"], cfg, torch.from_numpy(tok), ts,
                         torch.from_numpy(pos))
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=1e-4,
                               atol=1e-5)


def test_weight_codec_step_equals_opened_step(slice_):
    """decode_step opening each group's wire inside the layer loop gives
    exactly the logits and states of the step on opened params."""
    cfg, tp = slice_["cfg"], slice_["tp"]
    wired_g, wc = compress_params_for_serving(
        tp["groups"], slice_["twc"].registry)
    tok = torch.tensor([[3], [200]], dtype=torch.int32)
    pos = torch.tensor([[0], [0]], dtype=torch.int32)
    lw, sw = decode_step({**tp, "groups": wired_g}, cfg, tok,
                         init_decode_states(cfg, 2, 8, device="cpu"), pos,
                         weight_codec=wc)
    lo, so = decode_step(slice_["topen"], cfg, tok,
                         init_decode_states(cfg, 2, 8, device="cpu"), pos)
    assert torch.equal(lw, lo)
    tree_map(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
             sw, so)


def _dense_round_trip(tp, twc):
    """The opened values computed without the codec: plain quantize and
    dequantize of every wired leaf, scales through bf16."""
    out = tree_map(lambda t: t.clone(), tp)
    for key, m in twc.meta.items():
        node = out
        *path, last = key.split("/")
        for p in path:
            node = node[p]
        leaf = node[last]
        codes, scales = e4m3.quantize_block32(leaf.reshape(leaf.shape[0], -1))
        node[last] = e4m3.dequantize_block32(
            codes, scales.to(torch.bfloat16).float()).reshape(leaf.shape)
    return out


def test_engine_qlc_wire_matches_dense_and_reference(slice_):
    """The launcher path with --wire qlc (calibrate, compress, open,
    Engine at batch 4 with 6 requests) gives the tokens of a dense
    (--wire none) run on the expected values, and of the reference's
    Engine on its own opened params."""
    cfg, tp = slice_["cfg"], slice_["tp"]
    kw = dict(batch=4, requests=6, prompt_len=5, new_tokens=6,
              device="cpu", seed=0)
    wired = serve(cfg, wire="qlc", params=tp, **kw)
    dense = serve(cfg, wire="none",
                  params=_dense_round_trip(tp, slice_["twc"]), **kw)
    toks = [o.tokens for o in wired["outs"]]
    assert all(o.state == "finished" and len(o.tokens) == 6
               for o in wired["outs"])
    assert [t.tolist() for t in toks] == \
        [o.tokens.tolist() for o in dense["outs"]]
    eng = JEngine(slice_["jopen"], slice_["jcfg"], max_seq_len=5 + 6 + 8,
                  max_batch=4)
    hs = [eng.submit(JRequest(prompt=p, max_new_tokens=6))
          for p in wired["prompts"]]
    eng.run()
    assert [t.tolist() for t in toks] == \
        [eng.poll(h).tokens.tolist() for h in hs]
    st = wired["stats"]
    assert st["requests"]["finished"] == 6
    assert st["decode_tokens"] + 6 == 6 * 6
