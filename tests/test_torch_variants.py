"""Port parity, block-variant slice: the gelu and squared-ReLU FFNs
(no ``w_gate``), padded heads, sliding-window decode, the multi-token
write into a KV cache, ``prefill_logits`` and the engine's per-tenant
fairness cap, against the JAX reference.

Reduced configs in both packages, f32 compute unless stated, the
reference's init carried over with ``params_from_numpy``:

* musicgen-medium (gelu, with its 8-embedding audio prefix);
* nemotron-4-340b (squared ReLU, 4 heads over 2 kv heads);
* mixtral-8x22b with ``sliding_window=8`` and q / kv blocks of 8, so
  the window bites inside the blocked forward and in decode, and the
  expert capacity raised to ``num_experts`` so that no token drops
  (forward and decode see different token counts), as
  ``tests/test_models_smoke.py::test_decode_consistent_with_forward``
  does; its MoE has no shared experts;
* phi3-mini-3.8b with ``pad_heads_multiple=3`` (4 heads padded to 6).

Stated tolerances, those of the other port tests: logits rtol 1e-4 /
atol 1e-5 (f32 summation order); loss and gradients rtol 1e-5 / atol
1e-6; a block in bf16 compute one bf16 ulp (rtol = atol = 2^-7);
everything the port holds against itself, and the pad slices'
gradients, exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_decode_states as jinit_states
from repro.models import init_params as jinit_params
from repro.models import next_token_loss as jloss
from repro.models import prefill_logits as jprefill_logits
from repro.models import transformer as jtransformer
from repro.serving import Engine as JEngine
from repro.serving import GenerationRequest as JRequest
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import (decode_step, forward, init_decode_states,
                                init_params, next_token_loss,
                                prefill_logits)
from repro_torch.models import transformer
from repro_torch.models.transformer import (leaf_grads, pytree_leaves,
                                            pytree_unflatten, tree_leaves)
from repro_torch.serving import Engine, GenerationRequest
from tests.torch_dist import one_cpu_thread

one_cpu_thread()

TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
MUSIC, NEMO, MIX, PHI = ("musicgen-medium", "nemotron-4-340b",
                         "mixtral-8x22b", "phi3-mini-3.8b")
VARIANTS = {
    MUSIC: dict(dtype="float32"),
    NEMO: dict(dtype="float32"),
    MIX: dict(dtype="float32", sliding_window=8, attn_q_block=8,
              attn_kv_block=8),
    PHI: dict(dtype="float32", pad_heads_multiple=3),
}


def _cfgs(arch, **kw):
    jc, tc = (jreduced(jget_config(arch), **kw),
              reduced(get_config(arch), **kw))
    if tc.moe is not None:
        jc, tc = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=float(c.moe.num_experts)))
            for c in (jc, tc))
    return jc, tc


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a, jnp.float32))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(_f32(t), _f32(j), **tol)


@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    """(arch, reference cfg, port cfg, reference params, port params):
    the port's init, carried to the reference as numpy and back into the
    port through ``params_from_numpy``."""
    jc, tc = _cfgs(request.param, **VARIANTS[request.param])
    tree = jax.tree.map(lambda t: t.numpy(), init_params(
        tc, torch.Generator().manual_seed(0), "cpu"))
    return (request.param, jc, tc, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu"))


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, 256, (b, s)
                                                ).astype(np.int32)


def test_init_tree_matches_reference(model):
    """The port's init makes the reference's tree: keys, pytree order,
    shapes and dtypes; a non-gated FFN has no ``w_gate``; the numpy tree
    comes back through ``params_from_numpy`` bit for bit; padded heads
    are zero slices of ``wq`` / ``wo`` in both packages' inits."""
    arch, jc, tc, jp, tp = model
    js = jax.eval_shape(lambda k: jinit_params(jc, k), jax.random.PRNGKey(0))
    assert [(a.shape, str(a.dtype)) for a in jax.tree.leaves(js)] == \
        [(tuple(b.shape), str(b.dtype).removeprefix("torch."))
         for b in pytree_leaves(tp)]
    for a, b in zip(jax.tree.leaves(jp), pytree_leaves(tp)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    ffn = tp["groups"]["l0"]["ffn"]
    assert ("w_gate" in ffn) == (tc.activation == "swiglu" or
                                 "router" in ffn)
    if tc.pad_heads_multiple:
        h = tc.num_heads
        ref = jax.jit(lambda k: jinit_params(jc, k))(jax.random.PRNGKey(0))
        for p in (tp, jax.tree.map(np.asarray, ref)):
            mix = p["groups"]["l0"]["mixer"]
            assert mix["wq"].shape[2] == mix["wo"].shape[1] == 6
            assert not np.asarray(mix["wq"][:, :, h:]).any()
            assert not np.asarray(mix["wo"][:, h:]).any()
            assert np.asarray(mix["wq"][:, :, :h]).any()


def test_forward_matches_reference(model):
    """``forward`` over 16 positions (musicgen: 8 tokens after its 8
    prefix embeddings)."""
    arch, jc, tc, jp, tp = model
    tok = _tokens(1, 2, 16)
    pre = None
    if tc.frontend_prefix_len:
        tok = tok[:, :8]
        pre = np.random.default_rng(2).standard_normal(
            (2, tc.frontend_prefix_len, tc.d_model)).astype(np.float32)
    jl = jax.jit(lambda p, t, e: jforward(p, jc, t, prefix_emb=e))(
        jp, jnp.asarray(tok), None if pre is None else jnp.asarray(pre))
    tl = forward(tp, tc, torch.from_numpy(tok),
                 None if pre is None else torch.from_numpy(pre))
    assert tl.shape == (2, 16, tc.vocab_size)
    _close(tl, jl)


def test_loss_and_gradients_match_reference(model):
    """``next_token_loss`` and every leaf's gradient; musicgen's loss
    through its prefix; padded heads' pad slices get exactly zero
    gradient."""
    arch, jc, tc, jp, tp = model
    toks = _tokens(4, 2, 17)
    t, lab = toks[:, :-1], toks[:, 1:]
    pre = None
    if tc.frontend_prefix_len:
        t, lab = t[:, :8], lab[:, :8]
        pre = np.random.default_rng(5).standard_normal(
            (2, tc.frontend_prefix_len, tc.d_model)).astype(np.float32)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jloss(
        p, jc, jnp.asarray(t), jnp.asarray(lab),
        None if pre is None else jnp.asarray(pre))))(jp)
    live = [x.clone().requires_grad_(True) for x in pytree_leaves(tp)]
    tl = next_token_loss(pytree_unflatten(tp, live), tc,
                         torch.from_numpy(t), torch.from_numpy(lab),
                         None if pre is None else torch.from_numpy(pre))
    tg = leaf_grads(tl, live)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **GRAD_TOL)
    for a, b in zip(jax.tree.leaves(jg), tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **GRAD_TOL)
    if tc.pad_heads_multiple:
        g = pytree_unflatten(tp, tg)["groups"]["l0"]["mixer"]
        h = tc.num_heads
        assert not g["wq"][:, :, h:].any() and not g["wo"][:, h:].any()
        assert g["wq"][:, :, :h].any() and g["wo"][:, :h].any()


def test_decode_matches_forward_and_reference(model):
    """An 8-token multi-token write into the cache, then single decode
    steps to 32 positions (mixtral: 24 past its window of 8): every
    position's logits equal the port's own forward and the reference's
    decode of the same chunks, and the caches the reference's."""
    arch, jc, tc, jp, tp = model
    if tc.frontend_prefix_len:
        jc, tc = (dataclasses.replace(c, frontend=None,
                                      frontend_prefix_len=0)
                  for c in (jc, tc))
    n = 32
    tok = _tokens(6, 2, n)
    full = forward(tp, tc, torch.from_numpy(tok))
    jstep = jax.jit(lambda p, t, s, q: jdecode_step(p, jc, t, s, q))
    js, ts = jinit_states(jc, 2, n), init_decode_states(tc, 2, n, "cpu")
    t_outs = []
    for a, b in [(0, 8)] + [(i, i + 1) for i in range(8, n)]:
        pos = np.broadcast_to(np.arange(a, b, dtype=np.int32), (2, b - a))
        jl, js = jstep(jp, jnp.asarray(tok[:, a:b]), js, jnp.asarray(pos))
        tl, ts = decode_step(tp, tc, torch.from_numpy(tok[:, a:b]), ts,
                             torch.from_numpy(np.ascontiguousarray(pos)))
        _close(tl, jl)
        t_outs.append(tl)
    _close(torch.cat(t_outs, 1), full)
    for a, b in zip(jax.tree.leaves(js), tree_leaves(ts)):
        _close(b, a)
    assert bool((ts["l0"].length == n).all())


def test_sliding_window_bites_in_decode():
    """The window is not vacuous: mixtral's decode past its window
    differs from the same decode with the window off, and equals the
    windowed forward."""
    jc, tc = _cfgs(MIX, **VARIANTS[MIX])
    tp = init_params(tc, torch.Generator().manual_seed(1), "cpu")
    tok = torch.from_numpy(_tokens(7, 1, 16))
    got = {}
    for w in (8, None):
        c = dataclasses.replace(tc, sliding_window=w)
        st = init_decode_states(c, 1, 16, "cpu")
        lg, _ = decode_step(tp, c, tok, st,
                            torch.arange(16, dtype=torch.int32)[None])
        got[w] = lg
        _close(lg, forward(tp, c, tok))
    assert torch.equal(got[8][:, :8], got[None][:, :8])
    assert (got[8][:, 8:] - got[None][:, 8:]).abs().max() > 1e-3


def test_multi_token_decode_step_matches_reference():
    """A [B, 4] ``decode_step`` on reduced phi3 from an empty cache, then
    another at length 4: logits and caches against the reference's."""
    jc, tc = _cfgs(PHI, dtype="float32")
    tp = init_params(tc, torch.Generator().manual_seed(0), "cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    tok = _tokens(8, 2, 8)
    jstep = jax.jit(lambda p, t, s, q: jdecode_step(p, jc, t, s, q))
    js, ts = jinit_states(jc, 2, 12), init_decode_states(tc, 2, 12, "cpu")
    for a in (0, 4):
        pos = np.broadcast_to(np.arange(a, a + 4, dtype=np.int32), (2, 4))
        jl, js = jstep(jp, jnp.asarray(tok[:, a:a + 4]), js,
                       jnp.asarray(pos))
        tl, ts = decode_step(tp, tc, torch.from_numpy(tok[:, a:a + 4]), ts,
                             torch.from_numpy(np.ascontiguousarray(pos)))
        assert tl.shape == (2, 4, tc.vocab_size)
        _close(tl, jl)
        for x, y in zip(jax.tree.leaves(js), tree_leaves(ts)):
            _close(y, x)


def test_prefill_logits_match_reference():
    """musicgen's ``prefill_logits`` with its prefix: the last position's
    logits, equal to the reference's and to the port's own forward's
    last position."""
    jc, tc = _cfgs(MUSIC, **VARIANTS[MUSIC])
    tp = init_params(tc, torch.Generator().manual_seed(2), "cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    tok = _tokens(9, 2, 8)
    pre = np.random.default_rng(10).standard_normal(
        (2, tc.frontend_prefix_len, tc.d_model)).astype(np.float32)
    tl = prefill_logits(tp, tc, torch.from_numpy(tok),
                        torch.from_numpy(pre))
    assert tl.shape == (2, 1, tc.vocab_size)
    _close(tl, jprefill_logits(jp, jc, jnp.asarray(tok), jnp.asarray(pre)))
    assert torch.equal(tl, forward(tp, tc, torch.from_numpy(tok),
                                   torch.from_numpy(pre))[:, -1:])


@pytest.mark.parametrize("arch", [MUSIC, NEMO])
def test_block_in_bf16_within_one_ulp(arch):
    """One whole attention + FFN block (gelu, squared ReLU) in bf16
    compute over 16 positions against the reference's."""
    jc, tc = _cfgs(arch)
    tp = init_params(tc, torch.Generator().manual_seed(3), "cpu")
    p = jax.tree.map(lambda t: t[0], tp["groups"]["l0"])
    jpb = jax.tree.map(lambda t: jnp.asarray(t.numpy()), p)
    x = np.random.default_rng(11).standard_normal(
        (2, 16, tc.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    jo, _ = jtransformer._apply_block(jpb, "attention", jx,
                                      jnp.asarray(pos), jc, None)
    to, _ = transformer._apply_block(
        p, "attention", torch.from_numpy(_f32(jx)).to(torch.bfloat16),
        torch.from_numpy(np.ascontiguousarray(pos)), tc, None)
    assert to.dtype == torch.bfloat16
    _close(to, jo, BF16_TOL)


def _fair_run(engine, request, params, cfg, prompts):
    eng = engine(params, cfg, max_seq_len=32, max_batch=2, fairness_cap=0.5)
    for (rid, tenant, n), p in zip((("A1", "A", 2), ("A2", "A", 2),
                                    ("B1", "B", 3)), prompts):
        eng.submit(request(prompt=p, max_new_tokens=n, tenant=tenant,
                           request_id=rid))
    eng.run()
    return eng.events, {r: list(eng.poll(r).tokens)
                        for r in ("A1", "A2", "B1")}


def test_fairness_cap_trace_and_tokens_match_reference():
    """``Engine(fairness_cap=0.5)`` at batch 2, two tenants (the setup of
    ``tests/test_scheduler.py``'s fairness test): the same event trace,
    ``defer_fairness`` included, and the same tokens as the reference's
    engine."""
    jc, tc = _cfgs(PHI, dtype="float32", frontend=None,
                   frontend_prefix_len=0)
    tp = init_params(tc, torch.Generator().manual_seed(0), "cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, 256, 6).astype(np.int32) for _ in range(3)]
    jev, jtok = _fair_run(JEngine, JRequest, jp, jc, prompts)
    tev, ttok = _fair_run(Engine, GenerationRequest, tp, tc, prompts)
    assert (1, "defer_fairness", "A2") in tev
    assert tev == [tuple(e) for e in jev]
    assert ttok == {k: [int(t) for t in v] for k, v in jtok.items()}
