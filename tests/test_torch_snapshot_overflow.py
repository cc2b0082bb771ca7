"""Port parity, xLSTM's re-based snapshot blocks against their calibrated
escape pools: under ``KVCacheSpec(exact_capacity=False)`` the plan is
calibrated on the first prefill, and some later snapshot blocks overflow
its escape pool. The async engine then redoes each such block on the
sync path, wired raw. The reference has the same fixed-plan design
(``repro.serving.kv_cache``), so this holds the overflow against it: the
reference calibrates the same registry from the same prefill states, and
its sync container path, fed the very snapshot planes the port's async
engine framed, overflows the same blocks by the same number of sections.

Reduced xlstm-125m (d_model 256, 4 heads x 64, vocab 512), bf16
compute, on the CPU: 6 requests at batch 4, a 2-token prompt (the
calibration prefill), 40 new tokens, 8-token blocks, so the states drift
well past what the prefill showed. Counts are integers: exact.
"""
import dataclasses

import jax.numpy as jnp
import pytest

from repro.configs.base import ModelConfig as JConfig
from repro.core import CodecRegistry as JRegistry
from repro.models import ssm as jssm
from repro.serving import KVCacheSpec as JSpec
from repro.serving import PagedKVCache as JCache
from repro.serving import calibrate_cache as jcalibrate_cache
from repro_torch.configs import get_config, reduced
from repro_torch.core import CodecRegistry
from repro_torch.launch.serve import serve
from repro_torch.serving import KVCacheSpec, PagedKVCache
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving import scheduler
from tests.torch_dist import one_cpu_thread

one_cpu_thread()

KV_BLOCK, PROMPT, NEW_TOKENS = 8, 2, 40


@pytest.fixture(scope="module")
def async_run():
    """The port's async engine through the launcher, recording every
    block it framed on the device (arrays and whether its escape pool
    overflowed) and the states it calibrated on."""
    cfg = reduced(get_config("xlstm-125m"), frontend=None,
                  frontend_prefix_len=0, d_model=256, head_dim=64,
                  vocab_size=512)
    blocks, calib = [], []
    frame, calibrate = (tkv.PagedKVCache.encode_block_device,
                        scheduler.calibrate_cache)

    def framed(self, name, layer, arrays, *, start, tokens):
        out = frame(self, name, layer, arrays, start=start, tokens=tokens)
        blocks.append((name, layer, start, tokens,
                       [a.clone() for a in arrays], out is None))
        return out

    def calibrated(registry, cfg_, states, tokens, spec, **kw):
        calib.append((states, tokens))
        return calibrate(registry, cfg_, states, tokens, spec, **kw)

    tkv.PagedKVCache.encode_block_device = framed
    scheduler.calibrate_cache = calibrated
    try:
        res = serve(cfg, batch=4, requests=6, prompt_len=PROMPT,
                    new_tokens=NEW_TOKENS, kv_cache="qlc", kv_block=KV_BLOCK,
                    kv_paging="async", device="cpu", seed=0)
    finally:
        tkv.PagedKVCache.encode_block_device = frame
        scheduler.calibrate_cache = calibrate
    return cfg, res, blocks, calib


def _jstates(states):
    return {k: getattr(jssm, type(st).__name__)(
        *[jnp.asarray(a.numpy()) for a in st]) for k, st in states.items()}


def test_snapshot_overflow_is_the_references(async_run):
    """The reference calibrates the port's KV registry, entry for entry,
    from the same prefill; its sync container path overflows exactly the
    blocks the port's async engine redid, section for section, and so
    does the port's own sync path. The run overflows at least one block,
    and every request's tokens still equal the dense run's."""
    cfg, res, blocks, calib = async_run
    (states, tokens), = calib
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    jcfg = JConfig(**fields)
    jreg = JRegistry()
    jcalibrate_cache(jreg, jcfg, _jstates(states), tokens,
                     JSpec(block_tokens=KV_BLOCK, exact_capacity=False))
    reg_json = res["kv_registry"].to_json()
    ours = {e["name"]: e for e in CodecRegistry.from_json(
        reg_json).to_json_dict()["entries"]}
    theirs = {e["name"]: e for e in jreg.to_json_dict()["entries"]}
    assert ours == theirs
    ref = JCache(JSpec(block_tokens=KV_BLOCK, exact_capacity=False), jcfg,
                 jreg)
    port = PagedKVCache(KVCacheSpec(block_tokens=KV_BLOCK,
                                    exact_capacity=False), cfg,
                        CodecRegistry.from_json(reg_json), device="cpu")
    rows = []
    for name, layer, start, n, arrays, overflowed in blocks:
        r0, p0 = ref.overflow_sections, port.overflow_sections
        ref.encode_block_arrays(name, layer, [a.numpy() for a in arrays],
                                start=start, tokens=n)
        port.encode_block_arrays(name, layer, arrays, start=start, tokens=n)
        rows.append((overflowed, ref.overflow_sections - r0,
                     port.overflow_sections - p0))
    assert [o for o, r, p in rows] == [r > 0 for o, r, p in rows]
    assert [r for _, r, _ in rows] == [p for _, _, p in rows]
    n_over = sum(o for o, _, _ in rows)
    assert n_over > 0, "no block overflowed: the test shows nothing"
    st = res["stats"]
    assert st["prefetch"]["misses"] == n_over
    assert st["kv"]["overflow_sections"] == sum(r for _, r, _ in rows)
    print(f"{n_over} of {len(rows)} blocks overflowed, in the reference "
          "and the port alike")
    assert all(s.state == "finished" for s in res["outs"])
