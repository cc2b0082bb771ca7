"""Every configuration of the registry runs through the port in reduced
form on the CPU: parameters initialise, the forward pass (with the
frontend's prefix embeddings where the config has a frontend) and a
decode step give finite logits of the expected shapes, and the training
launcher's ``train`` takes a baseline step. No block variant is refused.
"""
import math

import pytest
import torch

from repro_torch.configs import REGISTRY, reduced
from repro_torch.launch import train as train_mod
from repro_torch.models import (decode_step, forward, init_decode_states,
                                init_params, multimodal)
from tests.torch_dist import one_cpu_thread

one_cpu_thread()


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_reduced_config_inits_forwards_decodes_and_trains(arch):
    cfg = reduced(REGISTRY[arch], dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(1))
    pre = None
    if cfg.frontend:
        pre = multimodal.stub_prefix_embeddings(
            torch.Generator().manual_seed(2), cfg, 2, "cpu")
        tok = tok[:, :16 - cfg.frontend_prefix_len]
    with torch.no_grad():
        logits = forward(params, cfg, tok, pre)
        assert logits.shape == (2, 16, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())
        st = init_decode_states(cfg, 2, 8, "cpu")
        lg, _ = decode_step(params, cfg, tok[:, :1], st,
                            torch.zeros((2, 1), dtype=torch.int32))
        assert lg.shape == (2, 1, cfg.vocab_size)
        assert bool(torch.isfinite(lg).all())
    res = train_mod.train(cfg, comm="baseline", steps=1,
                          seq_len=16 + cfg.frontend_prefix_len,
                          global_batch=2, device="cpu")
    assert math.isfinite(res["history"][0]["loss"])
