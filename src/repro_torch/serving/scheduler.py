"""Continuous-batching serving engine (dense decode states).

The engine owns one padded active set of ``max_batch`` slots and drives
it step by step:

    Engine.submit(GenerationRequest) -> handle     (enqueue, no compute)
    Engine.step()                                  (admit + one batched
                                                    decode step)
    Engine.poll(handle) -> RequestStatus           (tokens so far)

Waiting requests claim free slots in submit order; each admitted prompt
prefills at batch 1 on fresh states and is scattered into its slot row.
Every step runs ONE ``decode_step`` over all slots (free slots feed token 0 at position 0;
every per-row op is row-independent, so padding rows do not perturb
active rows). This is the reference's ``kv_paging="sync"`` path with
``kv_spec=None``; block paging through the compressed pool, the async
window scan, the prefetch kernel and per-tenant fairness caps are not
ported yet.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode_step, init_decode_states
from repro_torch.models.transformer import tree_map
from repro_torch.serving.engine import prefill

_rid_counter = itertools.count()


@dataclasses.dataclass
class GenerationRequest:
    """One generation request: a prompt (1-D token array), a budget,
    and the tenant it belongs to."""
    prompt: Any
    max_new_tokens: int = 32
    tenant: str = "default"
    request_id: Optional[str] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{self.max_new_tokens}")
        if self.request_id is None:
            self.request_id = f"req{next(_rid_counter)}"


@dataclasses.dataclass(frozen=True)
class RequestStatus:
    """Snapshot of a request's lifecycle (``Engine.poll``)."""
    request_id: str
    tenant: str
    state: str                  # waiting | running | finished
    tokens: np.ndarray          # generated tokens so far, int32 [<= budget]


@dataclasses.dataclass
class _Seq:
    req: GenerationRequest
    state: str = "waiting"
    slot: Optional[int] = None
    toks: List[int] = dataclasses.field(default_factory=list)

    @property
    def rid(self) -> str:
        return self.req.request_id

    @property
    def prompt_len(self) -> int:
        return int(self.req.prompt.size)


class Engine:
    """Continuous-batching engine (see module docstring). Runs on the
    device of ``params["embed"]``."""

    def __init__(self, params, cfg: ModelConfig, *, max_seq_len: int,
                 max_batch: int = 4):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        self.max_seq_len = int(max_seq_len)
        self.max_batch = int(max_batch)
        self._seqs: Dict[str, _Seq] = {}
        self._waiting: List[str] = []
        self._slots: List[Optional[str]] = [None] * self.max_batch
        self._states = init_decode_states(cfg, self.max_batch,
                                          self.max_seq_len, self.device)
        self._step_idx = 0
        self._prefill_s = 0.0
        self._prefill_tokens = 0
        self._decode_s = 0.0
        self._decode_tokens = 0

    # ---- request lifecycle ----------------------------------------------

    def submit(self, req: GenerationRequest) -> str:
        """Enqueue a request; returns its handle (no compute happens
        until :meth:`step`)."""
        rid = req.request_id
        if rid in self._seqs:
            raise ValueError(f"duplicate request_id {rid!r}")
        if req.prompt.size + req.max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"request {rid!r} needs {req.prompt.size} prompt + "
                f"{req.max_new_tokens} new tokens > max_seq_len="
                f"{self.max_seq_len}")
        self._seqs[rid] = _Seq(req=req)
        self._waiting.append(rid)
        return rid

    def poll(self, handle: str) -> RequestStatus:
        seq = self._seqs[handle]
        return RequestStatus(request_id=seq.rid, tenant=seq.req.tenant,
                             state=seq.state,
                             tokens=np.asarray(seq.toks, np.int32))

    def step(self) -> int:
        """Admit what fits and run ONE batched decode step over the
        padded active set. Returns the number of requests still in
        flight (waiting + running)."""
        self._step_idx += 1
        self._admit()
        active = [(b, rid) for b, rid in enumerate(self._slots)
                  if rid is not None]
        if active:
            tokens = np.zeros((self.max_batch, 1), np.int32)
            pos = np.zeros((self.max_batch, 1), np.int32)
            for b, rid in active:
                seq = self._seqs[rid]
                tokens[b, 0] = seq.toks[-1]
                pos[b, 0] = seq.prompt_len + len(seq.toks) - 1
            t0 = time.perf_counter()
            lg, self._states = decode_step(
                self.params, self.cfg, self._tensor(tokens), self._states,
                self._tensor(pos))
            nxt = torch.argmax(lg[:, 0], dim=-1).cpu().numpy()  # syncs
            self._decode_s += time.perf_counter() - t0
            self._decode_tokens += len(active)
            for b, rid in active:
                seq = self._seqs[rid]
                seq.toks.append(int(nxt[b]))
                if len(seq.toks) >= seq.req.max_new_tokens:
                    self._finish(seq)
        return sum(1 for s in self._seqs.values()
                   if s.state in ("waiting", "running"))

    def run(self):
        """Drive :meth:`step` until every submitted request finished."""
        while self.step():
            pass

    # ---- admission -------------------------------------------------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _admit(self):
        while self._waiting and None in self._slots:
            self._start(self._seqs[self._waiting.pop(0)])

    def _start(self, seq: _Seq):
        b = self._slots.index(None)
        t0 = time.perf_counter()
        row = init_decode_states(self.cfg, 1, self.max_seq_len, self.device)
        logits, row = prefill(self.params, self.cfg,
                              self._tensor(seq.req.prompt[None, :]), row)
        first = int(torch.argmax(logits[0]))              # syncs
        self._prefill_s += time.perf_counter() - t0
        self._prefill_tokens += seq.prompt_len
        # in place: the slot's rows of the engine-owned states
        tree_map(lambda dst, src: dst[:, b:b + 1].copy_(src),
                 self._states, row)
        self._slots[b] = seq.rid
        seq.slot = b
        seq.state = "running"
        seq.toks = [first]
        if len(seq.toks) >= seq.req.max_new_tokens:
            self._finish(seq)

    def _finish(self, seq: _Seq):
        seq.state = "finished"
        if seq.slot is not None:
            self._slots[seq.slot] = None
            seq.slot = None

    # ---- accounting ------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Request states and ms/token for prefill and decode (host clock
        around work that ends in a device-to-host read)."""
        by_state: Dict[str, int] = {}
        for s in self._seqs.values():
            by_state[s.state] = by_state.get(s.state, 0) + 1
        return {
            "steps": self._step_idx,
            "requests": {st: by_state.get(st, 0) for st in
                         ("waiting", "running", "finished")},
            "prefill_tokens": self._prefill_tokens,
            "decode_tokens": self._decode_tokens,
            "ms_per_token_prefill": (1e3 * self._prefill_s
                                     / max(1, self._prefill_tokens)),
            "ms_per_token_decode": (1e3 * self._decode_s
                                    / max(1, self._decode_tokens)),
        }
