"""Continuous-batching serving engine over a shared compressed block pool.

The engine owns one padded active set of ``max_batch`` slots and drives
it step by step:

    Engine.submit(GenerationRequest) -> handle     (enqueue, no compute)
    Engine.step()                                  (admit + one batched
                                                    decode step + paging)
    Engine.poll(handle) -> RequestStatus           (tokens so far)

* **Admission** — waiting requests claim free slots in submit order;
  under a bounded ``BlockPool`` with host spill disabled, a
  projected-bytes check rejects a request with a typed ``PoolExhausted``
  instead of running out of memory mid-decode. Each admitted prompt
  prefills at batch 1 on fresh states and is copied into its slot row.
* **Decode** — ONE ``decode_step`` over all slots per engine step (free
  slots feed token 0 at position 0, in every step of an async window
  too). In a dense model every per-row op is row-independent, so padding
  rows do not perturb active rows. An MoE layer's capacity is shared by
  the step's rows, free ones included, so there the batch's
  composition is part of the result, as in the reference: two runs
  agree when they see the same requests in the same order at the same
  batch.
* **Paging** (``kv_spec`` given) — each slot pages its completed blocks
  through the shared :class:`~repro_torch.serving.kv_cache.PagedKVCache`
  codec into the global :class:`~repro_torch.comm.blockpool.BlockPool`,
  whose capacity is compressed bytes; identical blocks dedup by
  container digest. ``kv_paging="sync"`` encodes a block (K3), pools the
  host container and restores the slot's rows from the pooled bytes
  (K4), at the step that completes it. ``kv_paging="async"`` runs decode
  in windows up to the nearest block boundary (``window_step``: two
  uploads and one read-back per window), frames blocks on the card into
  a device ``BlockArena``, and decodes them through K5 on a side stream
  behind the next window (``PagedKVCache`` / ``BlockPrefetcher``).
  Both are token-identical to the dense engine and share one pool
  format.
* **Recurrent layers** (mamba, sLSTM, mLSTM) page their whole carried
  state at each block boundary. With ``KVCacheSpec.ssm_rebase`` (the
  default in ``"qlc"`` mode) admission prefills the prompt a block at a
  time and records every recurrent layer's state at each boundary, as
  do the decode steps and windows (a window never crosses one); the
  eviction of block ``[t0, t1)`` encodes the state at ``t1``, so
  requests sharing a prompt prefix of whole blocks pool one container.
  A re-based snapshot is never restored into the live state, which has
  absorbed tokens past ``t1``; without re-basing the live state is
  encoded and continues from the pooled bytes. Each layer's newest
  snapshot supersedes the previous one in the pool.

* **Fairness** (``fairness_cap``) — no tenant holds more than
  ``ceil(cap * max_batch)`` slots at once; a waiting request over its
  tenant's cap is skipped (a ``defer_fairness`` event) and later ones
  may take the free slot.

* **A model row** (``mesh``, a ``launch.mesh.Mesh``) — every rank of
  the row runs the same engine on its local tree
  (``convert.shard_params``): decode states at its local shapes
  (``models.init_decode_states`` with the row: its KV heads, mamba
  channels, xLSTM heads), each step's collectives inside the layers, and
  the same logits and tokens on every rank. The paged cache's channels
  bind the group of ``KVCacheSpec.axis`` (cold blocks migrate over it,
  ``all_gather_block_wire``); its codecs are calibrated on the row's
  gathered first prefill, identical on every rank, and each rank pages
  its own part's blocks. Every host branch on rank-local numbers (a
  pool's bytes, a rank's own ``PoolExhausted``) is agreed over the row
  (``launch.mesh.mesh_max`` / ``mesh_all``, over every rank of the
  mesh), so ``Engine.events`` is the same on every rank. A ``1 x 1``
  mesh runs exactly as no mesh.

* **The data column**, by the sharding rules in scope at construction
  (``parallel.sharding``), as the reference's GSPMD lays the decode
  states out:

  - the default rules (``batch -> data``): the slots split over the
    column. Every rank runs the same host schedule over all
    ``max_batch`` slots (submit order, the lowest free slot first, the
    fairness cap over all slots); slot ``s`` lives on data replica ``s //
    (max_batch / data)``, whose ranks hold its decode states and run its
    prefill, decode steps and paging, each replica over its own model
    row. After every decode step (a window, async) the column
    all-gathers the new tokens, and after every admission the first
    ones, so ``poll()``, ``events`` and ``stats()``'s counts are the
    same on every rank. The replica that runs the first admitted
    prefill calibrates the KV codecs and broadcasts them over the
    column;
  - a sequence split of the KV caches (``launch.mesh.kv_seq_shard``):
    ``make_rules(decode_seq_shard=True)`` (``kv_seq -> data``, ``batch
    -> None``), or the reference's decode rules
    (``parallel.sharding.decode_rules``: ``kv_seq -> model`` with the
    slots split as above, ``kv_seq -> ("data", "model")`` with ``batch
    -> None``). Each attention layer's cache holds positions ``[i *
    S/N, (i + 1) * S/N)`` on index ``i`` of the shard's ``N`` ranks
    (``d * model + m`` over the mesh), ``S`` (``max_seq_len``) rounded up
    to a multiple of ``N`` blocks; over the model axis every KV head of
    them, over the data column alone the heads of the row's cut. A
    prompt prefills whole, over its row's heads, on every rank that
    serves its slot, which keeps its range (gathering the row's heads
    when its range holds every head); a decode step writes each token on
    the rank whose range holds it and combines the shard's partial
    attentions (``models.attention.combine_partials``). Recurrent
    states stay as the row cuts them. Each rank pages the blocks of its
    range, sync or async (every rank computes the async window from the
    same host state, every slot's, so it ends on the same block boundary
    on every rank); the codecs are calibrated on the whole first
    prefill.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.comm.blockpool import (ArenaExhausted, BlockArena,
                                        BlockPool, PoolExhausted)
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import (kv_seq_shard, mesh_all, mesh_max,
                                     model_row, use_mesh)
from repro_torch.models import attention as attn
from repro_torch.models import decode_step, init_decode_states, ssm
from repro_torch.models.transformer import tree_map
from repro_torch.parallel.sharding import (ShardingRules, fsdp_params,
                                           get_rules, use_rules)
from repro_torch.serving.engine import prefill, window_step
from repro_torch.serving.kv_cache import (KVCacheSpec, PagedKVCache,
                                          SSMBoundaryTracker,
                                          broadcast_kv_entries,
                                          calibrate_cache,
                                          gather_row_states)

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
    state: str                  # waiting | running | finished | rejected
    tokens: np.ndarray          # generated tokens so far, int32 [<= budget]
    error: Optional[str] = None


@dataclasses.dataclass
class _Seq:
    req: GenerationRequest
    state: str = "waiting"
    slot: Optional[int] = None
    toks: List[int] = dataclasses.field(default_factory=list)
    evicted: int = 0            # tokens behind this sequence's cold blocks
    digests: List[str] = dataclasses.field(default_factory=list)
    #: layer key -> digest of its newest pooled SSM snapshot
    snap_digests: Dict[str, str] = dataclasses.field(default_factory=dict)
    error: Optional[str] = None

    @property
    def rid(self) -> str:
        return self.req.request_id

    @property
    def prompt_len(self) -> int:
        return int(self.req.prompt.size)

    @property
    def absorbed(self) -> int:
        """Tokens written into this sequence's cache so far (the last
        generated token has not been fed back yet)."""
        return self.prompt_len + max(0, len(self.toks) - 1)


def _slot_view(states, b: int):
    """Batch row ``b`` of the decode states, as views (every leaf is
    ``[n_groups, batch, ...]``)."""
    return tree_map(lambda a: a[:, b:b + 1], states)


def replica_requests(events, max_batch: int, replicas: int
                     ) -> List[List[str]]:
    """Replay an engine's ``events`` (admissions take the lowest free
    slot, a finish or rejection frees it) -> the request ids each of
    ``replicas`` data replicas served, in admission order: slot ``s``
    lives on replica ``s // (max_batch / replicas)``."""
    slots: List[Optional[str]] = [None] * max_batch
    out: List[List[str]] = [[] for _ in range(replicas)]
    for _, event, rid in events:
        if event == "admit":
            b = slots.index(None)
            slots[b] = rid
            out[b // (max_batch // replicas)].append(rid)
        elif event in ("finish", "reject") and rid in slots:
            slots[slots.index(rid)] = None
    return out


class Engine:
    """Continuous-batching engine (see module docstring). Runs on the
    device of ``params["embed"]``.

    ``kv_spec`` switches on compressed block paging into ``pool``
    (default: an effectively unbounded ``BlockPool``); ``registry`` is
    calibrated from the FIRST admitted request's prefill states when it
    lacks the ``kv/layer{i}`` entries. ``kv_paging="async"`` needs
    ``KVCacheSpec(mode="qlc", exact_capacity=False)`` and keeps up to
    ``arena_slots`` evicted blocks in a device arena. ``monitor`` (a
    ``repro_torch.adaptive.TrafficMonitor`` over ``registry``) goes to the
    block codec (``PagedKVCache(monitor=)``). ``fairness_cap`` (0 < cap
    <= 1) bounds any one tenant to ``ceil(cap * max_batch)`` concurrent
    slots. ``mesh``: ``params`` is this rank's local tree over the
    mesh's model row, which every rank of the row serves in step; over
    a data column the slots split, and, under rules in scope that put
    ``kv_seq`` on mesh axes, the KV caches' sequence splits over them
    (module docstring). ``prefill_chunk``: tokens a prefill
    feeds per decode step (``serving.engine.prefill``; attention-only
    stacks); 1, the default, feeds them one at a time. Under rules in
    scope that cut parameters by FSDP, ``params`` holds each FSDP leaf as
    the rank's ``data x model`` block (and, with ``weight_codec``, the
    layer stack as its wire, each compressed leaf's chunks cut over the
    data column: ``serving.engine.place_wire``); each decode and prefill
    step gathers a group's blocks over the column as it runs, every rank
    in step. ``weight_codec``: ``params["groups"]`` is a weight wire,
    opened a group at a time inside each decode step.
    """

    def __init__(self, params, cfg: ModelConfig, *, max_seq_len: int,
                 max_batch: int = 4, kv_spec: Optional[KVCacheSpec] = None,
                 registry=None, pool: Optional[BlockPool] = None,
                 fairness_cap: Optional[float] = None, mesh=None,
                 kv_paging: str = "sync", arena_slots: int = 256,
                 monitor=None, prefill_chunk: int = 1, weight_codec=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if kv_paging not in ("sync", "async"):
            raise ValueError(f"kv_paging must be 'sync' or 'async', got "
                             f"{kv_paging!r}")
        if kv_paging == "async" and (kv_spec is None or kv_spec.mode != "qlc"
                                     or kv_spec.exact_capacity):
            raise ValueError(
                "kv_paging='async' needs KVCacheSpec(mode='qlc', "
                "exact_capacity=False): the fixed plan geometry is what "
                "lets the card frame block containers itself")
        self.params = params
        self.weight_codec = weight_codec
        self.cfg = cfg
        self.mesh = mesh
        self._row = model_row(mesh) if mesh is not None else None
        #: host branches on rank-local numbers are agreed over the mesh
        self._agreeing = mesh is not None and mesh.size > 1
        self._rules = get_rules()
        self.device = params["embed"].device
        self.max_seq_len = int(max_seq_len)
        self.max_batch = int(max_batch)
        self.prefill_chunk = int(prefill_chunk)
        self._split, self._shard = self._data_layout(mesh)
        #: under FSDP every rank of a column gathers each group's blocks
        #: in every decode step and prefill step, so the replicas of a
        #: data split step together: a rank with no slot of its own
        #: decodes its free slots, and each prefills every admitted
        #: request, keeping its own
        self._lockstep = self._split > 1 and fsdp_params(self._rules)
        #: this rank's slots: [first, first + local)
        self._local = self.max_batch // self._split
        self._first = (mesh.coords[0] * self._local if self._split > 1
                       else 0)
        state_len = self.max_seq_len
        if self._shard is not None:
            unit = self._shard.size * (kv_spec.block_tokens
                                       if kv_spec is not None else 1)
            self.max_seq_len = -(-self.max_seq_len // unit) * unit
            state_len = self.max_seq_len // self._shard.size
            if self._gathers_row():
                # the row's cut (models.decode_state_cut) takes each
                # rank's range of the positions its data index holds
                state_len *= self._row.size
            #: a prompt prefills whole on every rank
            self._whole_rules = ShardingRules(
                rules=dict(self._rules.rules, kv_seq=None),
                param_overrides=self._rules.param_overrides)
        self.kv_spec = kv_spec
        if kv_spec is not None and registry is None:
            from repro_torch.core.registry import CodecRegistry
            registry = CodecRegistry()
        self.registry = registry
        if kv_spec is not None and pool is None:
            pool = BlockPool(1 << 50)       # effectively unbounded
        self.pool = pool
        self.kv_paging = kv_paging
        self._arena_slots = int(arena_slots)
        self._codec: Optional[PagedKVCache] = None
        self.monitor = monitor
        self._kinds = cfg.layer_kinds()
        self._tenant_cap = (None if fairness_cap is None
                            else max(1, math.ceil(fairness_cap * max_batch)))
        #: boundary-state snapshots for SSM re-basing (qlc only)
        self._snaps = SSMBoundaryTracker()
        self._rebase = (kv_spec is not None and kv_spec.ssm_rebase
                        and any(k != "attention" for k in self._kinds))
        self._seqs: Dict[str, _Seq] = {}
        #: requests this rank prefilled in the current admission
        self._prefilled: set = set()
        self._waiting: List[str] = []
        self._slots: List[Optional[str]] = [None] * self.max_batch
        self._states = init_decode_states(cfg, self._local, state_len,
                                          self.device, row=self._row)
        #: prefetches scheduled at the last block boundary, consumed after
        #: the NEXT window: (rid, handle)
        self._pending: List[tuple] = []
        self._windows = 0
        self._window_h2d = 0        # host->device uploads per async run
        self._window_d2h = 0        # device->host reads per async run
        #: deterministic scheduling trace: (step, event, request_id)
        self.events: List[tuple] = []
        self._step_idx = 0
        self._prefill_s = 0.0
        self._prefill_tokens = 0
        self._decode_s = 0.0
        self._decode_tokens = 0
        self._dense_of: Dict[str, int] = {}     # digest -> dense bytes
        self._dense_logical = 0
        self.peak_dense_logical_bytes = 0

    def _data_layout(self, mesh):
        """(slot replicas over the data column, the KV caches' sequence
        shard or None), as the rules in scope lay the decode states'
        batch and ``kv_seq`` out over ``mesh``: the batch over ``data``
        or whole, ``kv_seq`` over ``data``, ``model``, both or none
        (``launch.mesh.kv_seq_shard``)."""
        if mesh is None:
            return 1, None
        batch = self._rules.spec(("batch",), mesh=mesh)[0]
        split = 1
        if batch == "data":
            if self.max_batch % mesh.data:
                raise ValueError(
                    f"max_batch {self.max_batch} does not divide over the "
                    f"data axis of {mesh.data}: its slots split over the "
                    "data column")
            split = mesh.data
        elif batch is not None:
            raise ValueError(f"batch over {batch!r}: an engine's slots "
                             "split over the data axis alone, or stay whole")
        return split, kv_seq_shard(mesh)

    def _gathers_row(self) -> bool:
        """Whether a sequence shard over the model axis makes each rank of
        a model row hold every KV head of its range, so that a prefill,
        which holds the row's cut of the heads, is gathered over the
        row."""
        return (self._shard is not None and self._shard.over_model
                and self._row is not None)

    def _mine(self, b: int) -> Optional[int]:
        """Slot ``b``'s row of this rank's decode states, or None when it
        lives on another data replica."""
        i = b - self._first
        return i if 0 <= i < self._local else None

    def _gather_column(self, mine: np.ndarray) -> np.ndarray:
        """This replica's rows of a per-slot int array, all-gathered over
        the data column into every slot's, in slot order (one host-side
        collective); unchanged when the slots do not split."""
        if self._split == 1:
            return mine
        import torch.distributed as dist
        t = torch.from_numpy(np.ascontiguousarray(mine, np.int64))
        got = [torch.empty_like(t) for _ in range(self._split)]
        dist.all_gather(got, t, group=self.mesh.data_group)
        return torch.cat(got).numpy()

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
        self._log("submit", rid)
        return rid

    def poll(self, handle: str) -> RequestStatus:
        seq = self._seqs[handle]
        return RequestStatus(request_id=seq.rid, tenant=seq.req.tenant,
                             state=seq.state,
                             tokens=np.asarray(seq.toks, np.int32),
                             error=seq.error)

    def _active(self):
        return [(b, rid) for b, rid in enumerate(self._slots)
                if rid is not None]

    def _seed(self, active):
        """Each of this rank's slots' last token and its position, int32
        [B, 1] each, in one upload; a free slot's are token 0 at position
        0."""
        seed = np.zeros((self._local, 2), np.int32)
        for b, rid in active:
            seq = self._seqs[rid]
            seed[self._mine(b)] = (seq.toks[-1],
                                   seq.prompt_len + len(seq.toks) - 1)
        seed = self._tensor(seed)
        return seed[:, :1].contiguous(), seed[:, 1:].contiguous()

    def step(self) -> int:
        """Admit what fits, run ONE batched decode step over the padded
        active set (one window of steps under ``kv_paging="async"``),
        page completed blocks. Returns the number of requests still in
        flight (waiting + running). With a mesh, inside
        ``use_mesh(mesh)``."""
        if self.mesh is None:
            return self._step()
        with use_mesh(self.mesh), use_rules(self._rules):
            return self._step()

    def _step(self) -> int:
        if self.kv_paging == "async":
            return self._step_async()
        self._step_idx += 1
        self._admit()
        active = self._active()
        if active:
            mine = [(b, rid) for b, rid in active
                    if self._mine(b) is not None]
            nxt = np.zeros(self._local, np.int64)
            t0 = time.perf_counter()
            if mine or self._lockstep:
                tokens, pos = self._seed(mine)
                lg, self._states = decode_step(
                    self.params, self.cfg, tokens, self._states, pos,
                    weight_codec=self.weight_codec)
                nxt = torch.argmax(lg[:, 0], dim=-1).cpu().numpy()  # syncs
            self._decode_s += time.perf_counter() - t0
            nxt = self._gather_column(nxt)
            self._decode_tokens += len(active)
            for b, rid in active:
                seq = self._seqs[rid]
                seq.toks.append(int(nxt[b]))
                self._note_boundary(seq)
                self._page_and_maybe_finish(seq)
        return self._in_flight()

    def _step_async(self) -> int:
        """One window of decode steps: the window ends exactly at the
        nearest block boundary or budget across active slots, so blocks
        are only evicted between windows. The host uploads one seed token
        and position per slot, and which slots are free, and reads the
        window's tokens back once (2 up, 1 down). The prefetch decodes
        scheduled at the last boundary ran on the side stream behind this
        window; they are consumed (a wait on their done events, timed: a
        stall is the cost prefetch failed to hide) and applied after
        it."""
        self._step_idx += 1
        self._admit()
        active = self._active()
        if active:
            bt = self.kv_spec.block_tokens
            hot = self.kv_spec.hot_blocks
            window = min(
                min(s.req.max_new_tokens - len(s.toks),
                    s.evicted + (1 + hot) * bt - s.absorbed,
                    # re-basing records every recurrent layer's state
                    # at each boundary, so no window crosses one
                    bt - s.absorbed % bt if self._rebase else bt)
                for s in (self._seqs[rid] for _, rid in active))
            window = max(1, window)
            mine = [(b, rid) for b, rid in active
                    if self._mine(b) is not None]
            gen = np.zeros((self._local, window), np.int64)
            t0 = time.perf_counter()
            if mine or self._lockstep:
                tokens, pos = self._seed(mine)
                free = self._tensor(np.array(
                    [[rid is None] for rid in self._slots[
                        self._first:self._first + self._local]]))
                self._window_h2d += 2
                gen_dev, self._states = window_step(
                    self.params, self.cfg, tokens, pos, self._states,
                    window, free=free, weight_codec=self.weight_codec)
                gen = gen_dev.cpu().numpy()  # ONE read-back for the window
                self._window_d2h += 1
            self._windows += 1
            ready = self._consume_pending()
            self._decode_s += time.perf_counter() - t0
            gen = self._gather_column(gen)
            self._decode_tokens += len(active) * window
            self._apply_pending(ready)
            for b, rid in active:
                seq = self._seqs[rid]
                if seq.state != "running":      # rejected at consume
                    continue
                seq.toks.extend(int(t) for t in gen[b, :window])
                self._note_boundary(seq)
                self._page_and_maybe_finish(seq)
        return self._in_flight()

    def _agree(self, err: Optional[PoolExhausted]
               ) -> Optional[PoolExhausted]:
        """``err``, or, over a mesh, the ``PoolExhausted`` any rank of it
        met (each rank's pool holds its own blocks' bytes): every rank
        then takes the same branch."""
        if self._agreeing and not mesh_all(err is None, self.mesh) \
                and err is None:
            err = PoolExhausted("another rank of the mesh ran out of pool")
        return err

    def _agreed(self, fn) -> Optional[PoolExhausted]:
        """Run ``fn`` and return its ``PoolExhausted``, agreed over the
        mesh (:meth:`_agree`)."""
        try:
            fn()
        except PoolExhausted as e:
            return self._agree(e)
        return self._agree(None)

    def _page_and_maybe_finish(self, seq: _Seq):
        err = self._agreed(lambda: self._page(seq))
        if err is not None:
            self._reject(seq, err)
            return
        if len(seq.toks) >= seq.req.max_new_tokens:
            self._finish(seq)

    def _in_flight(self) -> int:
        return sum(1 for s in self._seqs.values()
                   if s.state in ("waiting", "running"))

    def run(self):
        """Drive :meth:`step` until every submitted request finished or
        was rejected."""
        while self.step():
            pass

    # ---- admission -------------------------------------------------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _admit(self):
        admitted = []
        for rid in list(self._waiting):
            if None not in self._slots:
                break
            seq = self._seqs[rid]
            if self._tenant_cap is not None and \
                    self._tenant_active(seq.req.tenant) >= self._tenant_cap:
                self._log("defer_fairness", rid)
                continue
            self._waiting.remove(rid)
            if self.pool is not None and self.kv_spec is not None:
                projected = self._projected_bytes(seq)
                err = self._agreed(
                    lambda: self.pool.check_admission(projected))
                if err is not None:
                    self._reject(seq, err, event="reject_admission")
                    continue
            self._start(seq)
            admitted.append(seq)
        if self._split > 1 and admitted:
            # each first token is known on its replica alone
            first = self._gather_column(np.array(
                [[s.toks[0] if s.rid in self._prefilled else 0
                  for s in admitted]], np.int64))
            for seq, tok in zip(admitted, first.sum(axis=0)):
                seq.toks[0] = int(tok)
        self._prefilled.clear()

    def _tenant_active(self, tenant: str) -> int:
        return sum(1 for rid in self._slots if rid is not None
                   and self._seqs[rid].req.tenant == tenant)

    def _projected_bytes(self, seq: _Seq) -> float:
        """Projected compressed footprint of a request, in the pool's
        measured mean-block-bytes unit (0 before any block pooled). Over
        a mesh each rank's pool measures its own blocks, so the unit is
        the mesh's largest mean: the most any rank's part of the request
        is projected to hold (its check is then agreed over the mesh,
        :meth:`_agreed`)."""
        mean = self.pool.mean_block_bytes()
        if self._agreeing:
            mean = mesh_max(mean, self.mesh)
        if not mean:
            return 0.0
        bt = self.kv_spec.block_tokens
        total = seq.prompt_len + seq.req.max_new_tokens - 1
        n_blocks = max(0, total // bt - self.kv_spec.hot_blocks)
        return mean * n_blocks * len(self._kinds)

    def _start(self, seq: _Seq):
        b = self._slots.index(None)
        local = self._mine(b)
        row = None
        first = 0
        whole = None
        if local is None and self._lockstep:
            self._prefill(seq, owned=False)    # in step with its replica's
        if local is not None:
            first, row = self._prefill(seq)
            if self._gathers_row():
                with use_rules(self._whole_rules):
                    whole = gather_row_states(self.cfg, row, seq.prompt_len,
                                              self._row)
        self._prefill_tokens += seq.prompt_len
        if self.kv_spec is not None and self._codec is None:
            self._ensure_codec(row if whole is None else whole,
                               seq.prompt_len, b // self._local,
                               gathered=whole is not None)
        if row is not None:
            if self._shard is not None:
                row = self._my_range(row, whole)
            # in place: the slot's rows of the engine-owned states
            tree_map(lambda dst, src: dst.copy_(src),
                     _slot_view(self._states, local), row)
            self._prefilled.add(seq.rid)
        self._slots[b] = seq.rid
        seq.slot = b
        seq.state = "running"
        seq.toks = [first]
        self._log("admit", seq.rid)
        self._page_and_maybe_finish(seq)    # prompt blocks page out now

    def _prefill(self, seq: _Seq, owned: bool = True):
        """Prefill ``seq``'s prompt at batch 1 on fresh states, whole
        (every position, under a sequence shard too) -> (its first token,
        the states). ``owned=False``: a rank that only keeps its
        replica's FSDP gathers in step records no boundary states and no
        prefill time for it."""
        t0 = time.perf_counter()
        prompt = self._tensor(seq.req.prompt[None, :])
        rules = self._whole_rules if self._shard is not None else \
            self._rules
        with use_rules(rules):
            row = init_decode_states(self.cfg, 1, self.max_seq_len,
                                     self.device, row=self._row)
            if self._rebase:
                # Segmented prefill: a block at a time, each recurrent
                # layer's state recorded at every boundary. Prefill
                # feeds token by token, so this is the whole prompt's
                # states.
                bt = self.kv_spec.block_tokens
                pos = 0
                while pos < seq.prompt_len:
                    end = min(seq.prompt_len, (pos // bt + 1) * bt)
                    logits, row = prefill(self.params, self.cfg,
                                          prompt[:, pos:end], row,
                                          start_pos=pos,
                                          chunk=self.prefill_chunk,
                                          weight_codec=self.weight_codec)
                    pos = end
                    if owned and pos % bt == 0:
                        self._record_boundary_states(seq, row, pos)
            else:
                logits, row = prefill(self.params, self.cfg, prompt, row,
                                      chunk=self.prefill_chunk,
                                      weight_codec=self.weight_codec)
        first = int(torch.argmax(logits[0]))              # syncs
        if owned:
            self._prefill_s += time.perf_counter() - t0
        return first, row

    def _states_len(self) -> int:
        """Positions of this rank's KV caches (the engine's states)."""
        for st in self._states.values():
            if isinstance(st, attn.KVCache):
                return st.k.shape[attn.KV_SEQ_AXIS]
        return self.max_seq_len

    def _offset(self) -> int:
        """The first position of this rank's range of the KV caches."""
        return 0 if self._shard is None else \
            self._shard.index * self._states_len()

    def _my_range(self, states, whole=None):
        """This rank's range of positions of a prefill's attention caches
        (a sequence shard), taken from ``whole`` (the row's gathered
        states over the prompt's positions, where each rank holds every
        KV head) or from ``states``; other states as ``states`` holds
        them."""
        n, off = self._states_len(), self._offset()

        def part(a):
            have = max(0, min(off + n, a.shape[attn.KV_SEQ_AXIS]) - off)
            if have == n:
                return a.narrow(attn.KV_SEQ_AXIS, off, n)
            shape = list(a.shape)
            shape[attn.KV_SEQ_AXIS] = n
            out = a.new_zeros(shape)
            if have:
                out.narrow(attn.KV_SEQ_AXIS, 0, have).copy_(
                    a.narrow(attn.KV_SEQ_AXIS, off, have))
            return out
        src = states if whole is None else whole
        return {key: src[key]._replace(k=part(src[key].k), v=part(src[key].v))
                if isinstance(st, attn.KVCache) else st
                for key, st in states.items()}

    def _ensure_codec(self, row_states, tokens: int, owner: int = 0,
                      gathered: bool = False):
        """Build the shared block codec, calibrating the registry's
        ``kv/layer{i}`` entries from the first prefill when absent
        (``gathered``: ``row_states`` are already the whole model's).
        With the slots split over the data column, data replica
        ``owner`` ran that prefill: it calibrates, over its model row,
        and broadcasts the entries over the column."""
        base = self.kv_spec.layer_codec(0)
        if not any(n == base or n.startswith(base + "/")
                   for n in self.registry.names()):
            if row_states is not None:
                calibrate_cache(self.registry, self.cfg, row_states, tokens,
                                self.kv_spec,
                                mesh=None if gathered else self.mesh)
            if self._split > 1:
                broadcast_kv_entries(self.registry, self.kv_spec.codec_prefix,
                                     self.mesh, owner)
        self._codec = PagedKVCache(self.kv_spec, self.cfg, self.registry,
                                   device=self.device, monitor=self.monitor,
                                   mesh=self.mesh)

    # ---- paging through the shared pool ---------------------------------

    def _page(self, seq: _Seq):
        if self._codec is None:
            return
        bt = self.kv_spec.block_tokens
        hot = self.kv_spec.hot_blocks
        evict = (self._evict_slot_async if self.kv_paging == "async"
                 else self._evict_slot)
        mine = self._mine(seq.slot) is not None
        while seq.evicted + (1 + hot) * bt <= seq.absorbed:
            t0 = seq.evicted
            if mine:
                evict(seq, t0, t0 + bt)
            seq.evicted = t0 + bt

    def _record_boundary_states(self, seq: _Seq, row, t: int):
        """Copy every recurrent layer's state at boundary ``t`` (the
        state after absorbing exactly ``t`` tokens) for a later re-based
        eviction."""
        snap = {f"l{i}": tuple(a.clone() for a in
                               ssm.state_snapshot(row[f"l{i}"]))
                for i, kind in enumerate(self._kinds)
                if kind != "attention"}
        if snap:
            self._snaps.record(seq.rid, t, snap)

    def _note_boundary(self, seq: _Seq):
        """Record the boundary states the moment a running sequence's
        absorbed count lands on a block boundary (re-basing only)."""
        if not self._rebase or seq.slot is None or \
                self._mine(seq.slot) is None:
            return
        if seq.absorbed > 0 and seq.absorbed % self.kv_spec.block_tokens == 0:
            self._record_boundary_states(
                seq, _slot_view(self._states, self._mine(seq.slot)),
                seq.absorbed)

    def _evict_slot(self, seq: _Seq, t0: int, t1: int):
        """Encode one completed block of ``seq``'s slot row into the pool
        and decode it back from the POOLED container: an attention
        layer's rows and a live recurrent state are restored from those
        shared (deduped) bytes; a re-based snapshot (the state at
        ``t1``) is decoded, so an overflowing container surfaces here,
        but never restored. Under a sequence shard an attention layer's
        block is paged by the rank whose range holds it."""
        row = _slot_view(self._states, self._mine(seq.slot))
        bsnap = self._snaps.take(seq.rid, t1) if self._rebase else None
        off = self._offset()
        for i, kind in enumerate(self._kinds):
            key = f"l{i}"
            name = self.kv_spec.layer_codec(i)
            if kind == "attention":
                if not off <= t0 < off + self._states_len():
                    continue
                k, v = attn.kv_block_slice(row[key], t0 - off, t1 - off)
                block = self._codec.encode_block_arrays(
                    name, key, (k, v), start=t0, tokens=t1 - t0)
                digest = self._pool_put(seq, block)
                k2, v2 = self._codec.decode_block_arrays(
                    self.pool.get(digest))
                attn.kv_block_restore(row[key], t0 - off, t1 - off, k2, v2)
                continue
            rebased = bsnap is not None and key in bsnap
            arrays = bsnap[key] if rebased else ssm.state_snapshot(row[key])
            block = self._codec.encode_block_arrays(
                name, key, arrays, start=t1, tokens=t1 - t0)
            digest = self._pool_put(seq, block)
            decoded = self._codec.decode_block_arrays(self.pool.get(digest))
            if not rebased:
                for dst, src in zip(row[key],
                                    ssm.state_restore(row[key], decoded)):
                    dst.copy_(src)
            self._supersede_snapshot(seq, key, digest)

    def _supersede_snapshot(self, seq: _Seq, key: str, digest: str):
        """The newest snapshot of a recurrent layer replaces its previous
        one in the pool."""
        old = seq.snap_digests.get(key)
        if old is not None:
            self._pool_release(seq, old)
        seq.snap_digests[key] = digest

    # ---- async paging (device arena + prefetch) --------------------------

    def _ensure_arena(self, slot_words: int) -> BlockArena:
        if self._codec.arena is None:
            arena = BlockArena(self._arena_slots, slot_words, self.device)
            self._codec.arena = arena
            if self.pool.arena is None:
                self.pool.arena = arena
        return self._codec.arena

    def _evict_slot_async(self, seq: _Seq, t0: int, t1: int):
        """Async twin of :meth:`_evict_slot`: frame every layer's block on
        the card, park the words in the arena, and SCHEDULE the prefetch
        decode, consumed after the next window (:meth:`_consume_pending`).
        Escape overflow under the plan capacity redoes the boundary on
        the sync host path (counted as a prefetch miss)."""
        row = _slot_view(self._states, self._mine(seq.slot))
        bsnap = self._snaps.take(seq.rid, t1) if self._rebase else None
        off = self._offset()
        devs = []
        for i, kind in enumerate(self._kinds):
            key = f"l{i}"
            if kind == "attention":
                if not off <= t0 < off + self._states_len():
                    continue            # another rank's range holds it
                arrays = attn.kv_block_slice(row[key], t0 - off, t1 - off)
                start = t0
            elif bsnap is not None and key in bsnap:
                arrays, start = bsnap[key], t1
            else:
                arrays, start = ssm.state_snapshot(row[key]), t1
            dev = self._codec.encode_block_device(
                self.kv_spec.layer_codec(i), key, arrays, start=start,
                tokens=t1 - t0)
            if dev is None:
                self._codec.prefetcher.miss()
                if bsnap is not None:
                    self._snaps.record(seq.rid, t1, bsnap)   # un-take
                self._evict_slot(seq, t0, t1)
                return
            devs.append(dev)
        if not devs:
            return
        arena = self._ensure_arena(max(d.plan.total_words for d in devs))
        for dev in devs:
            try:
                slot, gen = arena.alloc()
                arena.write(slot, dev.words)
                dev.slot, dev.gen = slot, gen
            except ArenaExhausted:
                dev.slot = None     # decode straight from the framed words
            self._pending.append(
                (seq.rid, self._codec.prefetcher.schedule(dev)))

    def _consume_pending(self):
        """Wait on the prefetch decodes scheduled at the last boundary:
        arena staleness check, then the done event. The only paging cost
        on the decode critical path, so it runs inside the timed region;
        the restore and pool accounting (:meth:`_apply_pending`) is
        bookkeeping the sync path also does untimed."""
        pending, self._pending = self._pending, []
        ready = []
        for rid, handle in pending:
            seq = self._seqs[rid]
            if seq.state != "running":
                continue            # rejected/finished since scheduled
            ready.append((seq, handle,
                          self._codec.prefetcher.consume(handle)))
        return ready

    def _apply_pending(self, ready):
        """Restore consumed blocks and do their deferred pool accounting.
        Restoring one window late is exact: the ``"qlc"`` round trip is
        bit-identical, and the window never touches cache rows behind
        the eviction horizon. Over a mesh the ranks' pending blocks may
        differ (a block whose escape pool overflowed went the sync way on
        its rank; a data replica pages its own slots only), so each
        running sequence's outcome is agreed in slot order."""
        errs: Dict[str, PoolExhausted] = {}
        for seq, handle, arrays in ready:
            if seq.state != "running" or seq.rid in errs:
                continue
            try:
                self._apply_consumed(seq, handle, arrays)
            except PoolExhausted as e:
                errs[seq.rid] = e
                if not self._agreeing:
                    self._reject(seq, e)
        if not self._agreeing:
            return
        for _, rid in self._active():
            err = self._agree(errs.get(rid))
            if err is not None:
                self._reject(self._seqs[rid], err)

    def _apply_consumed(self, seq: _Seq, handle, arrays):
        dev = handle.block
        digest = self._pool_put(seq, dev.host_block())
        if dev.slot is not None and not self.pool.attach_arena_slot(
                digest, dev.slot, dev.gen):
            # dedup hit: the pooled entry already owns an arena copy
            self._codec.arena.free(dev.slot)
        if self._kinds[int(dev.layer[1:])] != "attention":
            # Never restored: the live state has advanced past the
            # snapshot's boundary by a window.
            self._supersede_snapshot(seq, dev.layer, digest)
            return
        k2, v2 = arrays
        t0 = dev.start - self._offset()
        attn.kv_block_restore(_slot_view(self._states,
                                         self._mine(seq.slot))[dev.layer],
                              t0, t0 + dev.tokens, k2, v2)

    def _flush_pending(self, seq: _Seq):
        """Consume (or drop, if no longer running) every pending prefetch
        of ``seq`` now — before finish/reject, so deferred pool
        accounting cannot outlive the request."""
        keep = []
        for rid, handle in self._pending:
            if rid != seq.rid:
                keep.append((rid, handle))
            elif seq.state == "running":
                self._apply_consumed(seq, handle,
                                     self._codec.prefetcher.consume(handle))
        self._pending = keep

    def _pool_put(self, seq: _Seq, block) -> str:
        digest = self.pool.put(block)
        seq.digests.append(digest)
        self._dense_of[digest] = block.dense_bytes
        self._dense_logical += block.dense_bytes
        self.peak_dense_logical_bytes = max(self.peak_dense_logical_bytes,
                                            self._dense_logical)
        return digest

    def _pool_release(self, seq: _Seq, digest: str):
        self.pool.release(digest)
        seq.digests.remove(digest)
        self._dense_logical -= self._dense_of.get(digest, 0)

    def _release_all(self, seq: _Seq):
        for digest in list(seq.digests):
            self._pool_release(seq, digest)
        seq.snap_digests.clear()

    # ---- completion / rejection -----------------------------------------

    def _finish(self, seq: _Seq):
        err = self._agreed(lambda: self._flush_pending(seq))
        if err is not None:
            self._reject(seq, err)
            return
        seq.state = "finished"
        self._vacate(seq)
        self._log("finish", seq.rid)

    def _reject(self, seq: _Seq, err: Exception, event: str = "reject"):
        seq.state = "rejected"
        seq.error = f"{type(err).__name__}: {err}"
        if self._pending:
            self._flush_pending(seq)    # drops (state != running)
        self._vacate(seq)
        self._log(event, seq.rid)

    def _vacate(self, seq: _Seq):
        if seq.slot is not None:
            self._slots[seq.slot] = None
            seq.slot = None
        if self.pool is not None:
            self._release_all(seq)      # zero-ref blocks stay cached
        self._snaps.drop(seq.rid)

    def _log(self, event: str, rid: str):
        self.events.append((self._step_idx, event, rid))

    # ---- accounting ------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Request states, ms/token prefill and decode (host clock around
        work that ends in a device-to-host read), KV codec counters, the
        async window transfers and prefetch/arena counters, and the
        pool's byte-level stats."""
        by_state: Dict[str, int] = {}
        for s in self._seqs.values():
            by_state[s.state] = by_state.get(s.state, 0) + 1
        out: Dict[str, Any] = {
            "steps": self._step_idx,
            "requests": {st: by_state.get(st, 0) for st in
                         ("waiting", "running", "finished", "rejected")},
            "prefill_tokens": self._prefill_tokens,
            "decode_tokens": self._decode_tokens,
            "ms_per_token_prefill": (1e3 * self._prefill_s
                                     / max(1, self._prefill_tokens)),
            "ms_per_token_decode": (1e3 * self._decode_s
                                    / max(1, self._decode_tokens)),
            "dense_logical_bytes": self._dense_logical,
            "peak_dense_logical_bytes": self.peak_dense_logical_bytes,
        }
        if self._codec is not None:
            out["kv"] = {
                "overflow_sections": self._codec.overflow_sections,
                "raw_sections": self._codec.raw_sections,
            }
        if self.kv_paging == "async":
            out["async"] = {
                "windows": self._windows,
                "window_h2d": self._window_h2d,
                "window_d2h": self._window_d2h,
                "h2d_per_window": self._window_h2d / max(1, self._windows),
                "d2h_per_window": self._window_d2h / max(1, self._windows),
            }
            if self._codec is not None:
                out["prefetch"] = self._codec.prefetcher.stats()
                if self._codec.arena is not None:
                    out["arena"] = self._codec.arena.stats()
        if self.pool is not None:
            out["pool"] = self.pool.stats()
        return out
