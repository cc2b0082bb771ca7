"""Fault-tolerant checkpoints, file for file the reference's format.

* One ``.npy`` per tree leaf, named by the md5 of the leaf's path key,
  written to a temp dir, fsync'd, and committed by an atomic rename: a
  crash mid-save never touches the previous checkpoint.
* ``manifest.json`` with each leaf's shape, dtype and the md5 of its
  *original* bytes, checked on restore; a ``latest`` pointer updated by
  atomic rename; ``keep``-based garbage collection.
* Byte-width leaves (u8, i8, ``float8_e4m3fn``: e4m3 weights and symbol
  streams) of at least ``qlc_min_bytes`` are stored losslessly as
  self-describing QLC containers (``comm.container``) when that is
  smaller, each leaf's codec registered in a per-checkpoint
  ``registry.json``. On the card their symbols are counted by K6,
  encoded by K3 (``Channel.compress_codes``) and decoded on restore by
  K4 (``container.decode_codes``).

Path keys follow ``jax.tree_util.tree_flatten_with_path``: dict keys in
sorted order, sequence indices as decimal strings, named-tuple and
dataclass fields by name, joined with ``/``. The raw-or-QLC decision is
the reference's arithmetic, so both packages write the same bytes for
the same leaf and read each other's checkpoints. bf16 and fp8 leaves
are saved as the reference saves its ``ml_dtypes`` arrays: the raw
bytes under the void descr ``<V2`` or ``<V1``, with the dtype's name in
the manifest. The reference's ``shardings`` argument of ``restore`` is
``device`` here.

One checkpoint for any layout. Over the ranks of a ``data x model`` run
(a :class:`Layout`) a save still writes one directory of whole leaves,
the reference's global arrays: every rank writes its own part of a
split leaf (its tensor-parallel block, or its row of a ``[data, model,
*shape]`` leaf such as the compressed step's ZeRO-1 state) into the
leaf's ``.npy`` through a shared memory map, in pieces of at most
``_PIECE`` bytes, and rank 0 writes the leaves every rank holds whole.
The md5 of each split leaf is then streamed from its file, the leaves
dealt out over the ranks, and rank 0 commits the directory once every
rank's part has arrived; a rank that fails makes every rank raise, and
the previous checkpoint stays. A restore first agrees on the step and
the manifest (rank 0's, sent to all), then checks every leaf's md5 (the
leaves dealt out over the ranks) and agrees on the verdict, and only
then cuts each rank's part out of the whole leaves through a memory
map. Beyond its own state, a rank holds on the host one piece of a save
or one leaf's part of a restore at a time, and one whole byte-width
leaf where it frames or decodes a QLC container. The ranks share the
checkpoint directory's file system (one host; more hosts are ROADMAP
queue 1, item 13).
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import math
import os
import shutil
import tempfile
import time
from typing import (Any, Callable, Dict, FrozenSet, List, Mapping, Optional,
                    Tuple)

import numpy as np
import torch
import torch.distributed as dist

SEP = "/"
REGISTRY_FILE = "registry.json"

QLC_CHUNK = 1024                 # symbols per QLC chunk on disk
QLC_MIN_BYTES = 4096             # below this, headers beat the savings

#: torch dtypes numpy has no type for: (name in the manifest, the
#: integer type of the same width, the void type ``np.save`` writes).
_VOID_DTYPES = {
    torch.bfloat16: ("bfloat16", torch.int16, np.dtype("V2")),
    torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.dtype("V1")),
}
_BY_NAME = {name: (dt, as_int) for dt, (name, as_int, _) in
            _VOID_DTYPES.items()}

#: symbols counted by one K6 launch (its limit is 2^31 - 1).
_HIST_PIECE = 1 << 30
#: chunks whose code lengths are summed at once when sizing the slot.
_SIZING_CHUNKS = 1 << 16
#: bytes of a split leaf moved to the host (and written) at once.
_PIECE = 1 << 28


# --------------------------------------------------------------------------
# Trees
# --------------------------------------------------------------------------

def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """``[(path part, child)]`` of an inner node in the reference's
    flattening order, or ``None`` for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def flatten_with_paths(tree) -> Dict[str, Any]:
    """``{path key: leaf}`` in the reference's leaf order (``None`` holds
    no leaf, as in JAX)."""
    flat: Dict[str, Any] = {}
    _flatten_into(flat, tree, [])
    return flat


def _flatten_into(flat: Dict[str, Any], node, parts: List[str]):
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        flat[SEP.join(parts)] = node
        return
    for part, child in kids:
        _flatten_into(flat, child, parts + [part])


def _unflatten(like, flat: Dict[str, Any]):
    """``like``'s structure with its leaves taken from ``flat`` by key."""
    return _build_from(flat, like, [])


def _build_from(flat: Dict[str, Any], node, parts: List[str]):
    if node is None:
        return None
    kids = _children(node)
    if kids is None:
        return flat[SEP.join(parts)]
    built = {part: _build_from(flat, child, parts + [part])
             for part, child in kids}
    if isinstance(node, dict):
        return {k: built[str(k)] for k in node}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(built[f] for f in node._fields))
    if isinstance(node, (tuple, list)):
        return type(node)(built[str(i)] for i in range(len(node)))
    return dataclasses.replace(node, **built)


# --------------------------------------------------------------------------
# Leaves <-> host arrays
# --------------------------------------------------------------------------

def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """A leaf's bytes as the numpy array the reference would save, and its
    dtype's name for the manifest."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        void = _VOID_DTYPES.get(t.dtype)
        if void is not None:
            name, as_int, vdt = void
            return t.view(as_int).cpu().numpy().view(vdt), name
        arr = t.cpu().numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _byte_symbols(leaf, arr: np.ndarray) -> Optional[torch.Tensor]:
    """A byte-width leaf as flat u8 symbols on its device (a tensor leaf
    without a copy, any other from its host array ``arr``), or
    ``None``."""
    if isinstance(leaf, torch.Tensor):
        if leaf.element_size() != 1:
            return None
        return leaf.detach().contiguous().reshape(-1).view(torch.uint8)
    if arr.dtype.hasobject or arr.dtype.itemsize != 1:
        return None
    return torch.from_numpy(np.ascontiguousarray(arr).reshape(-1)
                            .view(np.uint8))


def _torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a manifest's dtype name."""
    return _BY_NAME[name][0] if name in _BY_NAME else getattr(torch, name)


def _host_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """Host bytes with the manifest's dtype name -> a CPU tensor of them
    (a copy)."""
    if dtype_name in _BY_NAME:
        dt, as_int = _BY_NAME[dtype_name]
        raw = np.array(arr, order="C").view(
            np.int16 if as_int == torch.int16 else np.uint8)
        return torch.from_numpy(raw).view(dt)
    return torch.from_numpy(np.array(arr, dtype=np.dtype(dtype_name),
                                     order="C"))


def _checksum(arr: np.ndarray) -> str:
    flat = np.ascontiguousarray(arr).reshape(-1)
    return hashlib.md5(flat.view(np.uint8)).hexdigest()


def _sync(device):
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# --------------------------------------------------------------------------
# Where the ranks hold a tree that a checkpoint stores whole
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Layout:
    """How the ranks of a ``data x model`` run hold the leaves of a tree
    whose checkpoint stores each leaf whole (world rank ``d * model +
    m``, ``rank`` this one's in ``group``, which every rank of the run
    is in and which every save and restore runs over):

    * ``cut``: {path key: dim}: the leaf is split along ``dim`` into
      ``model`` contiguous blocks, model rank ``m`` holding block ``m``
      (``convert.shard_params``; a data column holds the same blocks,
      unless ``data_cut`` cuts them again);
    * ``data_cut``: {path key: dim}: the leaf (or its model block) is
      split along ``dim`` into ``data`` contiguous blocks, data rank
      ``d`` holding block ``d`` (FSDP: rank ``(d, m)`` holds its ``d x
      m`` block; a model row holds the same blocks where ``cut`` does
      not name the leaf);
    * ``rows``: the path keys of leaves each rank holds one row of: the
      stored leaf is ``[data, model, *shape]``, row ``[d, m]`` world rank
      ``d * model + m``'s (the compressed step's ``m`` and ``v``);
    * any other leaf is whole and the same on every rank.

    The default is one rank holding every leaf as it is."""
    data: int = 1
    model: int = 1
    rank: int = 0
    group: Any = None
    cut: Mapping[str, int] = dataclasses.field(default_factory=dict)
    rows: FrozenSet[str] = frozenset()
    data_cut: Mapping[str, int] = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    def _dim(self, key: str) -> Optional[int]:
        return self.cut.get(key) if self.model > 1 else None

    def _ddim(self, key: str) -> Optional[int]:
        return self.data_cut.get(key) if self.data > 1 else None

    def whole_shape(self, key: str, shape) -> List[int]:
        """The stored shape of leaf ``key``, which this rank holds at
        ``shape``."""
        if key in self.rows:
            return [self.data, self.model, *shape]
        whole = list(shape)
        for dim, n in ((self._dim(key), self.model),
                       (self._ddim(key), self.data)):
            if dim is not None:
                whole[dim] *= n
        return whole

    def part(self, key: str, whole) -> tuple:
        """This rank's part of the stored leaf ``key`` of shape ``whole``,
        as an index into it (``()``: all of it)."""
        d, m = divmod(self.rank, self.model)
        if key in self.rows:
            return (d, m)
        idx = [slice(None)] * len(whole)
        cut = False
        for dim, i, n in ((self._dim(key), m, self.model),
                          (self._ddim(key), d, self.data)):
            if dim is not None:
                size = whole[dim] // n
                idx[dim] = slice(i * size, (i + 1) * size)
                cut = True
        return tuple(idx) if cut else ()

    def split(self, key: str) -> bool:
        """Whether several ranks write parts of leaf ``key``."""
        return self.size > 1 and (key in self.rows
                                  or self._dim(key) is not None
                                  or self._ddim(key) is not None)

    def writes(self, key: str) -> bool:
        """Whether this rank writes (a part of) leaf ``key`` on a save: its
        row, its block (from the first model row where the data column
        holds it whole, from the first data rank's row where the model
        row does), or rank 0 a whole leaf."""
        if key in self.rows:
            return True
        if self.split(key):
            d, m = divmod(self.rank, self.model)
            return ((d == 0 or self._ddim(key) is not None)
                    and (m == 0 or self._dim(key) is not None))
        return self.rank == 0


def _agreed(layout: Layout, fn: Callable[[], Any]) -> List[Any]:
    """``fn()`` on every rank of ``layout`` -> every rank's result, rank
    by rank. If it raised on any rank, every rank raises: its own
    exception where it raised, else the first failing rank's, rebuilt (a
    rank that raised alone would leave the others waiting in their next
    collective)."""
    if layout.size == 1:
        return [fn()]
    try:
        mine = (fn(), None)
    except Exception as e:          # re-raised below, on every rank
        err = e
        mine = (None, (type(e), str(e)))
    else:
        err = None
    every = [None] * layout.size
    dist.all_gather_object(every, mine, group=layout.group)
    if err is not None:
        raise err
    for r, (_, failed) in enumerate(every):
        if failed is not None:
            kind, msg = failed
            try:
                exc = kind(f"rank {r}: {msg}")
            except Exception:       # a type that takes other arguments
                exc = RuntimeError(f"rank {r}: {kind.__name__}: {msg}")
            raise exc
    return [res for res, _ in every]


# --------------------------------------------------------------------------
# Manager
# --------------------------------------------------------------------------

class CheckpointManager:
    """Saves and restores trees of tensors under ``directory``; over the
    ranks of a :class:`Layout`, one checkpoint of whole leaves that every
    rank writes its part of and cuts its part from.

    ``timings`` holds the seconds the last ``save`` or ``restore`` spent
    in each stage, each stage's device work synchronized at its end. A
    save: ``d2h``, ``md5``, ``write`` (the leaves rank 0 writes whole,
    and this rank's parts of the split leaves), ``fsync`` (the parts),
    ``counts``, ``encode`` (QLC), ``gather`` (the wait until every
    rank's parts have arrived), ``commit`` (rank 0: the manifest, the
    rename, ``latest``; the others wait). A restore:
    ``agree`` (the step and manifest from rank 0, and the wait for the
    md5 verdict), ``read``, ``decode`` (QLC), ``md5``, ``cut`` (this
    rank's part copied out of the file), ``h2d``."""

    def __init__(self, directory: str, keep: int = 3,
                 qlc_codes: bool = True, qlc_min_bytes: int = QLC_MIN_BYTES):
        self.dir = directory
        self.keep = keep
        self.qlc_codes = qlc_codes
        self.qlc_min_bytes = qlc_min_bytes
        self.timings: Dict[str, float] = {}
        os.makedirs(directory, exist_ok=True)

    @contextlib.contextmanager
    def _stage(self, name: str, device=None):
        t0 = time.perf_counter()
        yield
        _sync(device)
        self.timings[name] = self.timings.get(name, 0.0) \
            + time.perf_counter() - t0

    @contextlib.contextmanager
    def _waiting(self, name: str):
        """Adds to stage ``name`` the block's seconds that no stage inside
        it counted (the wait for the other ranks)."""
        t0, inner = time.perf_counter(), sum(self.timings.values())
        try:
            yield
        finally:
            rest = time.perf_counter() - t0 - (sum(self.timings.values())
                                               - inner)
            self.timings[name] = self.timings.get(name, 0.0) + rest

    # ---- save -----------------------------------------------------------

    def save(self, step: int, state: Any, extra: Optional[Dict] = None,
             layout: Optional[Layout] = None):
        """Atomically save the tree ``state`` as checkpoint ``step``. Over
        a ``layout`` of several ranks every rank calls this with its own
        tree, and the checkpoint holds the whole leaves; it is committed
        only once every rank's part is written, and if any rank fails
        every rank raises and the previous checkpoint stays."""
        from repro_torch.core.registry import CodecRegistry
        layout = layout or Layout()
        self.timings = {}
        flat = flatten_with_paths(state)
        tmp = _agreed(layout, lambda: tempfile.mkdtemp(
            dir=self.dir, prefix=f".tmp_{step}_")
            if layout.rank == 0 else None)[0]
        registry = CodecRegistry()
        metas: Dict[str, Dict] = {}
        try:
            with self._waiting("gather"):
                _agreed(layout, lambda: self._write_own(tmp, flat, layout,
                                                        registry, metas))
            split = {k: math.prod(layout.whole_shape(k, leaf.shape))
                     * leaf.element_size()
                     for k, leaf in flat.items() if layout.split(k)}
            sums: Dict[str, str] = {}
            if split:
                with self._waiting("md5"):
                    for part in _agreed(layout, lambda: {
                            k: _checksum(_mapped(tmp, _leaf_file(k)))
                            for k in _dealt(split, layout)}):
                        sums.update(part)
            with self._waiting("commit"):
                _agreed(layout, lambda: self._commit(
                    step, tmp, flat, metas, sums, registry, extra)
                    if layout.rank == 0 else None)
        except Exception:
            if layout.rank == 0:
                shutil.rmtree(tmp, ignore_errors=True)
            raise

    def _write_own(self, tmp: str, flat: Dict[str, Any], layout: Layout,
                   registry, metas: Dict[str, Dict]):
        """Write this rank's leaves and parts of ``flat`` into ``tmp``, each
        leaf's manifest entry into ``metas`` (a split leaf's without its
        md5)."""
        for key, leaf in flat.items():
            if not layout.writes(key):
                continue
            fname = _leaf_file(key)
            if layout.split(key):
                metas[key] = _write_part(tmp, fname, leaf, layout, key,
                                         self._stage)
                continue
            dev = leaf.device if isinstance(leaf, torch.Tensor) else None
            with self._stage("d2h"):
                arr, dtype_name = _host_array(leaf)
                arr = arr.reshape(layout.whole_shape(key, arr.shape))
            with self._stage("md5"):
                meta = {"file": fname, "shape": list(arr.shape),
                        "dtype": dtype_name, "sum": _checksum(arr)}
            blob, qlc_meta = self._maybe_qlc(_byte_symbols(leaf, arr),
                                             arr.nbytes, key, registry, dev)
            if qlc_meta is not None:
                meta["qlc"] = qlc_meta
                arr = blob
            with self._stage("write"):
                _write(os.path.join(tmp, fname),
                       lambda f, a=arr: _save_npy(f, a))
            metas[key] = meta

    def _commit(self, step: int, tmp: str, flat: Dict[str, Any],
                metas: Dict[str, Dict], sums: Dict[str, str], registry,
                extra: Optional[Dict]):
        """Rank 0: the split leaves' md5s into their entries (a byte-width
        one QLC'd from its whole file, on the device of this rank's part),
        the registry and manifest written, the directory renamed into
        place, ``latest`` and garbage collection."""
        manifest = {"step": int(step), "leaves": {}, "extra": extra or {}}
        for key, leaf in flat.items():
            meta = metas[key]
            if key in sums:
                meta["sum"] = sums[key]
                arr = _mapped(tmp, meta["file"])
                if arr.dtype.itemsize == 1 and self.qlc_codes \
                        and arr.nbytes >= self.qlc_min_bytes:
                    arr = np.array(arr)
                    blob, qlc_meta = self._maybe_qlc(
                        _byte_symbols(arr, arr).to(leaf.device), arr.nbytes,
                        key, registry, leaf.device)
                    if qlc_meta is not None:
                        meta["qlc"] = qlc_meta
                        _write(os.path.join(tmp, meta["file"]),
                               lambda f, a=blob: _save_npy(f, a))
                del arr
            manifest["leaves"][key] = meta
        if len(registry):
            _write(os.path.join(tmp, REGISTRY_FILE), lambda f: f.write(
                json.dumps(registry.to_json_dict()).encode()))
        _write(os.path.join(tmp, "manifest.json"),
               lambda f: f.write(json.dumps(manifest).encode()))
        final = os.path.join(self.dir, f"step_{step:010d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                       # atomic commit
        self._update_latest(step)
        self._gc()

    def _maybe_qlc(self, syms: Optional[torch.Tensor], nbytes: int, key: str,
                   registry, device):
        """A byte-width leaf's symbols -> ``(container words, meta)``, its
        codec registered in ``registry`` under ``key``; ``(None, None)``
        when the leaf is ineligible or would not shrink (kept raw).

        The decision is the reference's: calibrated tables from the
        counts, the slot sized to the longest chunk (so nothing
        escapes), a one-slot pool, and the container's word count
        against the raw bytes."""
        if not self.qlc_codes or syms is None or nbytes < self.qlc_min_bytes:
            return None, None
        from repro_torch.comm import container as qc
        from repro_torch.comm.channel import Channel, ChannelSpec
        from repro_torch.comm.compressed import CommConfig
        from repro_torch.core import adapt
        from repro_torch.kernels import ops

        with self._stage("counts", device):
            counts = sum(ops.histogram(syms[i:i + _HIST_PIECE]).long()
                         for i in range(0, syms.numel(), _HIST_PIECE))
            counts = counts.cpu().numpy()
            tables = adapt.calibrate_tables(
                np.maximum(counts.astype(np.float64), 1e-6))
            n = syms.numel()
            n_chunks = -(-n // QLC_CHUNK)
            if n_chunks * QLC_CHUNK != n:
                padded = torch.zeros(n_chunks * QLC_CHUNK, dtype=torch.uint8,
                                     device=syms.device)
                padded[:n] = syms
            else:
                padded = syms
            cap = max(1, math.ceil(_longest_chunk_bits(
                padded.view(n_chunks, QLC_CHUNK), tables.enc_len) / 32))
        cfg = CommConfig(chunk_symbols=QLC_CHUNK, capacity_words=cap,
                         pool_slots_per_1k=1)
        container_words = (qc.HEADER_WORDS + n_chunks * cap
                           + -(-n_chunks // 4)
                           + cfg.pool_slots(n_chunks) * (QLC_CHUNK // 4) + 1)
        if container_words * 4 >= n:                # incompressible leaf
            return None, None
        entry = registry.register(key, counts.astype(np.float64),
                                  chunk_symbols=QLC_CHUNK)
        ch = Channel(ChannelSpec(codec=entry, cfg=cfg, use_kernels=True))
        with self._stage("encode", device):
            words = qc.frame_block_device(
                ch.compress_codes(padded), None, scheme_id=entry.scheme_id,
                cfg=ch.cfg, n_valid=n, prefix_bits=entry.tables.prefix_bits)
        with self._stage("d2h"):
            blob = words.cpu().numpy().view(np.uint32)
        return blob, {"scheme_id": int(entry.scheme_id), "n": int(n)}

    def _decode_qlc(self, words: np.ndarray, qlc_meta: Dict, registry,
                    device) -> torch.Tensor:
        """Inverse of ``_maybe_qlc``: container words -> u8 symbols
        ``[n]`` on ``device`` (K4 on the card). A checkpoint written
        before the container format (the histogram in the leaf's meta)
        decodes through TABLE1 tables. Any parse or decode failure of a
        container, a pool overflow included, raises ``IOError``."""
        from repro_torch.comm import container as qc
        from repro_torch.kernels import ops
        if "counts" in qlc_meta:          # pre-container checkpoint
            from repro_torch.core import TABLE1, build_tables
            tables = build_tables(
                np.asarray(qlc_meta["counts"], dtype=np.float64), TABLE1)
            w = torch.from_numpy(np.ascontiguousarray(words).view(np.int32)
                                 .copy()).to(device)
            syms = ops.decode(w, tables, qlc_meta["chunk"])
            return syms.reshape(-1)[:qlc_meta["n"]]
        try:
            syms, ok, _ = qc.decode_codes(words, registry, device=device)
            if not ok:
                raise ValueError("escape pool overflow on restore")
        except Exception as e:
            raise IOError(f"corrupt QLC container: {e}") from e
        return syms.reshape(-1)[:qlc_meta["n"]]

    def _update_latest(self, step: int):
        tmp = os.path.join(self.dir, ".latest_tmp")
        _write(tmp, lambda f: f.write(str(step).encode()))
        os.rename(tmp, os.path.join(self.dir, "latest"))

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ---- restore ----------------------------------------------------------

    def all_steps(self) -> List[int]:
        return sorted(int(name[5:]) for name in os.listdir(self.dir)
                      if name.startswith("step_"))

    def latest_step(self, layout: Optional[Layout] = None) -> Optional[int]:
        """The newest checkpoint's step (the ``latest`` pointer where its
        directory is there, else the largest step directory), or None;
        over a ``layout`` of several ranks, rank 0's, the same on every
        rank. A directory of the per-rank layout that earlier versions of
        the port wrote (``rank_<r>`` subdirectories) raises
        ``ValueError``."""
        layout = layout or Layout()
        return _agreed(layout, lambda: self._latest()
                       if layout.rank == 0 else None)[0]

    def _latest(self) -> Optional[int]:
        old = sorted(n for n in os.listdir(self.dir)
                     if n.startswith("rank_"))
        if old:
            raise ValueError(
                f"{self.dir} holds checkpoints in the per-rank layout of "
                f"earlier versions ({', '.join(old[:4])}"
                f"{', ...' if len(old) > 4 else ''}), which is not read: a "
                "checkpoint is now one directory of whole leaves for any "
                "layout; start from a new directory")
        path = os.path.join(self.dir, "latest")
        if os.path.exists(path):
            with open(path) as f:
                step = int(f.read().strip())
            if os.path.isdir(os.path.join(self.dir, f"step_{step:010d}")):
                return step
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _manifest(self, step: Optional[int]) -> Tuple[int, Dict, Any]:
        """Rank 0: ``(step, manifest, registry JSON or None)`` of checkpoint
        ``step`` (default: the latest)."""
        latest = self._latest()
        if step is None:
            step = latest
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        cdir = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(cdir, "manifest.json")) as f:
            manifest = json.load(f)
        registry = None
        rpath = os.path.join(cdir, REGISTRY_FILE)
        if os.path.exists(rpath):
            with open(rpath) as f:
                registry = json.load(f)
        return step, manifest, registry

    def restore(self, like: Any, step: Optional[int] = None,
                device="cuda", layout: Optional[Layout] = None,
                in_place: bool = False) -> Tuple[Any, Dict]:
        """Restore checkpoint ``step`` (default: the latest) into the
        structure of ``like``, every leaf a tensor on ``device`` ->
        ``(tree, extra)``. A missing leaf raises ``KeyError``, a checksum
        mismatch or a corrupt container ``IOError``, a shape mismatch
        ``ValueError``.

        Over a ``layout`` of several ranks every rank calls this with its
        own ``like`` (its parts' shapes) and gets its parts of the whole
        leaves. The ranks first take rank 0's step and manifest, so every
        check above that reads them raises alike on every rank; then each
        leaf's md5 is checked by one rank, and every rank raises if any
        failed, before any rank cuts its parts. A leaf held whole or split
        by the model axis restores on any layout; a ``rows`` leaf only on
        the ``data x model`` it was saved on (the reference's shape
        check, which does not re-cut a flat state), else ``ValueError``
        naming both layouts.

        ``in_place``: each leaf is copied into ``like``'s tensor where
        that is on ``device`` with the saved dtype (the state that the
        checkpoint replaces), so the device holds no second copy of the
        state; ``like``'s tensors are then overwritten."""
        from repro_torch.core.registry import CodecRegistry
        from repro_torch.models.transformer import resolve_device
        device = resolve_device(device)
        layout = layout or Layout()
        self.timings = {}
        with self._waiting("agree"):
            step, manifest, reg = _agreed(layout, lambda: self._manifest(
                step) if layout.rank == 0 else None)[0]
        cdir = os.path.join(self.dir, f"step_{step:010d}")
        registry = (CodecRegistry.from_json_dict(reg) if reg is not None
                    else None)
        plan = {}
        for key, leaf in flatten_with_paths(like).items():
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {key}")
            local = list(leaf.shape) if isinstance(leaf, torch.Tensor) \
                else list(np.shape(leaf))
            want = layout.whole_shape(key, local)
            if list(meta["shape"]) != want:
                raise ValueError(_mismatch(key, meta["shape"], want, layout,
                                           manifest))
            if "qlc" in meta and registry is None \
                    and "counts" not in meta["qlc"]:
                raise IOError(
                    f"checkpoint has QLC leaves but no {REGISTRY_FILE}")
            plan[key] = (meta, local)
        if layout.size > 1:
            sizes = {key: math.prod(meta["shape"])
                     * np.dtype(_np_name(meta["dtype"])).itemsize
                     for key, (meta, _) in plan.items()}
            with self._waiting("agree"):
                _agreed(layout, lambda: self._verify(
                    cdir, _dealt(sizes, layout), plan, registry, device))
        flat_like = flatten_with_paths(like)
        out = {key: self._load(cdir, key, meta, local, registry, device,
                               layout, verify=layout.size == 1,
                               into=flat_like[key] if in_place else None)
               for key, (meta, local) in plan.items()}
        return _unflatten(like, out), manifest.get("extra", {})

    def _whole(self, cdir: str, key: str, meta: Dict, registry, device,
               verify: bool):
        """Leaf ``key``: its QLC symbols decoded on ``device``, else its
        file mapped into memory; its md5 checked when ``verify``."""
        if "qlc" in meta:
            with self._stage("read"):
                words = np.load(os.path.join(cdir, meta["file"]))
            with self._stage("decode", device):
                whole = self._decode_qlc(words, meta["qlc"], registry,
                                         device)
            if verify:
                with self._stage("d2h"):
                    arr = whole.cpu().numpy()
        else:
            with self._stage("read"):
                whole = arr = _mapped(cdir, meta["file"])
        if verify:
            with self._stage("md5"):
                if _checksum(arr) != meta["sum"]:
                    raise IOError(f"checksum mismatch for {key}")
        return whole

    def _verify(self, cdir: str, keys: List[str], plan: Dict, registry,
                device):
        """Check the md5 of each of ``keys``; ``IOError`` naming those that
        fail."""
        bad = []
        for key in keys:
            try:
                self._whole(cdir, key, plan[key][0], registry, device, True)
            except IOError:
                bad.append(key)
        if bad:
            raise IOError(f"checksum mismatch for {', '.join(bad)}")

    def _load(self, cdir: str, key: str, meta: Dict, local: List[int],
              registry, device, layout: Layout, verify: bool, into=None
              ) -> torch.Tensor:
        """This rank's part of leaf ``key``, shaped ``local``, on
        ``device``: copied into ``into`` where that is a tensor on
        ``device`` of the saved dtype, else a new tensor."""
        dtype = _torch_dtype(meta["dtype"])
        if not (isinstance(into, torch.Tensor) and into.dtype == dtype
                and into.device == device):
            into = None
        whole = self._whole(cdir, key, meta, registry, device, verify)
        idx = layout.part(key, meta["shape"])
        if isinstance(whole, torch.Tensor):         # decoded on the device
            with self._stage("cut", device):
                t = whole.view(dtype).reshape(meta["shape"])
                if idx:
                    t = t[idx].clone()
                t = t.reshape(local)
                if into is not None:
                    with torch.no_grad():
                        into.copy_(t)
            return t if into is None else into
        with self._stage("cut"):
            host = _host_tensor(whole[idx], meta["dtype"]).reshape(local)
        with self._stage("h2d", device):
            if into is None:
                return host.to(device)
            with torch.no_grad():
                into.copy_(host)
            return into


def _np_name(dtype_name: str) -> str:
    """The numpy dtype of a manifest's dtype name (a void type for the
    ``ml_dtypes`` ones)."""
    if dtype_name in _BY_NAME:
        return f"V{_BY_NAME[dtype_name][0].itemsize}"
    return dtype_name


def _dealt(nbytes: Dict[str, int], layout: Layout) -> List[str]:
    """This rank's share of the leaves ``nbytes`` ({key: bytes}): the
    largest first, each to the rank with the fewest bytes so far (the
    lowest on a tie), the same deal on every rank."""
    load = [0] * layout.size
    mine = []
    for key in sorted(nbytes, key=lambda k: (-nbytes[k], k)):
        r = load.index(min(load))
        load[r] += nbytes[key]
        if r == layout.rank:
            mine.append(key)
    return mine


def _mismatch(key: str, saved, want, layout: Layout, manifest: Dict) -> str:
    msg = f"shape mismatch for {key}: {tuple(saved)} vs {tuple(want)}"
    if key not in layout.rows:
        return msg
    held = manifest.get("extra", {}).get("layout")
    if held is not None:
        held = f"{held['data']} x {held['model']}"
    elif len(saved) == len(want):
        held = f"{saved[0]} x {saved[1]}"
    else:
        held = "one rank, unstacked"
    return (f"{msg}: this flat state was saved on a {held} layout and this "
            f"run is {layout.data} x {layout.model}; it restores only on "
            "its own layout (the reference's shape check: a flat ZeRO-1 "
            "state is not cut again for another layout)")


def _leaf_file(key: str) -> str:
    """The file name of leaf ``key``: the md5 of the key."""
    return hashlib.md5(key.encode()).hexdigest() + ".npy"


def _mapped(cdir: str, fname: str) -> np.ndarray:
    """Leaf file ``fname`` of ``cdir`` mapped read-only."""
    return np.load(os.path.join(cdir, fname), mmap_mode="r")


def _npy_header(dtype: np.dtype, shape) -> bytes:
    """The ``.npy`` header ``np.save`` writes for an array of ``dtype`` and
    ``shape`` (a void dtype as ``<V{n}``, as for an ``ml_dtypes``
    array)."""
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, {
        "descr": (f"<V{dtype.itemsize}" if dtype.kind == "V"
                  else np.lib.format.dtype_to_descr(dtype)),
        "fortran_order": False, "shape": tuple(shape)})
    return buf.getvalue()


def _write_part(tmp: str, fname: str, leaf: torch.Tensor, layout: Layout,
                key: str, stage=contextlib.nullcontext) -> Dict:
    """Write this rank's part ``leaf`` of a split leaf into its file in
    ``tmp`` (created at the whole leaf's size by whichever rank comes
    first; rank 0 writes the header) through a shared memory map, at most
    ``_PIECE`` bytes moved to the host at once -> the leaf's manifest
    entry without its md5. ``stage(name)`` times the ``d2h``, ``write``
    and ``fsync`` stages."""
    t = leaf.detach()
    probe, dtype_name = _host_array(t.reshape(-1)[:0])
    whole = layout.whole_shape(key, t.shape)
    header = _npy_header(probe.dtype, whole)
    path = os.path.join(tmp, fname)
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        size = len(header) + math.prod(whole) * probe.dtype.itemsize
        if os.fstat(fd).st_size < size:
            os.ftruncate(fd, size)
        if layout.rank == 0:
            os.pwrite(fd, header, 0)
        if t.numel():
            mm = np.memmap(path, dtype=probe.dtype, mode="r+",
                           offset=len(header), shape=tuple(whole))
            dst = mm[layout.part(key, whole)]
            if dst.ndim == 1:       # a row: pieces of the flat part
                t, rows = t.reshape(-1), max(1, _PIECE // t.element_size())
            else:
                rows = max(1, _PIECE // max(1, t[0].numel()
                                             * t.element_size()))
            for i in range(0, t.shape[0], rows):
                with stage("d2h"):
                    host = _host_array(t[i:i + rows])[0]
                with stage("write"):
                    dst[i:i + rows] = host
                del host
            with stage("fsync"):
                mm.flush()
                del dst, mm
        with stage("fsync"):
            os.fsync(fd)
    finally:
        os.close(fd)
    return {"file": fname, "shape": whole, "dtype": dtype_name}


def _longest_chunk_bits(chunks: torch.Tensor, enc_len: np.ndarray) -> int:
    """The largest encoded bit count of any row of u8 ``chunks``."""
    lens = torch.as_tensor(np.asarray(enc_len, np.int32),
                           device=chunks.device)
    best = 0
    for i in range(0, chunks.shape[0], _SIZING_CHUNKS):
        block = chunks[i:i + _SIZING_CHUNKS]
        bits = lens[block.long()].sum(dim=1)
        best = max(best, int(bits.max()))
    return best


def _save_npy(f, arr: np.ndarray):
    """``np.save``, except that a void dtype is written as ``<V{n}``, the
    descr numpy writes for an ``ml_dtypes`` array (bf16, fp8), so the
    file is the reference's byte for byte."""
    if arr.dtype.kind != "V":
        np.save(f, arr)
        return
    f.write(_npy_header(arr.dtype, arr.shape))
    f.write(np.ascontiguousarray(arr).reshape(-1).view(np.uint8).data)


def _write(path: str, fill):
    """Write a file through ``fill(f)``, flush and fsync it."""
    with open(path, "wb") as f:
        fill(f)
        f.flush()
        os.fsync(f.fileno())
