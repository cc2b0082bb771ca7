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
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

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


def _to_tensor(arr: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    """Host bytes with the manifest's dtype name -> a tensor on
    ``device``."""
    if dtype_name in _BY_NAME:
        dt, as_int = _BY_NAME[dtype_name]
        raw = np.array(arr, order="C").view(
            np.int16 if as_int == torch.int16 else np.uint8)
        return torch.from_numpy(raw).to(device).view(dt)
    return torch.from_numpy(np.array(arr, dtype=np.dtype(dtype_name),
                                     order="C")).to(device)


def _checksum(arr: np.ndarray) -> str:
    flat = np.ascontiguousarray(arr).reshape(-1)
    return hashlib.md5(flat.view(np.uint8)).hexdigest()


def _sync(device):
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# --------------------------------------------------------------------------
# Manager
# --------------------------------------------------------------------------

class CheckpointManager:
    """Saves and restores trees of tensors under ``directory``.

    ``timings`` holds the seconds the last ``save`` or ``restore`` spent
    in each stage (``counts``, ``encode``, ``d2h``, ``md5``, ``write``;
    ``read``, ``decode``, ``h2d``), each stage's device work
    synchronized at its end."""

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

    # ---- save -----------------------------------------------------------

    def save(self, step: int, state: Any, extra: Optional[Dict] = None):
        """Atomically save the tree ``state`` as checkpoint ``step``."""
        from repro_torch.core.registry import CodecRegistry
        self.timings = {}
        flat = flatten_with_paths(state)
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=f".tmp_{step}_")
        manifest = {"step": int(step), "leaves": {}, "extra": extra or {}}
        registry = CodecRegistry()
        try:
            for key, leaf in flat.items():
                dev = leaf.device if isinstance(leaf, torch.Tensor) else None
                with self._stage("d2h"):
                    arr, dtype_name = _host_array(leaf)
                fname = hashlib.md5(key.encode()).hexdigest() + ".npy"
                with self._stage("md5"):
                    meta = {"file": fname, "shape": list(arr.shape),
                            "dtype": dtype_name, "sum": _checksum(arr)}
                blob, qlc_meta = self._maybe_qlc(_byte_symbols(leaf, arr),
                                                 arr.nbytes, key, registry,
                                                 dev)
                if qlc_meta is not None:
                    meta["qlc"] = qlc_meta
                    arr = blob
                with self._stage("write"):
                    _write(os.path.join(tmp, fname),
                           lambda f, a=arr: _save_npy(f, a))
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
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

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

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.dir, "latest")
        if not os.path.exists(path):
            steps = self.all_steps()
            return steps[-1] if steps else None
        with open(path) as f:
            return int(f.read().strip())

    def restore(self, like: Any, step: Optional[int] = None,
                device="cuda") -> Tuple[Any, Dict]:
        """Restore checkpoint ``step`` (default: the latest) into the
        structure of ``like``, every leaf a tensor on ``device`` ->
        ``(tree, extra)``. A missing leaf raises ``KeyError``, a checksum
        mismatch or a corrupt container ``IOError``, a shape mismatch
        ``ValueError``."""
        from repro_torch.models.transformer import resolve_device
        device = resolve_device(device)
        self.timings = {}
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        cdir = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(cdir, "manifest.json")) as f:
            manifest = json.load(f)
        registry = None
        rpath = os.path.join(cdir, REGISTRY_FILE)
        if os.path.exists(rpath):
            from repro_torch.core.registry import CodecRegistry
            registry = CodecRegistry.load(rpath)

        out = {}
        for key, leaf in flatten_with_paths(like).items():
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {key}")
            with self._stage("read"):
                arr = np.load(os.path.join(cdir, meta["file"]))
            syms = None
            if "qlc" in meta:
                if registry is None and "counts" not in meta["qlc"]:
                    raise IOError(
                        f"checkpoint has QLC leaves but no {REGISTRY_FILE}")
                with self._stage("decode", device):
                    syms = self._decode_qlc(arr, meta["qlc"], registry,
                                            device)
                with self._stage("d2h"):
                    arr = syms.cpu().numpy().reshape(meta["shape"])
            with self._stage("md5"):
                if _checksum(arr) != meta["sum"]:
                    raise IOError(f"checksum mismatch for {key}")
            want = list(np.shape(leaf)) if not isinstance(
                leaf, torch.Tensor) else list(leaf.shape)
            if list(arr.shape) != want:
                raise ValueError(f"shape mismatch for {key}: {arr.shape} "
                                 f"vs {tuple(want)}")
            with self._stage("h2d", device):
                if syms is not None:         # already on the device
                    out[key] = syms.view(_torch_dtype(meta["dtype"])
                                         ).reshape(want)
                else:
                    out[key] = _to_tensor(arr, meta["dtype"], device)
        return _unflatten(like, out), manifest.get("extra", {})


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
    np.lib.format.write_array_header_1_0(f, {
        "descr": f"<V{arr.dtype.itemsize}", "fortran_order": False,
        "shape": arr.shape})
    f.write(np.ascontiguousarray(arr).reshape(-1).view(np.uint8).data)


def _write(path: str, fill):
    """Write a file through ``fill(f)``, flush and fsync it."""
    with open(path, "wb") as f:
        fill(f)
        f.flush()
        os.fsync(f.fileno())
