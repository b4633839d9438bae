"""Ingest: the bin-id dtype, the payload verification policy, and the
spill plane of out-of-core training — the port's copies of the JAX
package's ``binned_ingest_dtype``, ``resolve_spill_verify`` and spill
directory (``SpillWriter`` / ``SpillReader`` / ``ChunkStore``).

Out-of-core GBDT training (``models/gbdt/ooc.py``) streams pre-binned
row chunks from disk instead of holding the (N, F) binned matrix. The
format is deliberately plain: one framed file per chunk plus a JSON
manifest, written append-only and sealed by an atomic manifest rename,
so a partly written spill is never taken for a complete one.

Chunk frame: MAGIC ``MMSC`` | header length (uint32 little-endian) |
JSON header ``{version, dtype, shape, nbytes, crc32}`` (compact
separators) | the raw C-order payload bytes. The frames are byte for
byte the JAX package's, so either package reads a spill the other
wrote. The crc32 (zlib) turns silent disk bit rot into an attributed
``SpillCorrupt`` instead of wrong trees. Verification follows
``MMLSPARK_TORCH_SPILL_VERIFY`` (``resolve_spill_verify``); its cost is
counted per reader and store (``verify_s``, ``verify_chunks``) so the
fit's ``hist_stats`` can record it.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Any, Iterator, List, Optional, Set

import numpy as np

from mmlspark_tpu_torch.core.env import SPILL_VERIFY, env_str
from mmlspark_tpu_torch.core.faults import FaultInjected, fault_point
from mmlspark_tpu_torch.core.logging_utils import warn_once
from mmlspark_tpu_torch.core.serialize import DiskFull, atomic_write

_VERIFY_MODES = ("auto", "off", "on")
_SPILL_MANIFEST = "spill_meta.json"
_FRAME_MAGIC = b"MMSC"        # "mmlspark spill chunk"
_FRAME_VERSION = 1


def binned_ingest_dtype(total_bins: int):
    """Narrowest integer dtype holding bin ids in [0, total_bins):
    uint8 for <= 256 bins, uint16 up to 65536, int32 beyond."""
    if total_bins <= 256:
        return np.uint8
    if total_bins <= 65536:
        return np.uint16
    return np.int32


def resolve_spill_verify() -> str:
    """``MMLSPARK_TORCH_SPILL_VERIFY`` policy: ``auto`` (the default)
    verifies every checkpoint payload's crc32 at resume and each spill
    chunk's crc32 on its first read (a chunk store's entry on its first
    read after each ``put``), ``on`` verifies every read, ``off`` trusts
    the disk. A bad value warns once and falls back to auto."""
    v = (env_str(SPILL_VERIFY, "auto") or "auto").strip().lower() or "auto"
    if v not in _VERIFY_MODES:
        warn_once("spill.verify.mode",
                  "%s=%r is not one of %s; using 'auto'", SPILL_VERIFY, v,
                  "|".join(_VERIFY_MODES))
        v = "auto"
    return v


class SpillCorrupt(RuntimeError):
    """An on-disk chunk failed structural or checksum validation
    (truncation, bad magic, torn header, crc32 mismatch, missing file).
    Carries ``chunk`` (its index, where known) and ``path``, so an
    out-of-core failure names one artifact."""

    def __init__(self, message: str, *, chunk: Optional[int] = None,
                 path: Optional[str] = None) -> None:
        super().__init__(message)
        self.chunk = chunk
        self.path = path


def pack_frame(arr: np.ndarray) -> bytes:
    """One array in the framed chunk format (header + crc32 over the
    payload bytes)."""
    c = np.ascontiguousarray(arr)
    payload = c.tobytes()
    header = json.dumps({
        "version": _FRAME_VERSION, "dtype": c.dtype.name,
        "shape": list(c.shape), "nbytes": len(payload),
        "crc32": zlib.crc32(payload) & 0xFFFFFFFF,
    }, separators=(",", ":")).encode()
    return (_FRAME_MAGIC + struct.pack("<I", len(header))
            + header + payload)


def write_chunk(path: str, arr: np.ndarray) -> None:
    """Persist one framed chunk atomically (a temporary file, then
    ``os.replace``). Every spill-plane write passes the ``io.disk_full``
    fault point: an OSError (ENOSPC, quota) or an armed fault comes back
    as the attributed ``DiskFull``, so a caller can degrade (``train``
    falls back in-core) instead of failing on a bare write error."""
    frame = pack_frame(arr)
    tmp = path + ".tmp"
    try:
        fault_point("io.disk_full")
        with open(tmp, "wb") as fh:
            fh.write(frame)
        os.replace(tmp, path)
    except (OSError, FaultInjected) as e:
        raise DiskFull(
            f"[io.disk_full] spill chunk write failed for {path} "
            f"({type(e).__name__}: {e})") from e


def read_chunk(path: str, *, verify: bool = True,
               chunk: Optional[int] = None,
               label: str = "spill") -> tuple:
    """Load one framed chunk: ``(array, verify_seconds)``.

    Structural damage (missing file, truncation, bad magic or header)
    and, with ``verify``, a crc32 mismatch raise ``SpillCorrupt``. The
    payload passes the ``spill.read`` fault point before the checksum,
    so an armed ``corrupt`` action is caught exactly like real bit rot.
    The array is a read-only view of the payload."""
    where = f"{label} chunk {chunk}" if chunk is not None else label
    try:
        with open(path, "rb") as fh:
            blob = fh.read()
    except OSError as e:
        raise SpillCorrupt(
            f"{where}: chunk file missing or unreadable at {path} "
            f"({type(e).__name__}: {e})", chunk=chunk, path=path) from e
    if len(blob) < 8 or blob[:4] != _FRAME_MAGIC:
        raise SpillCorrupt(
            f"{where}: {path} is not a framed spill chunk (expected "
            f"magic {_FRAME_MAGIC!r} + header, found {len(blob)} "
            f"bytes)", chunk=chunk, path=path)
    (hlen,) = struct.unpack("<I", blob[4:8])
    try:
        header = json.loads(blob[8:8 + hlen])
        expected = int(header["nbytes"])
        stored_crc = int(header["crc32"])
        dtype = np.dtype(header["dtype"])
        shape = tuple(int(s) for s in header["shape"])
    except Exception as e:
        raise SpillCorrupt(
            f"{where}: torn frame header in {path} "
            f"({type(e).__name__}: {e})", chunk=chunk, path=path) from e
    payload = blob[8 + hlen:]
    if len(payload) != expected:
        raise SpillCorrupt(
            f"{where}: truncated payload in {path} — expected "
            f"{expected} bytes, found {len(payload)}",
            chunk=chunk, path=path)
    payload = fault_point("spill.read", payload)
    verify_s = 0.0
    if verify:
        t0 = time.perf_counter()
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        verify_s = time.perf_counter() - t0
        if crc != stored_crc:
            raise SpillCorrupt(
                f"{where}: crc32 mismatch in {path} (stored "
                f"{stored_crc:#010x}, found {crc:#010x}) — disk "
                f"bit rot or tampering", chunk=chunk, path=path)
    try:
        arr = np.frombuffer(payload, dtype=dtype).reshape(shape)
    except ValueError as e:
        raise SpillCorrupt(
            f"{where}: payload in {path} does not reshape to "
            f"{shape} {dtype} ({e})", chunk=chunk, path=path) from e
    return arr, verify_s


class SpillWriter:
    """Append-only writer of a binned row-chunk spill directory.

    ``append`` writes each chunk as a framed ``chunk_{i:06d}.bin``
    (narrowed to ``dtype``, crc32-stamped); ``finalize`` publishes the
    manifest atomically and returns a ``SpillReader``. Chunks may hold
    uneven row counts; the feature count and dtype stay fixed."""

    def __init__(self, path: str, dtype: Any = np.uint8) -> None:
        self.path = path
        self.dtype = np.dtype(dtype)
        self.chunk_rows: List[int] = []
        self.n_features: Optional[int] = None
        self._sealed = False
        os.makedirs(path, exist_ok=True)

    def append(self, chunk: np.ndarray) -> None:
        if self._sealed:
            raise RuntimeError("SpillWriter already finalized")
        c = np.ascontiguousarray(chunk)
        if c.ndim != 2:
            raise ValueError(f"spill chunks must be 2-d, got {c.shape}")
        if self.n_features is None:
            self.n_features = int(c.shape[1])
        elif c.shape[1] != self.n_features:
            raise ValueError(
                f"chunk has {c.shape[1]} features, expected {self.n_features}")
        i = len(self.chunk_rows)
        write_chunk(os.path.join(self.path, f"chunk_{i:06d}.bin"),
                    c.astype(self.dtype, copy=False))
        self.chunk_rows.append(int(c.shape[0]))

    def finalize(self) -> "SpillReader":
        if self.n_features is None:
            raise ValueError("spill has no chunks")
        meta = {
            "version": 2,
            "dtype": self.dtype.name,
            "n_features": self.n_features,
            "chunk_rows": self.chunk_rows,
            "total_rows": int(sum(self.chunk_rows)),
        }
        atomic_write(os.path.join(self.path, _SPILL_MANIFEST),
                     json.dumps(meta, indent=1))
        self._sealed = True
        return SpillReader(self.path)


class SpillReader:
    """Reader of a sealed spill directory (see ``SpillWriter``).

    ``read`` verifies chunk checksums as ``resolve_spill_verify`` says
    (auto: the first read of each chunk), adding the cost to
    ``verify_s`` / ``verify_chunks``; ``repair`` rewrites one chunk from
    trusted source rows after a detected corruption (``repairs``)."""

    def __init__(self, path: str) -> None:
        self.path = path
        meta_path = os.path.join(path, _SPILL_MANIFEST)
        try:
            with open(meta_path) as fh:
                meta = json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            raise SpillCorrupt(
                f"spill manifest missing or unreadable at {meta_path} "
                f"({type(e).__name__}: {e}) — the spill was never "
                "sealed or the directory is damaged",
                path=meta_path) from e
        self.dtype = np.dtype(meta["dtype"])
        self.n_features = int(meta["n_features"])
        self.chunk_rows: List[int] = [int(r) for r in meta["chunk_rows"]]
        self.total_rows = int(meta["total_rows"])
        self.offsets: List[int] = []
        off = 0
        for r in self.chunk_rows:
            self.offsets.append(off)
            off += r
        self.verify_mode = resolve_spill_verify()
        self.verify_s = 0.0
        self.verify_chunks = 0
        self.repairs = 0
        self._verified: Set[int] = set()

    @property
    def num_chunks(self) -> int:
        return len(self.chunk_rows)

    def _chunk_path(self, i: int) -> str:
        return os.path.join(self.path, f"chunk_{i:06d}.bin")

    def read(self, i: int) -> np.ndarray:
        check = (self.verify_mode == "on"
                 or (self.verify_mode == "auto"
                     and i not in self._verified))
        arr, vs = read_chunk(self._chunk_path(i), verify=check, chunk=i)
        if check:
            self.verify_s += vs
            self.verify_chunks += 1
            self._verified.add(i)
        if (arr.dtype != self.dtype
                or arr.shape != (self.chunk_rows[i], self.n_features)):
            raise SpillCorrupt(
                f"spill chunk {i}: {self._chunk_path(i)} holds "
                f"{arr.shape} {arr.dtype}, manifest says "
                f"({self.chunk_rows[i]}, {self.n_features}) "
                f"{self.dtype}", chunk=i, path=self._chunk_path(i))
        return arr

    def repair(self, i: int, chunk: np.ndarray) -> None:
        """Rewrite chunk ``i`` from re-derived source rows (binning is
        deterministic on fixed edges, so the bytes are the originals)."""
        c = np.ascontiguousarray(chunk).astype(self.dtype, copy=False)
        if c.shape != (self.chunk_rows[i], self.n_features):
            raise ValueError(
                f"repair chunk {i}: source produced {c.shape}, spill "
                f"expects ({self.chunk_rows[i]}, {self.n_features})")
        write_chunk(self._chunk_path(i), c)
        self.repairs += 1
        # the frame was just built from trusted bytes: its first-read
        # verification is discharged
        self._verified.add(i)

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(self.num_chunks):
            yield self.read(i)


class ChunkStore:
    """Per-chunk array store for out-of-core per-row state (the raw-score
    carry, quantized grad/hess, node ids), chunked as the companion
    spill. Entries are overwritten in place each iteration through a
    temporary file and ``os.replace``, so a torn write never corrupts a
    chunk, and carry the spill's framed crc32: under
    ``MMLSPARK_TORCH_SPILL_VERIFY=auto`` each entry is verified on its
    first read after every ``put``."""

    def __init__(self, path: str, name: str) -> None:
        self.path = path
        self.name = name
        self.verify_mode = resolve_spill_verify()
        self.verify_s = 0.0
        self.verify_chunks = 0
        self._verified: Set[int] = set()
        os.makedirs(path, exist_ok=True)

    def _file(self, i: int) -> str:
        return os.path.join(self.path, f"{self.name}_{i:06d}.bin")

    def put(self, i: int, arr: np.ndarray) -> None:
        write_chunk(self._file(i), np.ascontiguousarray(arr))
        self._verified.discard(i)

    def get(self, i: int) -> np.ndarray:
        path = self._file(i)
        check = (self.verify_mode == "on"
                 or (self.verify_mode == "auto"
                     and i not in self._verified))
        arr, vs = read_chunk(path, verify=check, chunk=i,
                             label=f"chunk store {self.name!r}")
        if check:
            self.verify_s += vs
            self.verify_chunks += 1
            self._verified.add(i)
        return arr
