"""Stage persistence and crash-safe checkpoints — the port's copy of
``save_stage`` / ``load_stage`` and of the checkpoint store
(``atomic_write``, ``save_checkpoint``, ``load_latest_checkpoint``,
``dir_digest``) from the JAX package's ``core/serialize.py``, in the
same on-disk layout.

Simple params go to ``metadata.json``, complex params (numpy arrays,
nested stages) to side files, learned state to ``state.json`` plus
``arrays.npz``, and classes are resolved by qualified name on load. A
class path of the JAX package (``mmlspark_tpu.<module>.<Name>``)
resolves to the port's class at the mirrored path, so a stage saved by
either package loads here without importing the JAX one.
"""

from __future__ import annotations

import importlib
import json
import os
from typing import Any, Dict, Optional

import numpy as np

_METADATA = "metadata.json"
_ARRAYS = "arrays.npz"
_JAX_PACKAGE = "mmlspark_tpu"
_PORT_PACKAGE = "mmlspark_tpu_torch"


def _qualname(obj: Any) -> str:
    cls = type(obj)
    return f"{cls.__module__}.{cls.__qualname__}"


def _resolve(qualname: str):
    module, _, name = qualname.rpartition(".")
    top, dot, rest = module.partition(".")
    if top == _JAX_PACKAGE:
        module = _PORT_PACKAGE + dot + rest
    mod = importlib.import_module(module)
    obj = mod
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def save_stage(stage: Any, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    meta: Dict[str, Any] = {
        "class": _qualname(stage),
        "uid": stage.uid,
        "params": stage.simple_param_values(),
        "complexParams": [],
        "frameworkVersion": _framework_version(),
    }
    arrays: Dict[str, np.ndarray] = {}
    for name, value in stage.complex_param_values().items():
        kind = _store_complex(name, value, path, arrays)
        meta["complexParams"].append({"name": name, "kind": kind})
    state = stage._get_state() if hasattr(stage, "_get_state") else None
    if state is not None:
        meta["hasState"] = True
        _store_state(state, path, arrays)
    if arrays:
        np.savez_compressed(os.path.join(path, _ARRAYS), **arrays)
    with open(os.path.join(path, _METADATA), "w") as f:
        json.dump(meta, f, indent=2, default=_json_default)


def load_stage(path: str) -> Any:
    with open(os.path.join(path, _METADATA)) as f:
        meta = json.load(f)
    cls = _resolve(meta["class"])
    stage = cls.__new__(cls)
    stage._paramMap = {}
    stage.uid = meta["uid"]
    if hasattr(stage, "_init_empty"):
        stage._init_empty()
    stage._set(**meta["params"])
    arrays = {}
    arr_path = os.path.join(path, _ARRAYS)
    if os.path.exists(arr_path):
        with np.load(arr_path, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
    for entry in meta["complexParams"]:
        value = _load_complex(entry["name"], entry["kind"], path, arrays)
        stage._paramMap[entry["name"]] = value
    if meta.get("hasState") and hasattr(stage, "_set_state"):
        stage._set_state(_load_state(path, arrays))
    return stage


# -- complex param encoding --------------------------------------------------

def _store_complex(name: str, value: Any, path: str, arrays: Dict[str, np.ndarray]) -> str:
    from mmlspark_tpu_torch.core.pipeline import PipelineStage

    if isinstance(value, PipelineStage):
        save_stage(value, os.path.join(path, f"param_{name}"))
        return "stage"
    if isinstance(value, np.ndarray):
        arrays[f"param__{name}"] = value
        return "array"
    if isinstance(value, (list, tuple)) and value and isinstance(value[0], PipelineStage):
        for i, st in enumerate(value):
            save_stage(st, os.path.join(path, f"param_{name}", str(i)))
        with open(os.path.join(path, f"param_{name}", "count.json"), "w") as f:
            json.dump(len(value), f)
        return "stage_list"
    if isinstance(value, (bytes, bytearray)):
        with open(os.path.join(path, f"param_{name}.bin"), "wb") as f:
            f.write(value)
        return "bytes"
    # last resort: JSON-able structure
    with open(os.path.join(path, f"param_{name}.json"), "w") as f:
        json.dump(value, f, default=_json_default)
    return "json"


def _load_complex(name: str, kind: str, path: str, arrays: Dict[str, np.ndarray]) -> Any:
    if kind == "stage":
        return load_stage(os.path.join(path, f"param_{name}"))
    if kind == "array":
        return arrays[f"param__{name}"]
    if kind == "stage_list":
        base = os.path.join(path, f"param_{name}")
        with open(os.path.join(base, "count.json")) as f:
            n = json.load(f)
        return [load_stage(os.path.join(base, str(i))) for i in range(n)]
    if kind == "bytes":
        with open(os.path.join(path, f"param_{name}.bin"), "rb") as f:
            return f.read()
    with open(os.path.join(path, f"param_{name}.json")) as f:
        return json.load(f)


# -- model state (learned attributes, not params) ----------------------------

def _store_state(state: Dict[str, Any], path: str, arrays: Dict[str, np.ndarray]) -> None:
    plain: Dict[str, Any] = {}
    for k, v in state.items():
        if isinstance(v, np.ndarray):
            arrays[f"state__{k}"] = v
        else:
            plain[k] = v
    with open(os.path.join(path, "state.json"), "w") as f:
        json.dump(plain, f, default=_json_default)


def _load_state(path: str, arrays: Dict[str, np.ndarray]) -> Dict[str, Any]:
    state: Dict[str, Any] = {}
    sp = os.path.join(path, "state.json")
    if os.path.exists(sp):
        with open(sp) as f:
            state.update(json.load(f))
    for k, v in arrays.items():
        if k.startswith("state__"):
            state[k[len("state__"):]] = v
    return state


def _json_default(o: Any):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def _framework_version() -> str:
    import mmlspark_tpu_torch
    return f"{_PORT_PACKAGE} {mmlspark_tpu_torch.__version__}"


# ---------------------------------------------------------------------------
# Crash-safe checkpoints (atomic write-rename, monotonic tag, config hash)
# ---------------------------------------------------------------------------
#
# The training-side recovery protocol of the GBDT elastic restart
# (models/gbdt/estimators.py):
#
#   - every file lands via write-to-tmp + os.replace, so readers only
#     ever see complete files (a SIGKILLed writer leaves a .tmp that is
#     never picked up);
#   - a checkpoint is a payload file plus a small JSON manifest written
#     LAST — the manifest replace is the commit point; a payload with
#     no manifest is invisible;
#   - manifests carry a caller-supplied config hash; resuming under a
#     different config/dataset is refused instead of silently
#     continuing an incompatible model.

class DiskFull(OSError):
    """Attributed wrapper for write-path OSErrors (ENOSPC, quota, dead
    mounts) and armed ``io.disk_full`` faults. Subclasses OSError so
    every checkpoint-skip degradation handler catches it unchanged; the
    message names the ``io.disk_full`` fault point."""


class CheckpointCorrupt(RuntimeError):
    """A committed checkpoint payload failed its recorded digest or a
    caller-supplied ``validate`` hook — silent bit-rot, not a torn
    write. Raised internally by :func:`load_latest_checkpoint` and
    routed through the same skip-and-fall-back path."""


def atomic_write(path: str, data, mode: str = "w") -> None:
    """Write-then-rename so a crash mid-write never tears ``path``.

    An OSError from the write (or an armed ``io.disk_full`` fault)
    comes back as the attributed :class:`DiskFull` so degradation
    handlers can tell a full store from a logic bug."""
    from mmlspark_tpu_torch.core.faults import FaultInjected, fault_point
    fault_point("checkpoint.write")
    tmp = path + ".tmp"
    try:
        fault_point("io.disk_full")
        with open(tmp, mode) as fh:
            fh.write(data)
        os.replace(tmp, path)
    except (OSError, FaultInjected) as e:
        raise DiskFull(
            f"[io.disk_full] write failed for {path} "
            f"({type(e).__name__}: {e})") from e


def save_checkpoint(ckpt_dir: str, tag: int, state: Dict[str, Any],
                    config_hash: str) -> str:
    """Persist ``state`` (numpy arrays or tensors + JSON-able scalars) as
    checkpoint ``tag``; returns the manifest path. ``tag`` must be the
    monotonic progress counter (iteration / pass) — ``load_latest``
    resumes from the highest committed one. The manifest records a
    crc32 digest of the payload bytes so a later load detects silent
    bit-rot, not just torn writes."""
    import io as io_mod
    import zlib

    from mmlspark_tpu_torch.core.faults import FaultInjected, fault_point
    fault_point("checkpoint.write")
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    plain: Dict[str, Any] = {}
    for k, v in state.items():
        if isinstance(v, np.ndarray) or _is_tensor(v):
            arrays[k] = _to_numpy(v)
        else:
            plain[k] = v
    stem = os.path.join(ckpt_dir, f"ckpt_{tag:08d}")
    buf = io_mod.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    tmp = stem + ".npz.tmp"
    try:
        fault_point("io.disk_full")
        with open(tmp, "wb") as fh:
            fh.write(payload)
        os.replace(tmp, stem + ".npz")
    except (OSError, FaultInjected) as e:
        raise DiskFull(
            f"[io.disk_full] checkpoint payload write failed for "
            f"{stem}.npz ({type(e).__name__}: {e})") from e
    manifest = {"tag": int(tag), "configHash": config_hash,
                "plain": plain, "arrayKeys": sorted(arrays),
                "payloadCrc32": zlib.crc32(payload) & 0xFFFFFFFF,
                "payloadBytes": len(payload),
                "frameworkVersion": _framework_version()}
    atomic_write(stem + ".json", json.dumps(manifest, indent=2,
                                            default=_json_default))
    return stem + ".json"


def load_latest_checkpoint(ckpt_dir: str,
                           config_hash: Optional[str] = None,
                           validate=None):
    """Newest committed checkpoint as ``(tag, state)``; ``None`` when
    the directory holds none.

    A manifest with a different ``config_hash`` raises ValueError
    ("different config or dataset") — resuming must never silently
    continue an incompatible run. A torn or unreadable checkpoint
    (truncated manifest, missing payload), a payload failing its
    recorded crc32 digest (bit-rot — checked whenever the manifest
    carries one, unless MMLSPARK_TORCH_SPILL_VERIFY=off), or a non-None
    return from the optional ``validate(tag, state)`` hook is skipped
    with a once-per-process warning and the scan falls back to the
    previous tag — corrupt debris degrades recovery depth, not
    correctness."""
    import io as io_mod
    import re
    import zlib

    from mmlspark_tpu_torch.core.logging_utils import warn_once

    if not os.path.isdir(ckpt_dir):
        return None
    tags = sorted(
        (int(m.group(1)) for m in (
            re.fullmatch(r"ckpt_(\d+)\.json", name)
            for name in os.listdir(ckpt_dir)) if m),
        reverse=True)
    verify = _checkpoint_verify_enabled()
    for tag in tags:
        stem = os.path.join(ckpt_dir, f"ckpt_{tag:08d}")
        try:
            with open(stem + ".json") as fh:
                manifest = json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            _skip_corrupt(ckpt_dir, stem, e, warn_once)
            continue
        if config_hash is not None \
                and manifest.get("configHash") != config_hash:
            raise ValueError(
                f"checkpoint {stem}.json was produced by a "
                "different config or dataset (hash "
                f"{manifest.get('configHash')!r} != {config_hash!r});"
                " clear the directory to train fresh")
        try:
            state: Dict[str, Any] = dict(manifest.get("plain") or {})
            keys = manifest.get("arrayKeys") or []
            if keys:
                stored_crc = manifest.get("payloadCrc32")
                if verify and stored_crc is not None:
                    with open(stem + ".npz", "rb") as fh:
                        payload = fh.read()
                    crc = zlib.crc32(payload) & 0xFFFFFFFF
                    if crc != int(stored_crc):
                        raise CheckpointCorrupt(
                            f"payload {stem}.npz fails its recorded "
                            f"crc32 (manifest {int(stored_crc):#010x}, "
                            f"on disk {crc:#010x}) — silent bit-rot, "
                            "not a torn write")
                    z = np.load(io_mod.BytesIO(payload),
                                allow_pickle=False)
                else:
                    z = np.load(stem + ".npz", allow_pickle=False)
                with z:
                    for k in keys:
                        state[k] = z[k]
            if validate is not None:
                problem = validate(int(manifest["tag"]), state)
                if problem:
                    raise CheckpointCorrupt(str(problem))
            return int(manifest["tag"]), state
        except Exception as e:  # missing/torn/bit-rotted payload
            _skip_corrupt(ckpt_dir, stem, e, warn_once)
    return None


def _checkpoint_verify_enabled() -> bool:
    """Checkpoint digests are verified under SPILL_VERIFY auto AND on
    (a checkpoint is read once per recovery — the cost is noise, the
    miss is a corrupted model); only an explicit off trusts the disk."""
    from mmlspark_tpu_torch.ops.ingest import resolve_spill_verify
    return resolve_spill_verify() != "off"


def dir_digest(path: str) -> str:
    """crc32 digest over a directory's file names + contents (sorted,
    recursive) — the cheap payload fingerprint a refresh generation
    records in its checkpoint manifest so a bit-rotted model dir is
    detected at resume and skipped for the previous generation."""
    import zlib
    crc = 0
    for root, dirs, files in os.walk(path):
        dirs.sort()
        for name in sorted(files):
            fp = os.path.join(root, name)
            rel = os.path.relpath(fp, path)
            crc = zlib.crc32(rel.encode(), crc)
            with open(fp, "rb") as fh:
                for block in iter(lambda: fh.read(1 << 20), b""):
                    crc = zlib.crc32(block, crc)
    return f"{crc & 0xFFFFFFFF:08x}"


def _skip_corrupt(ckpt_dir: str, stem: str, e: BaseException,
                  warn_once) -> None:
    warn_once(f"checkpoint.corrupt.{ckpt_dir}",
              "skipping unreadable checkpoint %s (%s: %s); "
              "falling back to an earlier one",
              stem, type(e).__name__, e)


def _is_tensor(v: Any) -> bool:
    return type(v).__module__.startswith("torch") and hasattr(v, "detach")


def _to_numpy(v: Any) -> np.ndarray:
    return v.detach().cpu().numpy() if _is_tensor(v) else np.asarray(v)
