"""Stage persistence: save/load of transformers, models and pipelines —
the port's copy of ``save_stage`` / ``load_stage`` from the JAX
package's ``core/serialize.py``, in the same on-disk layout.

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
from typing import Any, Dict

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
