"""Structured telemetry on every fit/transform — the port's copy of what
the pipeline stages use from the JAX package's ``core/logging_utils.py``
(``new_uid``, ``log_stage_method``, ``warn_once``, the sink and the
secret scrubber).

Each stage's fit/transform is wrapped in a JSON record carrying uid,
class, method, wall-clock seconds and error info, with credential-looking
substrings scrubbed; records go to a process-local sink the host
application can drain or redirect. Knob warnings go through
``core.env.warn_once``; degradations (a skipped checkpoint, a corrupt
one passed over) through :func:`warn_once` here, which logs and records
a ``degradation`` event in the sink.
"""

from __future__ import annotations

import json
import logging
import re
import threading
import time
import traceback
import uuid
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

logger = logging.getLogger("mmlspark_tpu_torch")

_SECRET_PATTERNS = [
    re.compile(r"(sig|key|token|password|secret|authorization)=[^&\s\"]+", re.I),
    re.compile(r"Bearer\s+[A-Za-z0-9._\-]+"),
    re.compile(r"sk-[A-Za-z0-9\-_]{10,}"),
]


def scrub(text: str) -> str:
    """Remove credential-looking substrings."""
    for pat in _SECRET_PATTERNS:
        text = pat.sub(lambda m: m.group(0).split("=")[0] + "=[REDACTED]"
                       if "=" in m.group(0) else "[REDACTED]", text)
    return text


class TelemetrySink:
    """In-process event buffer; swap `emit` to forward elsewhere."""

    def __init__(self, capacity: int = 10_000):
        self.capacity = capacity
        self.events: List[Dict[str, Any]] = []
        self.enabled = True

    def emit(self, event: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        if len(self.events) >= self.capacity:
            del self.events[: self.capacity // 2]
        self.events.append(event)
        logger.debug("telemetry %s", json.dumps(event, default=str))

    def drain(self) -> List[Dict[str, Any]]:
        out, self.events = self.events, []
        return out


SINK = TelemetrySink()

_WARNED_ONCE: set = set()
_WARNED_LOCK = threading.Lock()


def warn_once(key: str, message: str, *args: Any) -> bool:
    """Log a degradation warning exactly once per process (keyed), and
    record it as a telemetry event so the sink shows it even when the
    log stream is discarded. Returns True when this call emitted."""
    with _WARNED_LOCK:
        if key in _WARNED_ONCE:
            return False
        _WARNED_ONCE.add(key)
    logger.warning(message, *args)
    SINK.emit({"event": "degradation", "key": key,
               "message": scrub(message % args if args else message)})
    return True


def reset_warn_once() -> None:
    """Test hook: forget emitted once-per-process warnings."""
    with _WARNED_LOCK:
        _WARNED_ONCE.clear()


def new_uid(prefix: str) -> str:
    return f"{prefix}_{uuid.uuid4().hex[:12]}"


@contextmanager
def log_stage_method(uid: str, class_name: str, method: str,
                     extra: Optional[Dict[str, Any]] = None):
    t0 = time.perf_counter()
    record: Dict[str, Any] = {
        "uid": uid,
        "className": class_name,
        "method": method,
        **(extra or {}),
    }
    try:
        yield record
    except Exception as e:  # noqa: BLE001 — telemetry must not swallow
        record["error"] = scrub(f"{type(e).__name__}: {e}")
        record["traceback"] = scrub(traceback.format_exc(limit=5))
        record["seconds"] = time.perf_counter() - t0
        SINK.emit(record)
        raise
    record["seconds"] = time.perf_counter() - t0
    SINK.emit(record)
