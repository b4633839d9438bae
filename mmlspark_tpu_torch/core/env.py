"""Environment-variable readers for the port's knobs.

The port's own copy of the readers it needs from the JAX package's
``core/env.py`` (``env_str``, ``env_flag`` and the warn-once contract).
Port knobs are named ``MMLSPARK_TORCH_*`` and read only here and by the
module that owns each one:

  - ``MMLSPARK_TORCH_HIST_QUANT``  off|q16|q8 (``trainer.resolve_hist_quant``)
  - ``MMLSPARK_TORCH_HIST_SUB``    0|1 (``trainer.resolve_subtract``)

Parsing contract, as in the JAX package: a malformed value must not
abort or silently mislabel a run, so it warns once per variable and the
default applies.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Set

_TRUTHY = frozenset(("1", "true", "yes", "on"))
_FALSEY = frozenset(("0", "false", "off", "no"))

_WARNED: Set[str] = set()


def warn_once(name: str, message: str) -> None:
    """Warn about variable ``name`` once per process."""
    if name in _WARNED:
        return
    _WARNED.add(name)
    warnings.warn(message, stacklevel=3)


def reset_warnings() -> None:
    """Forget which variables already warned (test hook)."""
    _WARNED.clear()


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """String knob, unstripped (callers strip and validate)."""
    v = os.environ.get(name)
    return default if v is None else v


def env_flag(name: str, default: bool = False) -> bool:
    """Boolean knob: 1/true/yes/on -> True, 0/false/off/no -> False
    (case-insensitive); unset/empty -> ``default``; anything else warns
    once and returns ``default``."""
    v = os.environ.get(name)
    if v is None:
        return default
    v = v.strip().lower()
    if not v:
        return default
    if v in _TRUTHY:
        return True
    if v in _FALSEY:
        return False
    warn_once(name, f"{name}={v!r} is not a recognized boolean "
                    f"(1/true/yes/on or 0/false/off/no); using {default}")
    return default
