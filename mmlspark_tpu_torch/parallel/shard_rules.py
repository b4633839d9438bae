"""Inference autocast policy — the port's copy of
``resolve_infer_autocast`` and ``placement_cast`` from the JAX package's
``parallel/shard_rules.py`` (the rule tables themselves are for meshes,
ROADMAP A8)."""

from __future__ import annotations

from typing import Optional

import torch

from mmlspark_tpu_torch.core import env


def resolve_infer_autocast() -> str:
    """``MMLSPARK_TORCH_INFER_AUTOCAST``: off (default, the bitwise arm)
    or bf16. Unknown values warn once and fall back to off."""
    mode = (env.env_str(env.INFER_AUTOCAST, "off") or "off").strip().lower()
    mode = mode or "off"
    if mode not in ("off", "bf16"):
        env.warn_once(env.INFER_AUTOCAST,
                      f"{env.INFER_AUTOCAST}={mode!r} not in off|bf16; "
                      "using off")
        mode = "off"
    return mode


def placement_cast(x: torch.Tensor,
                   dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The one low-precision placement seam: cast a floating ``x`` to
    ``dtype`` (round to nearest even); ``None`` or a non-float ``x``
    passes through unchanged."""
    if dtype is not None and x.is_floating_point():
        return x.to(dtype)
    return x
