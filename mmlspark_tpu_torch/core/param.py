"""Typed parameter system — the port's copy of the JAX package's
``core/param.py``.

Analog of Spark ML `Params` as extended by the reference
(core/src/main/scala/.../codegen/Wrappable.scala and
core/serialize/ComplexParam.scala): every pipeline stage declares typed,
validated, documented params; simple params serialize to JSON, complex
params (arrays, models, callables) serialize as side objects.

Unlike the reference there is no codegen layer — Python is the primary
surface, so the param declared here *is* the user API.
"""

from __future__ import annotations

import copy as _copy
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple


class ParamValidationError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Type converters (analog of pyspark.ml.param.TypeConverters)
# ---------------------------------------------------------------------------

def to_int(v: Any) -> int:
    import numpy as np
    if isinstance(v, (bool, np.bool_)):
        raise ParamValidationError(f"expected int, got bool {v!r}")
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)) and float(v).is_integer():
        return int(v)
    raise ParamValidationError(f"expected int, got {v!r}")


def to_float(v: Any) -> float:
    import numpy as np
    if isinstance(v, (bool, np.bool_)):
        raise ParamValidationError(f"expected float, got bool {v!r}")
    if isinstance(v, (int, float, np.integer, np.floating)):
        return float(v)
    raise ParamValidationError(f"expected float, got {v!r}")


def to_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    raise ParamValidationError(f"expected bool, got {v!r}")


def to_str(v: Any) -> str:
    if isinstance(v, str):
        return v
    raise ParamValidationError(f"expected str, got {v!r}")


def to_list(elem: Callable[[Any], Any]) -> Callable[[Any], List[Any]]:
    def conv(v: Any) -> List[Any]:
        if isinstance(v, (list, tuple)):
            return [elem(x) for x in v]
        raise ParamValidationError(f"expected list, got {v!r}")

    return conv


def identity(v: Any) -> Any:
    return v


# ---------------------------------------------------------------------------
# Validators
# ---------------------------------------------------------------------------

def in_range(lo: float, hi: float, lo_inclusive: bool = True,
             hi_inclusive: bool = True) -> Callable[[Any], bool]:
    def check(v: Any) -> bool:
        above = v >= lo if lo_inclusive else v > lo
        below = v <= hi if hi_inclusive else v < hi
        return above and below

    check.__doc__ = f"in range {'[' if lo_inclusive else '('}{lo}, {hi}{']' if hi_inclusive else ')'}"
    return check


def gt(lo: float) -> Callable[[Any], bool]:
    def check(v: Any) -> bool:
        return v > lo

    check.__doc__ = f"> {lo}"
    return check


def ge(lo: float) -> Callable[[Any], bool]:
    def check(v: Any) -> bool:
        return v >= lo

    check.__doc__ = f">= {lo}"
    return check


def one_of(*options: Any) -> Callable[[Any], bool]:
    def check(v: Any) -> bool:
        return v in options

    check.__doc__ = f"one of {options}"
    return check


# ---------------------------------------------------------------------------
# Param + Params
# ---------------------------------------------------------------------------

class Param:
    """A named, documented, typed parameter attached to a :class:`Params` class.

    ``is_complex`` marks params whose values are not JSON-serializable
    (arrays, nested models, callables) — the analog of the reference's
    ``ComplexParam`` (core/serialize/ComplexParam.scala:1); they are
    persisted as side objects by ``mmlspark_tpu_torch.core.serialize``.
    """

    def __init__(self, name: str, doc: str,
                 converter: Callable[[Any], Any] = identity,
                 validator: Optional[Callable[[Any], bool]] = None,
                 default: Any = None,
                 is_complex: bool = False):
        self.name = name
        self.doc = doc
        self.converter = converter
        self.validator = validator
        self.default = default
        self.is_complex = is_complex

    def validate(self, value: Any) -> Any:
        value = self.converter(value)
        if self.validator is not None and not self.validator(value):
            constraint = getattr(self.validator, "__doc__", None) or "custom constraint"
            raise ParamValidationError(
                f"param {self.name}={value!r} violates constraint: {constraint}")
        return value

    def __repr__(self) -> str:
        return f"Param({self.name})"


class Params:
    """Base class giving a stage a typed param map with defaults.

    Mirrors Spark ML ``Params`` semantics used throughout the reference:
    ``get``/``set``/``has_param``, default vs. explicitly-set values,
    ``copy`` with overrides, and an ``explain_params`` dump.
    """

    def __init__(self, **kwargs: Any):
        self._paramMap: Dict[str, Any] = {}
        self._set(**kwargs)

    # -- param registry -----------------------------------------------------
    @classmethod
    def params(cls) -> List[Param]:
        out: Dict[str, Param] = {}
        for klass in reversed(cls.__mro__):
            for v in vars(klass).values():
                if isinstance(v, Param):
                    out[v.name] = v
        return list(out.values())

    @classmethod
    def get_param(cls, name: str) -> Param:
        for p in cls.params():
            if p.name == name:
                return p
        raise KeyError(f"{cls.__name__} has no param {name!r}")

    @classmethod
    def has_param(cls, name: str) -> bool:
        return any(p.name == name for p in cls.params())

    # -- get/set ------------------------------------------------------------
    def _set(self, **kwargs: Any) -> "Params":
        for k, v in kwargs.items():
            p = self.get_param(k)  # validates the name even for None
            if v is None:
                self._paramMap.pop(k, None)  # None clears an explicit value
                continue
            self._paramMap[k] = p.validate(v)
        return self

    def set(self, name: str, value: Any) -> "Params":
        return self._set(**{name: value})

    def get(self, name: str) -> Any:
        p = self.get_param(name)
        if name in self._paramMap:
            return self._paramMap[name]
        return p.default

    def get_or_default(self, name: str) -> Any:
        return self.get(name)

    def is_set(self, name: str) -> bool:
        return name in self._paramMap

    def explain_params(self) -> str:
        lines = []
        for p in sorted(self.params(), key=lambda p: p.name):
            cur = self.get(p.name)
            lines.append(f"{p.name}: {p.doc} (default: {p.default!r}, current: {cur!r})")
        return "\n".join(lines)

    def copy(self, **overrides: Any) -> "Params":
        new = _copy.copy(self)
        new._paramMap = dict(self._paramMap)
        new._set(**overrides)
        return new

    # -- serialization helpers ---------------------------------------------
    def simple_param_values(self) -> Dict[str, Any]:
        return {k: v for k, v in self._paramMap.items()
                if not self.get_param(k).is_complex}

    def complex_param_values(self) -> Dict[str, Any]:
        return {k: v for k, v in self._paramMap.items()
                if self.get_param(k).is_complex}

    def iter_set_params(self) -> Iterator[Tuple[Param, Any]]:
        for k, v in self._paramMap.items():
            yield self.get_param(k), v

    def __repr__(self) -> str:
        kv = ", ".join(f"{k}={v!r}" for k, v in sorted(self._paramMap.items())
                       if not self.get_param(k).is_complex)
        return f"{type(self).__name__}({kv})"


class HasInputCol(Params):
    inputCol = Param("inputCol", "name of the input column", to_str, default="input")


class HasInputCols(Params):
    inputCols = Param("inputCols", "names of the input columns", to_list(to_str))


class HasOutputCol(Params):
    outputCol = Param("outputCol", "name of the output column", to_str, default="output")


class HasFeaturesCol(Params):
    featuresCol = Param("featuresCol", "features column name", to_str, default="features")


class HasLabelCol(Params):
    labelCol = Param("labelCol", "label column name", to_str, default="label")


class HasWeightCol(Params):
    weightCol = Param("weightCol", "sample-weight column name", to_str)


class HasPredictionCol(Params):
    predictionCol = Param("predictionCol", "prediction column name", to_str,
                          default="prediction")
