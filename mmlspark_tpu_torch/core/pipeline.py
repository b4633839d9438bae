"""Estimator / Transformer / Model / Pipeline abstractions — the port's
copy of the JAX package's ``core/pipeline.py``.

The L5 layer of the reference (SURVEY.md §1): every public stage is a
Spark ML ``Estimator[M]`` or ``Transformer`` with ``Params``
(e.g. lightgbm/.../LightGBMBase.scala:27-29). Here the same triad sits on
the columnar :class:`~mmlspark_tpu_torch.core.dataframe.DataFrame`; telemetry
wrapping (logFit/logTransform, SynapseMLLogging.scala:153) is built into
the base classes rather than mixed in per stage.
"""

from __future__ import annotations

from abc import abstractmethod
from typing import Any, List, Optional, Sequence

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.logging_utils import log_stage_method, new_uid
from mmlspark_tpu_torch.core.param import Param, Params
from mmlspark_tpu_torch.core.serialize import load_stage, save_stage


class PipelineStage(Params):
    """Common base: uid, params, persistence."""

    def __init__(self, **kwargs: Any):
        super().__init__(**kwargs)
        self.uid = new_uid(type(self).__name__)

    def _init_empty(self) -> None:
        """Hook for deserialization before params are restored."""

    def save(self, path: str) -> None:
        save_stage(self, path)

    @staticmethod
    def load(path: str) -> "PipelineStage":
        return load_stage(path)


class Transformer(PipelineStage):
    def transform(self, dataset: DataFrame) -> DataFrame:
        with log_stage_method(self.uid, type(self).__name__, "transform",
                              {"numRows": dataset.num_rows}):
            return self._transform(dataset)

    @abstractmethod
    def _transform(self, dataset: DataFrame) -> DataFrame:
        ...


class Estimator(PipelineStage):
    def fit(self, dataset: DataFrame) -> "Model":
        with log_stage_method(self.uid, type(self).__name__, "fit",
                              {"numRows": dataset.num_rows}):
            model = self._fit(dataset)
        model.parent_uid = self.uid
        return model

    @abstractmethod
    def _fit(self, dataset: DataFrame) -> "Model":
        ...


class Model(Transformer):
    """A fitted transformer. Learned state lives in attributes surfaced
    through ``_get_state``/``_set_state`` for persistence."""

    parent_uid: Optional[str] = None

    def _get_state(self) -> Optional[dict]:
        return None

    def _set_state(self, state: dict) -> None:
        pass


class Pipeline(Estimator):
    """Sequential stages; estimators are fitted and replaced by models."""

    stages = Param("stages", "ordered pipeline stages", is_complex=True)

    def __init__(self, stages: Optional[Sequence[PipelineStage]] = None, **kwargs: Any):
        super().__init__(**kwargs)
        if stages is not None:
            self._paramMap["stages"] = list(stages)

    def _fit(self, dataset: DataFrame) -> "PipelineModel":
        stages = list(self.get("stages") or [])
        fitted: List[Transformer] = []
        df = dataset
        for i, stage in enumerate(stages):
            is_last = i == len(stages) - 1
            if isinstance(stage, Estimator):
                model = stage.fit(df)
                fitted.append(model)
                if not is_last:  # the last stage's output feeds nothing
                    df = model.transform(df)
            elif isinstance(stage, Transformer):
                fitted.append(stage)
                if not is_last:
                    df = stage.transform(df)
            else:
                raise TypeError(f"pipeline stage {stage!r} is neither "
                                f"Estimator nor Transformer")
        return PipelineModel(fitted)


class PipelineModel(Model):
    stages = Param("stages", "fitted pipeline stages", is_complex=True)

    def __init__(self, stages: Optional[Sequence[Transformer]] = None, **kwargs: Any):
        super().__init__(**kwargs)
        if stages is not None:
            self._paramMap["stages"] = list(stages)

    def _transform(self, dataset: DataFrame) -> DataFrame:
        df = dataset
        for stage in self.get("stages") or []:
            df = stage.transform(df)
        return df
