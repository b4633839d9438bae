"""Weight carry-over from the JAX package: a booster fitted there (the
arrays of its ``BoosterArrays.state_dict()``) becomes the port's
``BoosterArrays``, and a fitted estimator model (its ``_get_state()``
and its param map) becomes the port's model. Decision bits and category
bitsets cross with the booster, and a categorical ``BinMapper`` with
the model. Only numpy arrays and plain values cross; nothing of JAX is
imported."""

from __future__ import annotations

from typing import Any, Dict

from mmlspark_tpu_torch.models.gbdt import estimators
from mmlspark_tpu_torch.models.gbdt.booster import BoosterArrays


def booster_from_jax_state(state: Dict[str, Any]) -> BoosterArrays:
    """``state``: the dict of a JAX ``BoosterArrays.state_dict()`` (arrays
    as numpy). The returned booster keeps host arrays; its ``predict`` /
    ``predict_binned`` take the device to score on (the card unless
    ``device="cpu"``)."""
    return BoosterArrays.from_state_dict(state)


def model_from_jax(class_name: str, state: Dict[str, Any],
                   params: Dict[str, Any]):
    """A fitted JAX estimator model as the port's model of the same class
    (``"LightGBMClassificationModel"``, binary or multiclass,
    ``"LightGBMRegressionModel"`` or ``"LightGBMRankerModel"``):
    ``state`` is its ``_get_state()`` with arrays as numpy (booster,
    training ``BinMapper``, best iteration, and a classifier's
    ``num_classes`` and ``classes_``), ``params`` its simple param map
    (``simple_param_values()``). The model runs on the card unless
    ``set_device("cpu")`` is called."""
    cls = getattr(estimators, class_name)
    model = cls(**{k: v for k, v in params.items() if cls.has_param(k)})
    model._set_state(state)
    return model
