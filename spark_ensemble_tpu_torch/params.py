"""Typed, validated estimator configuration (PyTorch port).

The port's own copy of ``spark_ensemble_tpu/params.py``: declarative
``Param`` descriptors on ``Params`` subclasses with eager validation,
sklearn-style ``get_params``/``set_params``, deep ``copy`` and JSON-able
metadata.  Names, defaults and validators match the JAX package so a config
written for one package constructs the same estimator in the other.
"""

from __future__ import annotations

import copy as _copy
from typing import Any, Callable, Dict, Optional


class Param:
    """A declarative, validated parameter (reference: Spark ``Param[T]``)."""

    def __init__(
        self,
        default: Any = None,
        validator: Optional[Callable[[Any], bool]] = None,
        doc: str = "",
        is_estimator: bool = False,
    ):
        self.default = default
        self.validator = validator
        self.doc = doc
        # estimator-valued params (base_learner, ...) are excluded from
        # JSON metadata
        self.is_estimator = is_estimator
        self.name: str = ""  # filled by __set_name__

    def __set_name__(self, owner, name):
        self.name = name

    def validate(self, value: Any) -> Any:
        if value is not None and self.validator is not None:
            if not self.validator(value):
                raise ValueError(
                    f"invalid value {value!r} for param {self.name!r}"
                )
        return value

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj._param_values.get(self.name, self.default)

    def __set__(self, obj, value):
        obj._param_values[self.name] = self.validate(value)


# ---------------------------------------------------------------------------
# Validators (reference: org.apache.spark.ml.param.ParamValidators)
# ---------------------------------------------------------------------------

def gt_eq(lower):
    return lambda v: v >= lower


def gt(lower):
    return lambda v: v > lower


def in_range(lo, hi, lower_inclusive=True, upper_inclusive=True):
    def check(v):
        ok_lo = v >= lo if lower_inclusive else v > lo
        ok_hi = v <= hi if upper_inclusive else v < hi
        return ok_lo and ok_hi

    return check


def in_array(values):
    values = [v.lower() if isinstance(v, str) else v for v in values]
    return lambda v: (v.lower() if isinstance(v, str) else v) in values


class Params:
    """Base class with declared-``Param`` bookkeeping."""

    def __init__(self, **kwargs):
        self._param_values: Dict[str, Any] = {}
        unknown = set(kwargs) - set(self._param_names())
        if unknown:
            raise TypeError(
                f"{type(self).__name__} got unknown params: {sorted(unknown)}"
            )
        for name, value in kwargs.items():
            setattr(self, name, value)

    @classmethod
    def _param_defs(cls) -> Dict[str, Param]:
        out: Dict[str, Param] = {}
        for klass in reversed(cls.__mro__):
            for name, attr in vars(klass).items():
                if isinstance(attr, Param):
                    out[name] = attr
        return out

    @classmethod
    def _param_names(cls):
        return list(cls._param_defs())

    def get_params(self, deep: bool = False) -> Dict[str, Any]:
        out = {}
        for name in self._param_names():
            value = getattr(self, name)
            if deep and isinstance(value, Params):
                value = value.get_params(deep=True)
            out[name] = value
        return out

    def set_params(self, **kwargs) -> "Params":
        unknown = set(kwargs) - set(self._param_names())
        if unknown:
            raise TypeError(
                f"{type(self).__name__} got unknown params: {sorted(unknown)}"
            )
        for name, value in kwargs.items():
            setattr(self, name, value)
        return self

    def copy(self, **extra) -> "Params":
        """Deep clone, recursively copying nested estimators."""
        new = _copy.deepcopy(self)
        new.set_params(**extra)
        return new

    def config_key(self) -> tuple:
        """Hashable fingerprint of the type and every param (nested
        estimators recursively): two instances with equal keys configure
        the same fit.  The tuners key their shared fit contexts and their
        sweep groups on it."""

        def enc(v):
            if isinstance(v, Params):
                return v.config_key()
            if isinstance(v, (list, tuple)):
                return tuple(enc(x) for x in v)
            if isinstance(v, dict):
                return tuple(sorted((k, enc(x)) for k, x in v.items()))
            return v

        return (type(self).__name__,) + tuple(
            (name, enc(getattr(self, name))) for name in self._param_names()
        )

    def params_to_json_dict(self) -> Dict[str, Any]:
        """The JSON params of this instance (``utils/persist.py::
        params_to_json_dict``): estimator-valued params left out, JSON
        containers kept, anything else dropped."""
        from spark_ensemble_tpu_torch.utils.persist import params_to_json_dict

        return params_to_json_dict(self)

    def __repr__(self):
        parts = ", ".join(
            f"{k}={v!r}"
            for k, v in self.get_params().items()
            if not isinstance(v, Params) and v is not None
        )
        return f"{type(self).__name__}({parts})"
