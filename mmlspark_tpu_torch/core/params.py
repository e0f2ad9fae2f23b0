"""Parameter system for pipeline stages.

A copy of ``mmlspark_tpu/core/params.py``: the port keeps its own so that
it never imports the JAX package.

Re-design of the reference's Spark ML ``Params`` layer
(reference: src/main/scala/com/microsoft/ml/spark/core/contracts/Params.scala,
expected path, UNVERIFIED — see SURVEY.md provenance warning).  The reference
attaches typed ``Param`` objects to every Estimator/Transformer so that every
knob has a name, a doc string, a default, validation, and automatic surfacing
into the Python/R APIs via codegen.  Here there is no JVM to bridge, so the
same contract is met with plain Python descriptors: declaring a ``Param`` on a
class body auto-generates ``getX``/``setX`` methods (mirroring the mmlspark
public API so existing notebooks port over), participates in persistence, and
is introspectable for the fuzzing test harness (SURVEY.md §4).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Iterator, Optional, Tuple


class _NoDefault:
    """Sentinel: param has no default; getting it while unset raises."""
    def __repr__(self):
        return "<undefined>"


NO_DEFAULT = _NoDefault()


class Param:
    """A typed, documented parameter attached to a :class:`Params` subclass.

    Unlike the JVM original there is no separate ``ParamMap``; values live in
    ``instance._paramMap`` and defaults in the class-level descriptor.
    A param declared without a default is *required*: reading it while unset
    raises (mirroring Spark ML's ``NoSuchElementException``).  Optional params
    declare ``default=None`` explicitly.
    """

    __slots__ = ("name", "doc", "default", "typeConverter", "validator")

    def __init__(
        self,
        name: str,
        doc: str = "",
        default: Any = NO_DEFAULT,
        typeConverter: Optional[Callable[[Any], Any]] = None,
        validator: Optional[Callable[[Any], bool]] = None,
    ):
        self.name = name
        self.doc = doc
        self.default = default
        self.typeConverter = typeConverter
        self.validator = validator

    @property
    def hasDefault(self) -> bool:
        return not isinstance(self.default, _NoDefault)

    def convert(self, value: Any) -> Any:
        if self.typeConverter is not None and value is not None:
            value = self.typeConverter(value)
        if self.validator is not None and value is not None:
            if not self.validator(value):
                raise ValueError(
                    f"Invalid value {value!r} for param {self.name!r}"
                )
        return value

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Param({self.name!r}, default={self.default!r})"


# -- common type converters (analog of Spark's TypeConverters) ---------------

class TypeConverters:
    @staticmethod
    def toInt(v: Any) -> int:
        if isinstance(v, bool):
            raise TypeError(f"Expected int, got bool {v!r}")
        return int(v)

    @staticmethod
    def toFloat(v: Any) -> float:
        return float(v)

    @staticmethod
    def toBool(v: Any) -> bool:
        if isinstance(v, bool):
            return v
        raise TypeError(f"Expected bool, got {v!r}")

    @staticmethod
    def toString(v: Any) -> str:
        return str(v)

    @staticmethod
    def toList(v: Any) -> list:
        return list(v)

    @staticmethod
    def toListString(v: Any) -> list:
        return [str(x) for x in v]

    @staticmethod
    def toListInt(v: Any) -> list:
        return [int(x) for x in v]

    @staticmethod
    def toListFloat(v: Any) -> list:
        return [float(x) for x in v]


def _capitalize(name: str) -> str:
    return name[0].upper() + name[1:] if name else name


class Params:
    """Base class providing param declaration, get/set, copy and explain.

    Subclasses declare params as class attributes::

        class MyStage(Params):
            inputCol = Param("inputCol", "The input column", default="input")

    which auto-generates ``self.getInputCol()`` / ``self.setInputCol(v)``
    (matching the reference's public stage API) and records the param for
    persistence and the structural fuzzing tests.
    """

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        # Merge the param registry once at class-definition time (bases are
        # already built, so their caches are complete).
        merged: Dict[str, Param] = {}
        for base in reversed(cls.__mro__[1:]):
            merged.update(getattr(base, "_params_cache", {}))
        # Collect params declared directly on this class and generate
        # accessor methods once, at class-definition time.
        for attr, p in list(vars(cls).items()):
            if not isinstance(p, Param):
                continue
            if p.name != attr:
                raise ValueError(
                    f"Param attribute {attr!r} must match Param.name {p.name!r}"
                )
            merged[attr] = p
            cap = _capitalize(attr)
            getter_name, setter_name = f"get{cap}", f"set{cap}"
            if getter_name not in vars(cls):
                def getter(self, _name=attr):
                    return self.getOrDefault(_name)
                getter.__name__ = getter_name
                getter.__doc__ = f"Gets the value of {attr}: {p.doc}"
                setattr(cls, getter_name, getter)
            if setter_name not in vars(cls):
                def setter(self, value, _name=attr):
                    return self.set(_name, value)
                setter.__name__ = setter_name
                setter.__doc__ = f"Sets the value of {attr}: {p.doc}"
                setattr(cls, setter_name, setter)
        cls._params_cache = merged

    def __init__(self, **kwargs):
        self._paramMap: Dict[str, Any] = {}
        self.setParams(**kwargs)

    # -- param registry ------------------------------------------------------

    _params_cache: Dict[str, Param] = {}

    @classmethod
    def params(cls) -> Dict[str, Param]:
        """All params declared on this class and its bases."""
        return dict(cls._params_cache)

    def hasParam(self, name: str) -> bool:
        return name in type(self)._params_cache

    def _param(self, name: str) -> Param:
        try:
            return type(self)._params_cache[name]
        except KeyError:
            raise AttributeError(
                f"{type(self).__name__} has no param {name!r}"
            ) from None

    # -- get/set -------------------------------------------------------------

    def set(self, name: str, value: Any) -> "Params":
        p = self._param(name)
        self._paramMap[name] = p.convert(value)
        return self

    def setParams(self, **kwargs) -> "Params":
        for k, v in kwargs.items():
            self.set(k, v)
        return self

    def isSet(self, name: str) -> bool:
        self._param(name)
        return name in self._paramMap

    def getOrDefault(self, name: str) -> Any:
        p = self._param(name)
        if name in self._paramMap:
            return self._paramMap[name]
        if not p.hasDefault:
            raise KeyError(
                f"Param {name!r} is not set on {type(self).__name__} and has "
                f"no default; call set{_capitalize(name)}(...) first")
        return p.default

    def _peek(self, name: str, fallback: Any = None) -> Any:
        """Non-raising read: set value, else default, else ``fallback``."""
        p = self._param(name)
        if name in self._paramMap:
            return self._paramMap[name]
        return p.default if p.hasDefault else fallback

    def clear(self, name: str) -> "Params":
        self._paramMap.pop(name, None)
        return self

    def extractParamMap(self) -> Dict[str, Any]:
        """Effective values of every defined param (set values over defaults)."""
        out = {}
        for name, p in type(self)._params_cache.items():
            if name in self._paramMap:
                out[name] = self._paramMap[name]
            elif p.hasDefault:
                out[name] = p.default
        return out

    def explainParams(self) -> str:
        lines = []
        for name, p in sorted(type(self)._params_cache.items()):
            cur = self._peek(name, fallback="<unset>")
            lines.append(f"{name}: {p.doc} (default: {p.default!r}, current: {cur!r})")
        return "\n".join(lines)

    def copy(self, extra: Optional[Dict[str, Any]] = None) -> "Params":
        new = copy.copy(self)
        new._paramMap = dict(self._paramMap)
        if extra:
            for k, v in extra.items():
                new.set(k, v)
        return new

    def _iterSetParams(self) -> Iterator[Tuple[str, Any]]:
        for k in type(self).params():
            if k in self._paramMap:
                yield k, self._paramMap[k]

    def __repr__(self) -> str:
        set_params = ", ".join(f"{k}={v!r}" for k, v in self._iterSetParams())
        return f"{type(self).__name__}({set_params})"


# -- shared param mix-ins (HasInputCol-style traits of the reference) --------

class HasInputCol(Params):
    inputCol = Param("inputCol", "The name of the input column",
                     typeConverter=TypeConverters.toString)


class HasOutputCol(Params):
    outputCol = Param("outputCol", "The name of the output column",
                      typeConverter=TypeConverters.toString)


class HasInputCols(Params):
    inputCols = Param("inputCols", "The names of the input columns",
                      typeConverter=TypeConverters.toListString)


class HasOutputCols(Params):
    outputCols = Param("outputCols", "The names of the output columns",
                       typeConverter=TypeConverters.toListString)


class HasFeaturesCol(Params):
    featuresCol = Param("featuresCol", "The name of the features column",
                        default="features", typeConverter=TypeConverters.toString)


class HasLabelCol(Params):
    labelCol = Param("labelCol", "The name of the label column",
                     default="label", typeConverter=TypeConverters.toString)


class HasPredictionCol(Params):
    predictionCol = Param("predictionCol", "The name of the prediction column",
                          default="prediction", typeConverter=TypeConverters.toString)


class HasProbabilityCol(Params):
    probabilityCol = Param("probabilityCol",
                           "The name of the predicted probability column",
                           default="probability",
                           typeConverter=TypeConverters.toString)


class HasRawPredictionCol(Params):
    rawPredictionCol = Param("rawPredictionCol",
                             "The name of the raw prediction (margin) column",
                             default="rawPrediction",
                             typeConverter=TypeConverters.toString)


class HasWeightCol(Params):
    weightCol = Param("weightCol",
                      "The name of the sample weight column (optional)",
                      default=None, typeConverter=TypeConverters.toString)


class HasValidationIndicatorCol(Params):
    validationIndicatorCol = Param(
        "validationIndicatorCol",
        "Column with a boolean marking rows used for validation/early stopping "
        "(optional)",
        default=None, typeConverter=TypeConverters.toString)


class HasSeed(Params):
    seed = Param("seed", "Random seed", default=42,
                 typeConverter=TypeConverters.toInt)
