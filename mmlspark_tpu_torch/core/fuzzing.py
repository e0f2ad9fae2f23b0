"""Structural fuzzing harness.

The port's copy of ``mmlspark_tpu/core/fuzzing.py``, cut to what the
port's stages use: every public stage declares *test objects* (an
instance plus fitting and transform data), and from that one declaration
the tests derive a save/load round trip of the stage (and of the fitted
model for estimators, then re-fit / re-transform and compare) and a
fit → transform smoke run.  A meta-check asserts every class of the
port's ``STAGE_REGISTRY`` has a provider, so coverage is enforced
structurally.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from .pipeline import PipelineStage
from .schema import TableLike


@dataclass
class TestObject:
    """One fuzzing scenario: a stage plus the data to exercise it with."""
    stage: PipelineStage
    fitting_data: Optional[TableLike] = None     # estimators
    transform_data: Optional[TableLike] = None   # transformers / fitted models
    #: columns whose values must round-trip exactly through save/load re-runs
    compare_cols: Optional[List[str]] = None
    #: class name the estimator's ``fit`` must produce — lets the meta-test
    #: count Model classes as covered, and the serialization test verify the
    #: declaration (a wrong name fails the assert, so coverage stays honest)
    fitted_model_cls: Optional[str] = None


# class name -> provider returning scenarios
_PROVIDERS: Dict[str, Callable[[], List[TestObject]]] = {}

#: stage class names exempt from fuzzing (abstract shims, external-IO stages
#: that cannot run hermetically).  Every exemption must carry a reason.
EXEMPT: Dict[str, str] = {}


def fuzzing_objects(cls_name: str):
    """Decorator registering a test-object provider for a stage class."""
    def deco(fn: Callable[[], List[TestObject]]):
        _PROVIDERS[cls_name] = fn
        return fn
    return deco


def all_providers() -> Dict[str, Callable[[], List[TestObject]]]:
    return dict(_PROVIDERS)
