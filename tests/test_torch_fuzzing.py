"""Structural fuzzing of the port's stages (its copy of
``mmlspark_tpu/core/fuzzing.py``).

Every public stage of the port's ``STAGE_REGISTRY`` has a provider here,
or is the declared fitted model of one; each provider's scenarios go
through a save/load round trip (re-fit and re-transform, compared) and a
fit → transform run, on the CPU at small sizes.  The port's stages are
the reference's stages of the same names.
"""

import importlib
import pkgutil

import numpy as np
import pytest

from mmlspark_tpu.core.pipeline import STAGE_REGISTRY as REF_REGISTRY
import mmlspark_tpu_torch
from mmlspark_tpu_torch.core import fuzzing
from mmlspark_tpu_torch.core.fuzzing import fuzzing_objects
from mmlspark_tpu_torch.core.pipeline import (Estimator, Model,
                                              STAGE_REGISTRY)
from mmlspark_tpu_torch.core.schema import DataTable
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

for _m in pkgutil.walk_packages(mmlspark_tpu_torch.__path__,
                                "mmlspark_tpu_torch."):
    importlib.import_module(_m.name)

SEED = 7
KW = dict(numLeaves=5, minDataInLeaf=5, verbosity=0, device="cpu")


def _binary(n=200, f=6):
    rng = np.random.default_rng(SEED)
    X = rng.normal(size=(n, f))
    return DataTable({"features": X,
                      "label": (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)})


def _regression(n=200, f=5):
    rng = np.random.default_rng(SEED)
    X = rng.normal(size=(n, f))
    return DataTable({"features": X,
                      "label": X[:, 0] * 2 - X[:, 1]
                      + rng.normal(size=n) * 0.1})


def _ranking(queries=12, per=8, f=4):
    rng = np.random.default_rng(SEED)
    X = rng.normal(size=(queries * per, f))
    rel = np.clip((X[:, 0] > 0).astype(float) + (X[:, 1] > 0.5), 0, 2)
    return DataTable({"features": X, "label": rel,
                      "query": np.repeat(np.arange(queries), per)})


@fuzzing_objects("Pipeline")
def _pipeline():
    from mmlspark_tpu_torch.core import Pipeline
    from mmlspark_tpu_torch.gbdt import LightGBMClassifier
    t = _binary()
    return [fuzzing.TestObject(Pipeline(stages=[LightGBMClassifier(
        numIterations=3, **KW)]), fitting_data=t, transform_data=t,
        fitted_model_cls="PipelineModel", compare_cols=["prediction"])]


@fuzzing_objects("LightGBMClassifier")
def _classifier():
    from mmlspark_tpu_torch.gbdt import LightGBMClassifier
    t = _binary()
    return [fuzzing.TestObject(LightGBMClassifier(numIterations=4, **KW),
                       fitting_data=t, transform_data=t,
                       fitted_model_cls="LightGBMClassificationModel",
                       compare_cols=["prediction", "probability"])]


@fuzzing_objects("LightGBMRegressor")
def _regressor():
    from mmlspark_tpu_torch.gbdt import LightGBMRegressor
    t = _regression()
    return [fuzzing.TestObject(LightGBMRegressor(numIterations=4, **KW),
                       fitting_data=t, transform_data=t,
                       fitted_model_cls="LightGBMRegressionModel",
                       compare_cols=["prediction"])]


@fuzzing_objects("LightGBMRanker")
def _ranker():
    from mmlspark_tpu_torch.gbdt import LightGBMRanker
    t = _ranking()
    return [fuzzing.TestObject(LightGBMRanker(numIterations=3, groupCol="query",
                                      **{**KW, "minDataInLeaf": 3}),
                       fitting_data=t, transform_data=t,
                       fitted_model_cls="LightGBMRankerModel",
                       compare_cols=["prediction"])]


PROVIDERS = fuzzing.all_providers()


def _port_registry():
    return {k: v for k, v in STAGE_REGISTRY.items()
            if v.__module__.startswith("mmlspark_tpu_torch.")}


def _declared_models():
    return {to.fitted_model_cls for p in PROVIDERS.values() for to in p()
            if to.fitted_model_cls}


def test_meta_every_port_stage_is_covered():
    declared = _declared_models()
    missing = [name for name, cls in sorted(_port_registry().items())
               if name not in PROVIDERS and name not in fuzzing.EXEMPT
               and not (issubclass(cls, Model) and name in declared)]
    assert not missing
    assert declared <= set(_port_registry())
    # the port's stages are the reference's stages of the same names
    assert set(_port_registry()) <= set(REF_REGISTRY)


def _assert_tables_match(a, b, cols):
    for c in cols:
        va, vb = np.asarray(a[c]), np.asarray(b[c])
        assert va.shape == vb.shape and np.array_equal(va, vb), c


@pytest.mark.parametrize("name", sorted(PROVIDERS))
def test_serialization_fuzzing(name, tmp_path):
    for i, to in enumerate(PROVIDERS[name]()):
        stage = to.stage
        p = str(tmp_path / f"{name}_{i}")
        stage.save(p)
        loaded = type(stage).load(p)
        assert type(loaded) is type(stage)
        assert dict(loaded._iterSetParams()) == dict(stage._iterSetParams())
        assert isinstance(stage, Estimator)
        model = stage.fit(to.fitting_data)
        assert type(model).__name__ == to.fitted_model_cls
        out = model.transform(to.transform_data)
        _assert_tables_match(
            out, loaded.fit(to.fitting_data).transform(to.transform_data),
            to.compare_cols)
        mp = str(tmp_path / f"{name}_{i}_model")
        model.save(mp)
        _assert_tables_match(
            out, type(model).load(mp).transform(to.transform_data),
            to.compare_cols)


@pytest.mark.parametrize("name", sorted(PROVIDERS))
def test_experiment_fuzzing(name):
    for to in PROVIDERS[name]():
        out = to.stage.fit(to.fitting_data).transform(to.transform_data)
        assert out is not None and len(out.columns) >= 1
