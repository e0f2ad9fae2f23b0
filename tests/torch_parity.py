"""Shared fits of the port and the JAX reference on the same seeded inputs,
for the parity tests of validation, GOSS and quantized training.

:func:`fit_pair` bins the training rows with each package's mapper, runs
each package's ``engine.train`` (both on ``histogram_method="segment"``
unless asked otherwise) serially or on a
``data × feature`` mesh of CPU devices (the reference's over the forced
8-device host platform of ``tests/conftest.py``), with an optional
validation set scored by each package's own estimator metric, and returns
both boosters.

:func:`reference_native` waits until the reference's native kernels load
(it builds them at first use, and a worker that reads a library another
worker is still writing caches the failure).

:func:`one_torch_thread` runs a module's tests with one torch thread: the
port's CPU fits are chains of small torch operations, and with several
test workers on the machine's cores each operation that torch splits over
its threads waits for threads the other workers keep busy.
"""

import time

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.mesh import build_mesh as ref_build_mesh
from mmlspark_tpu.gbdt import LightGBMClassifier as RefClassifier
from mmlspark_tpu.gbdt import LightGBMRegressor as RefRegressor
from mmlspark_tpu.gbdt import fit_bin_mapper as ref_fit
from mmlspark_tpu.gbdt.engine import TrainParams as RefParams
from mmlspark_tpu.gbdt.engine import train as ref_train
from mmlspark_tpu.gbdt.objectives import get_objective as ref_objective
from mmlspark_tpu_torch import LightGBMClassifier, LightGBMRegressor
from mmlspark_tpu_torch.core.mesh import build_mesh
from mmlspark_tpu_torch.gbdt import fit_bin_mapper, get_objective
from mmlspark_tpu_torch.gbdt.engine import TrainParams, train

K = 3
#: the learners of a parity grid: (data shards, feature slices, params)
LEARNERS = {
    "serial": (1, 1, {}),
    "data_psum_2": (2, 1, dict(collective="psum")),
    "data_ring_2": (2, 1, dict(collective="ring")),
    "data_psum_4": (4, 1, dict(collective="psum")),
    "data_ring_4": (4, 1, dict(collective="ring")),
    "voting_ring_4": (4, 1, dict(collective="ring", parallelism="voting",
                                 top_k=2)),
    "feature_1x2": (1, 2, dict(parallelism="feature")),
    "data_feature_2x2": (2, 2, dict(parallelism="data+feature")),
}


def data(objective, n=1200, f=6, seed=3, categorical=False):
    """``(X, y)``: f normal features (the last two category ids of 5 and
    24 categories when ``categorical``) and a noisy label — binary for
    ``binary``, K classes for the multiclass objectives, real for
    ``regression``."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    s = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + rng.normal(size=n)
    if categorical:
        X[:, -2] = rng.integers(0, 5, size=n)
        X[:, -1] = rng.integers(0, 24, size=n)
        s = s + np.isin(X[:, -1], (1, 4, 9, 16, 17, 20)) * 1.5
    if objective == "regression":
        return X, s
    if objective == "binary":
        return X, (s > 0).astype(np.float64)
    t = np.stack([s, X[:, 3] - X[:, 4], 0.5 * X[:, 2] + 0.3], 1) \
        + rng.normal(size=(n, K)) * 0.6
    return X, t.argmax(1).astype(np.float64)


def _metrics(objective):
    if objective == "regression":
        return RefRegressor()._val_metric(), LightGBMRegressor()._val_metric()
    ref, port = (cls(objective=objective) for cls in (RefClassifier,
                                                      LightGBMClassifier))
    ref._resolved_objective = port._resolved_objective = objective
    return ref._val_metric(), port._val_metric()


def fit_pair(X, y, objective, d=1, feature=1, val=None, categorical=(),
             method="segment", max_bin=63, **kw):
    """The reference's and the port's boosters of one fit: training rows
    ``~val`` (all when ``val`` is None), validation rows ``val``; bins of
    at most ``max_bin`` values."""
    train_rows = np.ones(len(y), bool) if val is None else ~val
    Xt, yt = X[train_rows], y[train_rows]
    cats = list(categorical) or None
    num_class = K if objective.startswith("multiclass") else 1
    params = dict(max_bin=max_bin, verbosity=0, **kw)
    ref_metric, port_metric = _metrics(objective)
    rmap = ref_fit(Xt, max_bin=max_bin, categorical_features=cats)
    pmap = fit_bin_mapper(Xt, max_bin=max_bin, categorical_features=cats)
    rval, pval = {}, {}
    if val is not None:
        rval = dict(val_bins=rmap.transform_packed(X[val]),
                    val_labels=y[val], val_metric=ref_metric)
        pval = dict(val_bins=pmap.transform(X[val], "cpu"),
                    val_labels=y[val], val_metric=port_metric)
    rmesh = pmesh = None
    if d * feature > 1:
        rmesh = ref_build_mesh(data=d, feature=feature,
                               devices=jax.devices()[:d * feature])
        pmesh = build_mesh(d, feature, devices=["cpu"] * (d * feature))
    ref = ref_train(rmap.transform_packed(Xt), yt, None, rmap,
                    ref_objective(objective, num_class=num_class),
                    RefParams(histogram_method=method, **params),
                    mesh=rmesh, **rval)
    port = train(pmap.transform(Xt, "cpu"), yt, None, pmap,
                 get_objective(objective, num_class=num_class),
                 TrainParams(histogram_method=method, **params),
                 device="cpu", mesh=pmesh, **pval)
    return ref, port


@pytest.fixture(scope="module")
def one_torch_thread():
    """One torch thread for the module's tests, the previous count
    restored after them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def reference_native():
    """The reference's native binning, forest scorer and FFI histogram
    kernels, loaded: where a load failed (its library was being written by
    another test worker), the failure is forgotten and the load retried,
    for up to a minute."""
    from mmlspark_tpu import native as ref_native
    from mmlspark_tpu.ops import histogram as ref_hist
    for _ in range(60):
        if (ref_native.bin_columns_available()
                and ref_native.predict_forest_available()
                and ref_hist._native_available()):
            return
        for stem in ("_fastbin", "_fastforest"):
            if ref_native._mods.get(stem, 0) is None:
                del ref_native._mods[stem]
        if ref_native._FFI_LIB is False:
            ref_native._FFI_LIB = None
        if ref_hist._NATIVE_OK is False:
            ref_hist._NATIVE_OK = None
        time.sleep(1)
    raise RuntimeError("the reference's native kernels did not load")
