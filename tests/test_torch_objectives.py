"""The port's objectives against the JAX reference's: ``init_score`` and
``grad_hess`` exact (the port evaluates the sigmoid in the order of the
reference's XLA CPU exp)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.gbdt.objectives import get_objective as ref_get
from mmlspark_tpu_torch.gbdt.objectives import get_objective

CASES = [("binary", {}),
         ("binary", {"sigmoid": 0.7}),
         ("binary", {"is_unbalance": True}),
         ("binary", {"scale_pos_weight": 3.0}),
         ("regression", {})]


def _data(name, seed=0, n=4000):
    rng = np.random.default_rng(seed)
    scores = (rng.normal(size=n) * 3).astype(np.float32)
    if name == "binary":
        labels = (rng.random(n) < 0.3).astype(np.float64)
    else:
        labels = rng.normal(size=n) * 10 + 2
    weights = rng.uniform(0.5, 2.0, size=n)
    return scores, labels, weights


@pytest.mark.parametrize("name,kw", CASES)
def test_init_score_is_exact(name, kw):
    _, labels, weights = _data(name)
    ref, port = ref_get(name, **kw), get_objective(name, **kw)
    ref.prepare(labels, weights)
    port.prepare(labels, weights)
    assert port.init_score(labels, weights) == \
        ref.init_score(labels, weights)
    assert port.model_str == ref.model_str


@pytest.mark.parametrize("name,kw", CASES)
def test_grad_hess_allclose(name, kw):
    scores, labels, weights = _data(name, seed=1)
    ref, port = ref_get(name, **kw), get_objective(name, **kw)
    ref.prepare(labels, weights)
    port.prepare(labels, weights)
    rg, rh = ref.grad_hess(jnp.asarray(scores),
                           jnp.asarray(labels, jnp.float32),
                           jnp.asarray(weights, jnp.float32))
    pg, ph = port.grad_hess(torch.from_numpy(scores),
                            torch.as_tensor(labels, dtype=torch.float32),
                            torch.as_tensor(weights, dtype=torch.float32))
    assert pg.dtype == torch.float32 and ph.dtype == torch.float32
    np.testing.assert_array_equal(pg.numpy(), np.asarray(rg))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(rh))


def test_sigmoid_matches_xla_bit_for_bit():
    import jax
    from mmlspark_tpu_torch.gbdt.objectives import sigmoid
    rng = np.random.default_rng(2)
    x = np.concatenate([
        (rng.normal(size=50_000) * 8).astype(np.float32),
        np.linspace(-100, 100, 20_001, dtype=np.float32),
        np.array([np.nan, np.inf, -np.inf, 0.0, -0.0], np.float32)])
    np.testing.assert_array_equal(sigmoid(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.jit(jax.nn.sigmoid)(x)))


@pytest.mark.parametrize("name", ["huber", "multiclass", "lambdarank"])
def test_unported_objectives_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_objective(name)
