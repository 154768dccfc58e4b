"""im2col matmul conv front-end == NCHW lax.conv path.

The shipped conv family (feature axis collapsed in layer 0, 1-D over
time after) is dispatched to window-gather + matmul with C_out as the
output dim; these tests pin numerical equivalence with the general
`lax.conv` path (values, BN running stats, gradients, pooling/leaky
variants) and the eligibility gate.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ast_tpu.ops import cnn
from tests.conftest import TINY_MODEL_CFG


def _setup(cnn_cfg, in_dim=13, seed=0):
    params, state = cnn.init_conv_params(
        jax.random.PRNGKey(seed), cnn_cfg, in_dim)
    rng = np.random.RandomState(seed)
    X = jnp.asarray(rng.randn(3, 40, in_dim), jnp.float32)
    return params, state, X


def _both(cnn_cfg, params, state, X, train):
    forced = dict(cnn_cfg, force_nchw=True)
    fast, s_fast = cnn.conv_frontend(params, state, cnn_cfg, X, train)
    ref, s_ref = cnn.conv_frontend(params, state, forced, X, train)
    return (fast, s_fast), (ref, s_ref)


@pytest.mark.parametrize("train", [False, True])
def test_matmul_conv_matches_nchw(train):
    cfg = TINY_MODEL_CFG["cnn_config"]
    assert cnn._matmul_eligible(cfg, 13)
    params, state, X = _setup(cfg)
    (fast, s_fast), (ref, s_ref) = _both(cfg, params, state, X, train)
    np.testing.assert_allclose(np.asarray(fast), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)
    for a, b in zip(jax.tree.leaves(s_fast), jax.tree.leaves(s_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-6)


def test_matmul_conv_gradients_match():
    cfg = TINY_MODEL_CFG["cnn_config"]
    params, state, X = _setup(cfg)

    def loss(p, c):
        h, _ = cnn.conv_frontend(p, state, c, X, True)
        return jnp.sum(h ** 2)

    g_fast = jax.grad(loss)(params, cfg)
    g_ref = jax.grad(loss)(params, dict(cfg, force_nchw=True))
    for a, b in zip(jax.tree.leaves(g_fast), jax.tree.leaves(g_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-3, atol=1e-3)


def test_matmul_conv_pool_and_leaky():
    cfg = {
        "bn": True,
        "cnn_layers": [
            {"in_channels": None, "out_channels": 8, "ksize": [3, 13],
             "stride": [2, 13], "pad": [1, 0], "leaky_relu": True},
            {"in_channels": None, "out_channels": 16, "ksize": [3, 1],
             "stride": [1, 1], "pad": [1, 0], "max_pool": [2, 2]},
        ],
    }
    assert cnn._matmul_eligible(cfg, 13)
    params, state, X = _setup(cfg)
    (fast, _), (ref, _) = _both(cfg, params, state, X, False)
    np.testing.assert_allclose(np.asarray(fast), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


def test_eligibility_gate():
    # a kernel that does not collapse the feature axis must fall back
    cfg = {
        "bn": True,
        "cnn_layers": [
            {"in_channels": None, "out_channels": 8, "ksize": [3, 3],
             "stride": [2, 2], "pad": [1, 1]},
        ],
    }
    assert not cnn._matmul_eligible(cfg, 13)
    params, state, X = _setup(cfg)
    out, _ = cnn.conv_frontend(params, state, cfg, X, False)
    assert out.shape[0] == 3 and np.isfinite(np.asarray(out)).all()
