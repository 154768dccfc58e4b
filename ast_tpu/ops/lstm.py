"""LSTM cell primitives for scan-based recurrence.

Scan-based formulation of the reference's per-timestep Chainer LSTM calls
(reference: seq2seq.py:192-203 drives 6 cuDNN LSTM kernels per Python loop
iteration): here a cell is a pair of packed matmuls — the input projection
``x @ wx`` is hoisted *outside* the time scan wherever the full input
sequence is known in advance, leaving only the small recurrent
``h @ wh`` matmul on the scan's critical path.

Gate packing order: [i, f, g, o] along the last axis of ``wx``/``wh``/``b``.
Forget-gate bias initialized to 1 (Chainer's L.LSTM default forget bias).
"""

import jax
import jax.numpy as jnp


def init_lstm_params(key, in_dim, hidden, dtype=jnp.float32):
    """Packed LSTM parameters: wx (in,4H), wh (H,4H), b (4H,)."""
    k1, k2 = jax.random.split(key)
    wx = jax.nn.initializers.glorot_uniform()(k1, (in_dim, 4 * hidden), dtype)
    wh = jax.nn.initializers.orthogonal()(k2, (hidden, 4 * hidden), dtype)
    b = jnp.zeros((4 * hidden,), dtype)
    # forget gate bias = 1
    b = b.at[hidden : 2 * hidden].set(1.0)
    return {"wx": wx, "wh": wh, "b": b}


def lstm_gates(z, c, hidden):
    """Apply gate nonlinearities to packed preactivations ``z`` (..., 4H)."""
    i = jax.nn.sigmoid(z[..., :hidden])
    f = jax.nn.sigmoid(z[..., hidden : 2 * hidden])
    g = jnp.tanh(z[..., 2 * hidden : 3 * hidden])
    o = jax.nn.sigmoid(z[..., 3 * hidden :])
    c_new = f * c + i * g
    h_new = o * jnp.tanh(c_new)
    return h_new, c_new


def lstm_step(params, h, c, x, x_proj=None):
    """One LSTM step.  If ``x_proj`` (= x @ wx, precomputed) is given, ``x``
    is ignored and only the recurrent matmul runs."""
    hidden = params["wh"].shape[0]
    if x_proj is None:
        x_proj = x @ params["wx"]
    z = x_proj + h @ params["wh"] + params["b"]
    return lstm_gates(z, c, hidden)


def dropout(key, x, rate, train):
    """Inverted dropout matching F.dropout semantics (scale at train time)."""
    if not train or rate <= 0:
        return x
    keep = 1.0 - rate
    mask = jax.random.bernoulli(key, keep, x.shape)
    return jnp.where(mask, x / keep, 0.0).astype(x.dtype)
