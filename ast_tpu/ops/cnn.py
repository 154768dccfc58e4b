"""Convolutional front-end: Conv2D(no-bias) -> BatchNorm -> ReLU stack.

Equivalent capability to the reference's CNN layer list (reference:
seq2seq.py:35-60 init, :158-180 forward): NCHW layout where H is time and
W is the feature axis; the shipped config's first layer collapses the
13-dim MFCC axis (stride 13) and each layer halves time, for a net 4x time
downsampling.  Implemented as im2col matmuls for the shipped config family
and with ``lax.conv_general_dilated`` otherwise; BatchNorm keeps running statistics in a separate (non-trained)
state pytree.  Legacy extras carried as config options: per-layer max
pooling and leaky-relu (reference: enc_dec.py:444-468).
"""

import jax
import jax.numpy as jnp
from jax import lax

BN_DECAY = 0.9
BN_EPS = 2e-5


def init_conv_params(key, cnn_config, in_dim):
    """Initialize conv + BN parameters and BN running-stat state.

    Returns (params_list, state_list).  Conv weights are He-normal
    (reference: seq2seq.py:45), OIHW layout.
    """
    params, state = [], []
    in_ch = 1
    for i, layer in enumerate(cnn_config["cnn_layers"]):
        key, sub = jax.random.split(key)
        out_ch = layer["out_channels"]
        kh, kw = layer["ksize"]
        w = jax.nn.initializers.he_normal()(sub, (out_ch, in_ch, kh, kw))
        p = {"w": w}
        s = {}
        if cnn_config.get("bn", True):
            p["bn_gamma"] = jnp.ones((out_ch,))
            p["bn_beta"] = jnp.zeros((out_ch,))
            s["bn_mean"] = jnp.zeros((out_ch,))
            s["bn_var"] = jnp.ones((out_ch,))
        else:
            p["b"] = jnp.zeros((out_ch,))
        params.append(p)
        state.append(s)
        in_ch = out_ch
    return params, state


def _batchnorm(p, s, h, train):
    """BN over NCHW with running stats (decay 0.9, eps 2e-5 as Chainer)."""
    if train:
        mean = jnp.mean(h, axis=(0, 2, 3))
        var = jnp.var(h, axis=(0, 2, 3))
        new_s = {
            "bn_mean": BN_DECAY * s["bn_mean"] + (1 - BN_DECAY) * mean,
            "bn_var": BN_DECAY * s["bn_var"] + (1 - BN_DECAY) * var,
        }
    else:
        mean, var = s["bn_mean"], s["bn_var"]
        new_s = s
    inv = lax.rsqrt(var + BN_EPS)
    h = (h - mean[None, :, None, None]) * inv[None, :, None, None]
    h = h * p["bn_gamma"][None, :, None, None] + p["bn_beta"][None, :, None, None]
    return h, new_s


def _matmul_eligible(cnn_config, in_dim):
    """The shipped conv-stack family — layer 0 collapses the feature axis
    (kw == sw == in_dim, pw == 0) and later layers are 1-D over time —
    can be evaluated as im2col matmuls."""
    layers = cnn_config["cnn_layers"]
    if not layers:
        return False
    l0 = layers[0]
    if (l0["ksize"][1] != in_dim or l0["stride"][1] != in_dim
            or l0["pad"][1] != 0 or l0.get("dilate", 1) != 1):
        return False
    for l in layers[1:]:
        if (l["ksize"][1] != 1 or l["stride"][1] != 1 or l["pad"][1] != 0
                or l.get("dilate", 1) != 1):
            return False
    return True


def _bn_channels_last(p, s, h, train):
    """BN over (B, T) per channel on a (B, T, C) tensor — same statistics
    as `_batchnorm` over NCHW axes (0, 2, 3)."""
    if train:
        mean = jnp.mean(h, axis=(0, 1))
        var = jnp.var(h, axis=(0, 1))
        new_s = {
            "bn_mean": BN_DECAY * s["bn_mean"] + (1 - BN_DECAY) * mean,
            "bn_var": BN_DECAY * s["bn_var"] + (1 - BN_DECAY) * var,
        }
    else:
        mean, var = s["bn_mean"], s["bn_var"]
        new_s = s
    h = (h - mean) * lax.rsqrt(var + BN_EPS)
    return h * p["bn_gamma"] + p["bn_beta"], new_s


def _conv_frontend_matmul(params, state, cnn_config, X, train,
                          compute_dtype):
    """im2col formulation of the conv stack: each layer is one window
    gather + one big (B*T', kh*C_in) @ (kh*C_in, C_out) matmul.

    The NCHW `lax.conv` path keeps the collapsed feature axis (13 -> 1)
    as a spatial dimension of width 1; as matmuls the output dims are
    C_out (128/512).  Windows are built from kh strided SLICES
    concatenated on the feature axis rather than a time-gather.
    Weights stay in the OIHW layout of the checkpoint format; matmuls
    run in ``compute_dtype`` with f32 accumulation, BN/ReLU in f32.
    Its speed against the NCHW path on the GPU is not measured."""
    cd = compute_dtype
    h = X  # (B, T, D)
    new_state = []
    for i, (p, s, layer) in enumerate(zip(params, state,
                                          cnn_config["cnn_layers"])):
        kh = layer["ksize"][0]
        sh = layer["stride"][0]
        ph = layer["pad"][0]
        B, T, D = h.shape
        if ph:
            h = jnp.pad(h, ((0, 0), (ph, ph), (0, 0)))
        T_out = (T + 2 * ph - kh) // sh + 1
        win = jnp.concatenate(
            [lax.slice_in_dim(h, k, k + sh * (T_out - 1) + 1, sh, axis=1)
             for k in range(kh)],
            axis=-1)                          # (B, T_out, kh*C_in)
        w = p["w"]                            # (C_out, C_in, kh, kw)
        if i == 0:
            # layer 0: kw == D, C_in == 1; window flatten order (kh, D)
            w2 = jnp.transpose(w[:, 0], (1, 2, 0)).reshape(-1, w.shape[0])
        else:
            # kw == 1; window flatten order (kh, C_in)
            w2 = jnp.transpose(w[..., 0], (2, 1, 0)).reshape(-1, w.shape[0])
        out = jnp.einsum("btk,kc->btc", win.astype(cd), w2.astype(cd),
                         preferred_element_type=jnp.float32)
        if "bn_gamma" in p:
            out, s = _bn_channels_last(p, s, out, train)
        else:
            out = out + p["b"]
        if layer.get("leaky_relu", False):
            out = jax.nn.leaky_relu(out)
        else:
            out = jax.nn.relu(out)
        if layer.get("max_pool", None):
            pk, pstr = layer["max_pool"]
            out = lax.reduce_window(
                out, -jnp.inf, lax.max,
                (1, pk, 1), (1, pstr, 1), "SAME")
        new_state.append(s)
        h = out
    return h, new_state


def conv_frontend(params, state, cnn_config, X, train,
                  compute_dtype=jnp.float32):
    """Apply the conv stack.  X: (B, T, D) -> (B, T', C_out), new_state.

    Dispatches to the im2col matmul formulation for the shipped config
    family (see `_conv_frontend_matmul`); the general `lax.conv` NCHW
    path handles everything else, in float32
    (XLA's transpose-conv gradient rejects mixed bf16/f32 operands)."""
    if _matmul_eligible(cnn_config, X.shape[-1]) \
            and not cnn_config.get("force_nchw", False):
        return _conv_frontend_matmul(params, state, cnn_config, X, train,
                                     compute_dtype)
    del compute_dtype
    h = X[:, None, :, :]  # NCHW: (B, 1, T, D)
    new_state = []
    for i, (p, s, layer) in enumerate(zip(params, state,
                                          cnn_config["cnn_layers"])):
        sh, sw = layer["stride"]
        ph, pw = layer["pad"]
        dil = layer.get("dilate", 1)
        h = lax.conv_general_dilated(
            h,
            p["w"],
            window_strides=(sh, sw),
            padding=((ph, ph), (pw, pw)),
            rhs_dilation=(dil, dil),
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            preferred_element_type=jnp.float32,
        )
        if "bn_gamma" in p:
            h, s = _batchnorm(p, s, h, train)
        else:
            h = h + p["b"][None, :, None, None]
        if layer.get("leaky_relu", False):
            h = jax.nn.leaky_relu(h)
        else:
            h = jax.nn.relu(h)
        if layer.get("max_pool", None):
            pk, pstr = layer["max_pool"]
            h = lax.reduce_window(
                h, -jnp.inf, lax.max,
                (1, 1, pk, 1), (1, 1, pstr, 1), "SAME",
            )
        new_state.append(s)
    # (B, C, T', W') -> (B, T', C*W'); shipped configs collapse W' to 1
    B, C, Tp, Wp = h.shape
    h = jnp.transpose(h, (0, 2, 1, 3)).reshape(B, Tp, C * Wp)
    return h, new_state


def conv_out_len(cnn_config, t):
    """Output time length for input length ``t`` under the conv stack."""
    for layer in cnn_config["cnn_layers"]:
        # dilation widens the effective kernel: (kh-1)*dil + 1 — the
        # length arithmetic must match conv_general_dilated's
        # rhs_dilation or masks/bucket shapes drift past true content
        kh = (layer["ksize"][0] - 1) * layer.get("dilate", 1) + 1
        sh = layer["stride"][0]
        ph = layer["pad"][0]
        t = (t + 2 * ph - kh) // sh + 1
        if layer.get("max_pool", None):
            pk, pstr = layer["max_pool"]
            t = -(-t // pstr)
    return t
