"""In-graph SpecAugment: time/frequency masking inside the jitted step.

SpecAugment (Park et al. 2019, arXiv:1904.08779) masks random
contiguous frequency bands and time spans of the input spectrogram —
the standard regularizer for low-resource speech models of exactly this
family.  The reference's only input augmentation is host-side random
frame zeroing (reference: nmt_run.py:478-487 → ``data.zero_input``,
kept as-is in the dataloader); this module is the beyond-reference,
on-device counterpart: masks are sampled and applied *inside* the
jitted train step from the same per-batch key stream as every other
stochastic train op, so augmentation costs zero host time, adds no
host→device traffic, and is bit-reproducible under resume/multi-step
dispatch/mesh sharding (the step key is derived in-graph from
(epoch_key, batch index); see trainer._make_train_step).

All mask geometry is computed with static shapes: per-row widths/starts
are sampled as (B, 1) integers and turned into masks by iota
comparisons, so XLA fuses the whole augmentation into a handful of
elementwise ops on the (B, T, D) block — no gather, no dynamic slicing, no
per-mask loop on device (the loop over ``*_masks`` is a static Python
unroll).

Config (``train_cfg["data"]["spec_augment"]``), all fields optional::

    {"freq_masks": 2, "freq_width": 6,
     "time_masks": 2, "time_width": 40, "time_p": 0.0}

Each of ``freq_masks`` masks zeroes a band of width ~ U{0..freq_width}
mel/cepstral channels; each of ``time_masks`` masks zeroes a span of
width ~ U{0..time_width} frames, placed uniformly within the row's
*real* (unpadded) frame length so padding does not dilute the
augmentation.  ``time_p`` > 0 additionally caps each time-mask width at
``floor(time_p * length)`` per row (the adaptive rule from the paper's
large-dataset follow-up).  Masked cells are set to 0.0 — the mean of
CMVN-normalized features, and the same value ``zero_input`` writes.
"""

import jax
import jax.numpy as jnp


def frame_lengths(X):
    """Per-row real frame count inferred from the data: last frame with
    any nonzero coefficient, + 1.

    Fallback only — the trainer passes the loader's TRUE per-row frame
    counts into :func:`spec_augment` (batch["frame_len"]), which is
    exact even when ``data.zero_input`` dropout zeroes a row's final
    real frame and in wav mode (where CMVN'd silence is nonzero and
    this heuristic would resolve to ~T).  Kept for direct callers that
    only have the padded block.
    """
    valid = jnp.any(X != 0, axis=-1)  # (B, T)
    T = X.shape[1]
    last = T - jnp.argmax(valid[:, ::-1], axis=1)
    return jnp.where(jnp.any(valid, axis=1), last, 0).astype(jnp.int32)


def _axis_keep_mask(key, B, size, max_width, span, width_cap=None):
    """One random contiguous zero-span per row along an axis.

    width ~ U{0..max_width}, clipped to ``width_cap`` (per-row (B, 1)
    int, optional) and to ``span``; start ~ U{0..span-width} where
    ``span`` is the per-row valid extent ((B, 1) int or a static int).
    Returns a bool (B, size) KEEP mask.  span=0 rows keep everything.
    """
    kw, ks = jax.random.split(key)
    span = jnp.broadcast_to(jnp.asarray(span, jnp.int32), (B, 1)) \
        if jnp.ndim(span) == 0 else jnp.asarray(span, jnp.int32)
    w = jax.random.randint(kw, (B, 1), 0, max_width + 1)
    if width_cap is not None:
        w = jnp.minimum(w, width_cap)
    w = jnp.minimum(w, span)
    # start ~ U{0..span-w}: floor(u * (span - w + 1)) keeps the bound
    # per-row without rejection sampling (u < 1 strictly)
    u = jax.random.uniform(ks, (B, 1))
    start = jnp.floor(u * (span - w + 1).astype(jnp.float32))
    start = start.astype(jnp.int32)
    i = jnp.arange(size, dtype=jnp.int32)[None, :]
    return ~((i >= start) & (i < start + w))


def spec_augment(key, X, cfg, lengths=None):
    """Apply SpecAugment masks to a padded feature batch.

    X: (B, T, D) float features (post-CMVN); cfg: see module docstring;
    ``lengths`` (optional, (B,) int): the TRUE per-row real frame
    counts from the dataloader — time masks are placed within them.
    When absent, falls back to :func:`frame_lengths` inference.
    Returns X with masked cells zeroed.  With all mask counts 0 this is
    the identity (and the caller gates on the config statically, so the
    default path never traces it at all).
    """
    B, T, D = X.shape
    n_f = int(cfg.get("freq_masks", 2))
    f_w = int(cfg.get("freq_width", 6))
    n_t = int(cfg.get("time_masks", 2))
    t_w = int(cfg.get("time_width", 40))
    t_p = float(cfg.get("time_p", 0.0))

    keep_f = jnp.ones((B, D), bool)
    keep_t = jnp.ones((B, T), bool)
    if n_t > 0 and t_w > 0:
        if lengths is None:
            lengths = frame_lengths(X)[:, None]  # (B, 1)
        else:
            lengths = jnp.asarray(lengths, jnp.int32).reshape(B, 1)
    else:
        lengths = None

    keys = jax.random.split(key, n_f + n_t)
    for m in range(n_f):
        if f_w > 0:
            keep_f &= _axis_keep_mask(keys[m], B, D, f_w, D)
    for m in range(n_t):
        if t_w > 0:
            cap = None
            if t_p > 0:
                cap = (t_p * lengths.astype(jnp.float32)).astype(jnp.int32)
            keep_t &= _axis_keep_mask(keys[n_f + m], B, T, t_w, lengths,
                                      width_cap=cap)

    keep = keep_t[:, :, None] & keep_f[:, None, :]
    return X * keep.astype(X.dtype)
