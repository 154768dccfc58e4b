"""Portable inference artifacts via ``jax.export`` (StableHLO).

The reference has no deployment story — decoding happens inside the
research CLI with the full framework loaded (reference: beam.py:45-147,
nn.py:202-233).  For serving, ast_tpu exports the decode functions as
self-contained StableHLO artifacts: trained weights baked in as
constants, one artifact per (batch, frames) shape (static shapes are
the same contract the training buckets use).  An artifact
deserializes and runs from any JAX process — no model code, no config,
no checkpoint loading — and is lowered for several platforms at export
time (by default the CPU and CUDA GPUs).  The decode paths are plain XLA
(``lax.scan`` / ``lax.while_loop``), so the artifact carries no custom
calls.  Writing and reading the file is ``jax.export``'s versioned
serialization, which needs the ``flatbuffers`` package.
"""

import json
import os

import numpy as np

import jax
import jax.numpy as jnp
from jax import export as jax_export

# marker key for a quantized leaf inside a params pytree
_Q8_KEY = "__q8__"


def quantize_params(params, min_size=4096):
    """Weight-only symmetric int8 quantization of a params pytree.

    Every floating leaf with ``ndim >= 2`` and at least ``min_size``
    elements (matmul/conv/embedding weights — where the bytes are)
    becomes ``{"__q8__": int8, "scale": f32}`` with one scale per
    output channel (last axis), ``q = round(w / scale)`` clipped to
    ±127.  Biases, norm scales, and BN stats stay float: they are tiny
    and precision-critical.  Max dequantization error per element is
    ``scale/2 = amax/254`` of its channel.

    Serving-side counterpart of the reference's non-existent deployment
    path (the reference always decodes f32 research checkpoints,
    reference: beam.py:80); artifacts shrink ~4x and cold-load faster.
    """
    def quant(w):
        a = np.asarray(w)
        if a.ndim < 2 or a.size < min_size or \
                not np.issubdtype(a.dtype, np.floating):
            return w
        a32 = a.astype(np.float32)
        # output-channel axis: conv kernels are OIHW (ops/cnn.py:33)
        # -> axis 0; matmul/embedding weights put the output last
        out_axis = 0 if a.ndim == 4 else a.ndim - 1
        red = tuple(i for i in range(a.ndim) if i != out_axis)
        amax = np.max(np.abs(a32), axis=red, keepdims=True)
        scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        q = np.clip(np.rint(a32 / scale), -127, 127).astype(np.int8)
        return {_Q8_KEY: q, "scale": scale}

    return jax.tree.map(quant, params)


def _has_q8(tree):
    """True if any leaf of ``tree`` is a quantized weight."""
    return any(_is_q8(x) for x in jax.tree.leaves(tree, is_leaf=_is_q8))


def _is_q8(x):
    return isinstance(x, dict) and _Q8_KEY in x


def dequantize_params(qparams, dtype=jnp.float32):
    """Inverse of :func:`quantize_params` — traceable, so it runs
    *inside* exported artifacts: the int8 tensors are what gets baked
    into the StableHLO constants, and XLA hoists the dequant multiply
    out of the decode loop at run time."""
    def deq(x):
        if _is_q8(x):
            return (jnp.asarray(x[_Q8_KEY]).astype(jnp.float32)
                    * jnp.asarray(x["scale"])).astype(dtype)
        return x

    return jax.tree.map(deq, qparams, is_leaf=_is_q8)


# platforms an artifact is lowered for unless the caller names others
DEFAULT_PLATFORMS = ("cpu", "cuda")


def export_greedy(params, state, mcfg, batch, frames, stop_limit,
                  compute_dtype=jnp.float32, platforms=DEFAULT_PLATFORMS,
                  in_dim=13, quantize=False, q_min_size=4096):
    """Export batched greedy decode as ``X (B, T, in_dim) f32 ->
    (preds (B, stop_limit) i32, n_steps i32)`` with the weights baked in.

    ``quantize=True`` bakes int8 weight constants instead of f32 (see
    :func:`quantize_params`) with an in-artifact dequant prologue;
    alternatively pass an already-quantized tree as ``params`` (the CLI
    quantizes once and reuses it across the shape ladder).

    Returns a ``jax.export.Exported``; ``.serialize()`` it to bytes or
    call it in-process via ``.call(X)``.
    """
    from ast_tpu.models import seq2seq

    if quantize and not _has_q8(params):
        params = quantize_params(params, q_min_size)
    p_or_q, deq = params, _has_q8(params)

    def fn(X):
        p = dequantize_params(p_or_q) if deq else p_or_q
        return seq2seq.predict_greedy(p, state, mcfg, X,
                                      stop_limit, compute_dtype)

    spec = jax.ShapeDtypeStruct((batch, frames, in_dim), jnp.float32)
    return jax_export.export(jax.jit(fn),
                             platforms=list(platforms))(spec)


def export_beam(params, state, mcfg, batch, frames, N, K, stop_limit,
                compute_dtype=jnp.float32, platforms=DEFAULT_PLATFORMS,
                in_dim=13, quantize=False, q_min_size=4096):
    """Export batched beam decode as ``X (B, T, in_dim) f32 ->
    (hyps (B, N, stop_limit+1) i32, scores (B, N) f32,
    lengths (B, N) i32)``.

    Length-norm reranking (``score/(len-2)^W``) is a host-side scalar
    pass over (scores, lengths) — ``ops.beam.get_best_hyps`` — kept out
    of the artifact so W stays a deploy-time knob.
    """
    from ast_tpu.ops.beam import make_beam_decoder

    decode = make_beam_decoder(mcfg, N, K, stop_limit, compute_dtype)
    if quantize and not _has_q8(params):
        params = quantize_params(params, q_min_size)
    p_or_q, deq = params, _has_q8(params)

    def fn(X):
        p = dequantize_params(p_or_q) if deq else p_or_q
        return decode(p, state, X)

    spec = jax.ShapeDtypeStruct((batch, frames, in_dim), jnp.float32)
    return jax_export.export(jax.jit(fn),
                             platforms=list(platforms))(spec)


def save_artifact(exported, path):
    """Serialize an ``Exported`` to ``path`` (atomic write)."""
    blob = exported.serialize()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    return len(blob)


class LoadedArtifact:
    """A deserialized artifact whose ``call`` is jitted ONCE.

    A bare ``Exported.call`` re-traces and re-lowers the entire
    weights-baked-in module on every invocation.  Wrapping in ``jax.jit`` makes repeat calls a
    cached dispatch; per-device executables are cached per committed
    input placement, which is what the serve replica pool relies on.
    """

    __slots__ = ("exported", "call")

    def __init__(self, exported):
        self.exported = exported
        self.call = jax.jit(exported.call)


def load_artifact(path):
    """Deserialize an artifact; run it via ``.call(X)`` (jit-cached)."""
    with open(path, "rb") as f:
        blob = f.read()
    return LoadedArtifact(jax_export.deserialize(bytearray(blob)))


def write_manifest(out_dir, entries, mcfg, stop_limit, compute_dtype,
                   i2w=None, dec_key="bpe_w", quantization=None):
    """Write ``manifest.json`` (+ optional ``vocab.json``) describing the
    exported artifacts, so a server needs no pickles or framework code
    to decode ids into tokens.  ``dec_key`` records the target unit so
    detokenization joins correctly (``*_w`` word units join with
    spaces, char units join bare; ``bpe_w`` additionally merges ``@@ ``
    — the dataloader's get_hyps contract)."""
    manifest = {
        "format": "jax.export StableHLO, weights baked in",
        "input": "float32 (batch, frames, 13) CMVN'd MFCC features",
        "symbols": {"PAD": 0, "GO": 1, "EOS": 2, "UNK": 3},
        "dec_vocab_size": mcfg["rnn_config"]["dec_vocab_size"],
        "dec_key": dec_key,
        "stop_limit": stop_limit,
        "compute_dtype": compute_dtype,
        "entries": entries,
    }
    if quantization:
        manifest["quantization"] = (
            f"{quantization} weight-only, symmetric per-output-channel, "
            "dequantized inside the artifact")
    if i2w is not None:
        vpath = os.path.join(out_dir, "vocab.json")
        with open(vpath, "w") as f:
            json.dump({int(i): (w.decode() if isinstance(w, bytes) else w)
                       for i, w in i2w.items()}, f, indent=0)
        manifest["vocab"] = "vocab.json"
    mpath = os.path.join(out_dir, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=2)
    return mpath
