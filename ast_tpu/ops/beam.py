"""Fully batched on-device beam search.

The reference decodes beams one utterance at a time in Python, snapshotting
and restoring LSTM states per hypothesis per step (reference: nn.py:235-322
with set/get_decoder_states object surgery, beam.py:111-124 batch size 1).
Here the beam lives on the device as an extra axis folded into the batch:
all B utterances x N hypotheses advance in one ``decode_step`` call, the
N*K candidate frontier is pruned with ``lax.top_k``, and parent LSTM/attn
states are beam-gathered — no host round-trips inside the loop.

Semantics preserved from the reference:
- hyps that produced EOS are frozen and carried with unchanged score while
  live hyps expand (reference: nn.py:307-318)
- selection is by raw summed log-prob; length normalization
  ``score / (len-2)^W`` is applied only at final reranking
  (reference: beam.py:30-42)
- decode stops when all kept hyps end in EOS or at ``stop_limit``
"""

import jax
import jax.numpy as jnp
from jax import lax

from ast_tpu.models import seq2seq
from ast_tpu.symbols import SYMBOLS

NEG_INF = -1e30


def make_beam_decoder(mcfg, N, K, stop_limit, compute_dtype=jnp.float32,
                      return_attn=False, mesh=None):
    """Build a jitted ``(params, state, X) -> (hyps, scores, lengths)``.

    hyps: (B, N, stop_limit+1) int32 token ids beginning with GO;
    scores: (B, N) summed log-probs; lengths: (B, N) valid token counts.

    ``return_attn=True`` additionally returns the per-hypothesis attention
    history (B, N, stop_limit+1, T') — alphas of the step that produced
    each token, beam-gathered through reranking exactly like the token
    prefixes (reference beam entries carry (hyp, score, attn_history),
    beam.py:121).  Costs O(N * stop_limit * T') HBM per utterance, so it
    is off by default for bulk decoding.

    ``mesh``: constrain outputs to REPLICATED over the mesh so every
    process materializes the full beams (multi-host SPMD decode, same
    contract as dp.shard_eval_step).
    """
    V = mcfg["rnn_config"]["dec_vocab_size"]
    if K > V:
        # lax.top_k(logp, K) needs K candidates per row; surface the
        # actual constraint instead of an XLA shape error (the
        # reference would IndexError similarly — beam.py's -k is only
        # meaningful up to the vocabulary size)
        raise ValueError(
            f"beam width K={K} exceeds the decoder vocabulary "
            f"({V} tokens) — at most V continuations exist per step")
    if N < 1 or K < 1:
        raise ValueError(f"beam sizes must be >= 1 (got N={N}, K={K})")
    max_len = stop_limit + 1

    def decode(params, state, X):
        B = X.shape[0]
        key = jax.random.PRNGKey(0)
        enc_states, dec_h0, dec_c0, _ = seq2seq.encode(
            params, state, mcfg, X, key, False, 0.0, compute_dtype)

        carry = seq2seq.init_decoder_carry(mcfg, dec_h0, dec_c0)

        # tile to the beam: batch axis becomes B*N (beam-major within utt)
        def tile(x, batch_axis):
            return jnp.repeat(x, N, axis=batch_axis)

        enc_tiled = tile(enc_states, 0)                  # (B*N, T, H)
        carry = {
            "h": tile(carry["h"], 1),                     # (L, B*N, H)
            "c": tile(carry["c"], 1),
            "ht": tile(carry["ht"], 0),                   # (B*N, A)
        }

        T_enc = enc_states.shape[1]
        scores0 = jnp.full((B, N), NEG_INF).at[:, 0].set(0.0)
        tokens0 = jnp.full((B, N, max_len), SYMBOLS.PAD_ID, jnp.int32)
        tokens0 = tokens0.at[:, :, 0].set(SYMBOLS.GO_ID)
        lengths0 = jnp.ones((B, N), jnp.int32)
        finished0 = jnp.zeros((B, N), bool)
        last0 = jnp.full((B, N), SYMBOLS.GO_ID, jnp.int32)
        attn0 = jnp.zeros(
            (B, N, max_len, T_enc) if return_attn else (B, N, 1, 1),
            jnp.float32)

        def cond(loop):
            step, _, _, _, finished, _, _, _ = loop
            return (step < stop_limit) & ~jnp.all(finished)

        def body(loop):
            step, scores, tokens, lengths, finished, last, carry, attn = loop
            logits, new_carry, alphas = seq2seq.decode_step(
                params, mcfg, enc_tiled, carry, last.reshape(B * N),
                jax.random.PRNGKey(0), False, compute_dtype)
            logp = jax.nn.log_softmax(logits, axis=-1).reshape(B, N, -1)

            # top-K continuations per live hyp
            top_logp, top_tok = lax.top_k(logp, K)       # (B, N, K)
            # frozen hyps contribute themselves once, score unchanged
            top_logp = jnp.where(finished[:, :, None],
                                 jnp.where(jnp.arange(K) == 0, 0.0, NEG_INF),
                                 top_logp)
            top_tok = jnp.where(finished[:, :, None],
                                SYMBOLS.EOS_ID, top_tok)

            cand = scores[:, :, None] + top_logp          # (B, N, K)
            new_scores, flat_idx = lax.top_k(cand.reshape(B, N * K), N)
            parent = flat_idx // K                        # (B, N)
            tok = jnp.take_along_axis(
                top_tok.reshape(B, N * K), flat_idx, axis=1).astype(jnp.int32)

            # gather beam-parent bookkeeping
            p_tokens = jnp.take_along_axis(tokens, parent[:, :, None], axis=1)
            p_len = jnp.take_along_axis(lengths, parent, axis=1)
            p_fin = jnp.take_along_axis(finished, parent, axis=1)

            write = (jnp.arange(max_len)[None, None, :] == p_len[:, :, None]) \
                & ~p_fin[:, :, None]
            new_tokens = jnp.where(write, tok[:, :, None], p_tokens)
            new_lengths = p_len + (~p_fin).astype(jnp.int32)
            new_finished = p_fin | (tok == SYMBOLS.EOS_ID)

            if return_attn:
                # attention of the step that produced ``tok``, gathered
                # from the parent hypothesis like the token prefix
                sel = jnp.take_along_axis(
                    alphas.reshape(B, N, T_enc).astype(jnp.float32),
                    parent[:, :, None], axis=1)            # (B, N, T)
                p_attn = jnp.take_along_axis(
                    attn, parent[:, :, None, None], axis=1)
                new_attn = jnp.where(write[:, :, :, None],
                                     sel[:, :, None, :], p_attn)
            else:
                new_attn = attn

            # gather parent LSTM/attention states
            def gather_batch(x):
                # x: (..., B*N, ...) with beam folded at axis -2 of (B, N)
                if x.ndim == 2:          # (B*N, F)
                    xr = x.reshape(B, N, -1)
                    out = jnp.take_along_axis(
                        xr, parent[:, :, None], axis=1)
                    return out.reshape(B * N, -1)
                # (L, B*N, F)
                L = x.shape[0]
                xr = x.reshape(L, B, N, -1)
                out = jnp.take_along_axis(
                    xr, parent[None, :, :, None], axis=2)
                return out.reshape(L, B * N, -1)

            new_carry = {
                "h": gather_batch(new_carry["h"]),
                "c": gather_batch(new_carry["c"]),
                "ht": gather_batch(new_carry["ht"]),
            }

            return (step + 1, new_scores, new_tokens, new_lengths,
                    new_finished, tok, new_carry, new_attn)

        loop0 = (jnp.int32(0), scores0, tokens0, lengths0, finished0,
                 last0, carry, attn0)
        _, scores, tokens, lengths, finished, _, _, attn = lax.while_loop(
            cond, body, loop0)
        if return_attn:
            return tokens, scores, lengths, attn
        return tokens, scores, lengths

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        return jax.jit(decode,
                       out_shardings=NamedSharding(mesh, PartitionSpec()))
    return jax.jit(decode)


# ---------------------------------------------------------------------------
# host-side reranking (reference: beam.py:30-42)
# ---------------------------------------------------------------------------

def rerank_hypothesis(beam_hyps, weight):
    """[(hyp_ids, score[, attn])] -> sorted [(hyp_ids, norm_score, len)]."""
    return sorted(
        [(e[0], e[1] / (max(1, len(e[0]) - 2) ** weight), len(e[0]))
         for e in beam_hyps],
        reverse=True, key=lambda t: t[1])


def get_best_hyps(utts_beam, W):
    """{utt: [(hyp_ids, score)]} -> {utt: best hyp_ids} after length-norm."""
    preds = {}
    for u, hyps in utts_beam.items():
        preds[u] = list(rerank_hypothesis(hyps, W)[0][0])
    return preds
