"""Speech encoder-decoder with Luong attention — functional JAX core.

Capability-parity rebuild of the reference model (reference: seq2seq.py:22-568
``SpeechEncoderDecoder``; legacy variants enc_dec.py): pyramidal CNN
front-end -> stacked bidirectional LSTM encoder -> attention LSTM decoder
with input feeding, scheduled sampling, and PAD-masked cross entropy.

Design decisions (vs. the reference's per-timestep Python loops):

- The *entire* encoder is ONE ``lax.scan`` over time.  The reference runs
  the forward and reverse 3-layer LSTM stacks independently and only
  concatenates their top-layer outputs at the end (reference:
  seq2seq.py:205-232), which means both directions can share a scan step:
  we stack them on a leading direction axis and batch the per-layer matmuls
  with einsum, so one scan step advances all 6 LSTMs.
- Layer-0 input projections (x @ wx for both directions) are hoisted out of
  the scan as one big time-batched matmul.
- The decoder's teacher-forcing loop is a ``lax.scan`` over target steps;
  greedy decode is a ``lax.while_loop`` with EOS early exit.
- Static shapes everywhere: (T, U) is fixed per duration bucket.

Parity quirks preserved deliberately (they affect BLEU):
- attention is UNMASKED over padded frames by default (reference:
  seq2seq.py:344-351)
- scheduled-sampling coin is flipped once per *step* (shared by the batch),
  with step 0 and the final step always teacher-forced (reference:
  seq2seq.py:423-436)
- dropout on every LSTM output including the ones stored as encoder states
  (reference: seq2seq.py:192-203)
- loss: per-step softmax CE, mean over the true batch rows, summed over
  steps (reference: seq2seq.py:468-470 with Chainer normalize=True)

Documented deviations:
- encoder reversal processes the true reversed sequence by default (the
  reference's ``X[-i]`` indexing feeds X[0] to the reverse stack at step 0,
  seq2seq.py:219; and its linear_proj variant feeds a constant last frame,
  seq2seq.py:256).  Set ``rnn_config.ref_rev_quirk: true`` for the
  bit-faithful reference ordering — the NumPy reference oracle
  (tests/reference_oracle.py) validates both modes
- ``random_out`` corruption samples uniformly in [4, V) (the reference's
  randint upper bound V+1 could produce an out-of-range id,
  seq2seq.py:464-465)
"""

import jax
import jax.numpy as jnp
from jax import lax

from ast_tpu.ops.attention import init_attention_params, luong_attention
from ast_tpu.ops.cnn import conv_frontend, conv_out_len, init_conv_params
from ast_tpu.ops.lstm import dropout, init_lstm_params, lstm_gates
from ast_tpu.symbols import SYMBOLS


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------

def init_model(key, mcfg, in_dim=13):
    """Build (params, state) pytrees from a model_cfg dict.

    Top-level param groups are chosen to mirror the reference's transfer
    groups (reference: copy_params.py:20-24): "cnn"+"enc" = encoder,
    "attn" = attention, "dec" = decoder, so subtree transfer is a dict pick.
    """
    rnn = mcfg["rnn_config"]
    cnn = mcfg["cnn_config"]
    hidden = rnn["hidden_units"]
    bi = rnn["bi_rnn"]
    enc_units = hidden // 2 if bi else hidden
    n_dirs = 2 if bi else 1
    e_units = rnn["embedding_units"]
    a_units = rnn["attn_units"]
    vocab = rnn["dec_vocab_size"]
    n_attn = rnn.get("n_attn", 1)

    keys = jax.random.split(key, 8)
    cnn_params, cnn_state = init_conv_params(keys[0], cnn, in_dim)

    # text-encoder mode: source-token embedding feeding the same CNN+RNN
    # stack (legacy capability, reference: enc_dec.py:162-164, 517-525)
    enc_embed = None
    if rnn.get("enc_vocab_size", 0):
        enc_embed = jax.random.normal(
            jax.random.fold_in(keys[7], 1),
            (rnn["enc_vocab_size"], rnn["embedding_units"]))

    # encoder feature width after the conv stack (W axis collapsed)
    cnn_out = cnn["cnn_layers"][-1]["out_channels"]

    def stacked_dir_lstm(key, n_layers, in0):
        """Per-layer params with a leading direction axis (n_dirs, ...).

        Stacked mode: layer l>0 consumes its own direction's output
        (enc_units wide).  linear_proj mode: every layer consumes the
        full-width projected states (hidden wide) — reference:
        seq2seq.py:252-281 feeds enc_states to every layer."""
        proj_mode = rnn.get("linear_proj", False)
        layers = []
        for l in range(n_layers):
            in_dim_l = in0 if l == 0 else (
                hidden if proj_mode else enc_units)
            dir_params = []
            for d in range(n_dirs):
                key, sub = jax.random.split(key)
                dir_params.append(init_lstm_params(sub, in_dim_l, enc_units))
            layers.append(jax.tree.map(lambda *xs: jnp.stack(xs), *dir_params)
                          if n_dirs > 1 else dir_params[0])
        return layers

    enc_layers = stacked_dir_lstm(keys[1], rnn["enc_layers"], cnn_out)

    # optional per-layer LayerNorm on LSTM outputs (reference:
    # seq2seq.py:84-87,199-202 — one LN per LSTM link, applied after
    # dropout); params per enc layer carry a direction axis
    enc_ln, dec_ln = [], []
    if rnn.get("ln", False):
        for _ in range(rnn["enc_layers"]):
            enc_ln.append({"g": jnp.ones((n_dirs, enc_units)),
                           "b": jnp.zeros((n_dirs, enc_units))})
        for _ in range(rnn["dec_layers"]):
            dec_ln.append({"g": jnp.ones((hidden,)),
                           "b": jnp.zeros((hidden,))})

    # optional inter-layer projection (linear_proj variant,
    # reference: seq2seq.py:91-99)
    proj_params, proj_state = [], []
    if rnn.get("linear_proj", False):
        lecun = jax.nn.initializers.lecun_normal()
        pkey = keys[2]
        for l in range(rnn["enc_layers"] - 1):
            pkey, sub = jax.random.split(pkey)
            proj_params.append({
                "w": lecun(sub, (hidden, hidden)),
                "b": jnp.zeros((hidden,)),
                "bn_gamma": jnp.ones((hidden,)),
                "bn_beta": jnp.zeros((hidden,)),
            })
            proj_state.append({
                "bn_mean": jnp.zeros((hidden,)),
                "bn_var": jnp.ones((hidden,)),
            })

    attn_params = init_attention_params(keys[3], hidden, a_units, n_attn)

    # decoder: embedding (Chainer EmbedID default: Normal(1.0)), LSTMs, out
    embed = jax.random.normal(keys[4], (vocab, e_units))
    dec_in0 = e_units + (a_units if rnn.get("feed_attn", True) else 0)
    dec_layers = []
    dkey = keys[5]
    for l in range(rnn["dec_layers"]):
        dkey, sub = jax.random.split(dkey)
        in_dim_l = dec_in0 if l == 0 else hidden
        dec_layers.append(init_lstm_params(sub, in_dim_l, hidden))
    lecun = jax.nn.initializers.lecun_normal()
    out_w = lecun(keys[6], (a_units, vocab))
    out_b = jnp.zeros((vocab,))

    params = {
        "cnn": cnn_params,
        "enc": {"lstm": enc_layers, "proj": proj_params},
        "attn": attn_params,
        "dec": {"embed": embed, "lstm": dec_layers,
                "out_w": out_w, "out_b": out_b},
    }
    if enc_embed is not None:
        params["enc"]["embed"] = enc_embed
    if rnn.get("ln", False):
        params["enc"]["ln"] = enc_ln
        params["dec"]["ln"] = dec_ln
    state = {"cnn_bn": cnn_state, "enc_proj_bn": proj_state}
    return params, state


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _layernorm(x, g, b, eps=1e-6):
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.var(x, axis=-1, keepdims=True)
    return (x - mean) * lax.rsqrt(var + eps) * g + b


def _dir_lstm_matmul(p, x, wname):
    """x: (D, B, in) @ p[wname]: (D, in, 4H) -> (D, B, 4H)."""
    return jnp.einsum("dbi,dih->dbh", x, p[wname],
                      preferred_element_type=jnp.float32)


def encode(params, state, mcfg, X, key, train, add_noise=0.0,
           compute_dtype=jnp.float32):
    """Run CNN + stacked (bi)LSTM encoder.

    X: (B, T, D) padded speech features.
    Returns (enc_states (B, T', H), dec_h0 (L, B, H), dec_c0 (L, B, H),
    new_state).
    """
    rnn = mcfg["rnn_config"]
    drop = mcfg["dropout"]["rnn"]
    bi = rnn["bi_rnn"]
    n_dirs = 2 if bi else 1
    enc_units = rnn["hidden_units"] // n_dirs
    n_layers = rnn["enc_layers"]
    B = X.shape[0]

    key, nkey = jax.random.split(key)
    if jnp.issubdtype(X.dtype, jnp.integer):
        # text-encoder mode: embed source tokens, then the same conv stack
        X = params["enc"]["embed"][X]
    elif train and add_noise > 0:
        # multiplicative speech noise N(1, sigma) (reference: seq2seq.py:297-305)
        X = X * (1.0 + add_noise * jax.random.normal(nkey, X.shape))

    h_cnn, new_cnn_state = conv_frontend(
        params["cnn"], state["cnn_bn"], mcfg["cnn_config"], X, train,
        compute_dtype,
    )
    Tp = h_cnn.shape[1]

    if rnn.get("linear_proj", False):
        return _encode_proj(params, state, mcfg, h_cnn, key, train,
                            new_cnn_state, compute_dtype)

    # direction-stacked sequence: xs[t, 0] = x_t, xs[t, 1] = x_{T-1-t}
    seq = jnp.transpose(h_cnn, (1, 0, 2))  # (T', B, C)
    if bi:
        if rnn.get("ref_rev_quirk", False):
            # bit-faithful reference ordering: the reverse stack consumes
            # X[-i], i.e. [X[0], X[T-1], ..., X[1]] (reference:
            # seq2seq.py:219 feeds X[-i]; X[-0] is X[0])
            rev_in = jnp.concatenate([seq[:1], jnp.flip(seq[1:], axis=0)],
                                     axis=0)
        else:
            rev_in = jnp.flip(seq, axis=0)
        xs = jnp.stack([seq, rev_in], axis=1)  # (T', 2, B, C)
    else:
        xs = seq[:, None]  # (T', 1, B, C)

    layers = params["enc"]["lstm"]
    if n_dirs == 1:
        layers = [jax.tree.map(lambda a: a[None], l) for l in layers]

    # hoist layer-0 input projection out of the scan: one time-batched matmul
    x0_proj = jnp.einsum(
        "tdbi,dih->tdbh", xs.astype(compute_dtype),
        layers[0]["wx"].astype(compute_dtype),
        preferred_element_type=jnp.float32,
    )

    use_ln = rnn.get("ln", False)
    use_relu = rnn.get("rnn_relu", False)
    step_keys = jax.random.split(key, Tp)
    h0 = jnp.zeros((n_layers, n_dirs, B, enc_units))
    c0 = jnp.zeros((n_layers, n_dirs, B, enc_units))

    def step(carry, inp):
        h_all, c_all = carry
        xp0, skey = inp
        lkeys = jax.random.split(skey, n_layers)
        x = None
        new_h, new_c = [], []
        for l, lp in enumerate(layers):
            if l == 0:
                z = xp0
            else:
                z = _dir_lstm_matmul(
                    {"wx": lp["wx"].astype(compute_dtype)},
                    x.astype(compute_dtype), "wx")
            z = z + _dir_lstm_matmul(lp, h_all[l], "wh") \
                + lp["b"][:, None, :]
            h_new, c_new = lstm_gates(z, c_all[l], enc_units)
            x = dropout(lkeys[l], h_new, drop, train)
            if use_ln:
                ln = params["enc"]["ln"][l]
                x = _layernorm(x, ln["g"][:, None, :],
                               ln["b"][:, None, :])
            if use_relu:
                # legacy rnn_relu knob: ReLU on every LSTM layer's
                # output, after dropout+LN (reference:
                # enc_dec.py:282-283, feed_rnn order)
                x = jnp.maximum(x, 0.0)
            new_h.append(h_new)
            new_c.append(c_new)
        return (jnp.stack(new_h), jnp.stack(new_c)), x

    (h_fin, c_fin), outs = lax.scan(
        step, (h0, c0), (x0_proj, step_keys),
        unroll=rnn.get("scan_unroll", 1))
    # outs: (T', D, B, enc_units) — post-dropout top-layer outputs
    if bi:
        fwd = outs[:, 0]
        rev = jnp.flip(outs[:, 1], axis=0)
        enc_states = jnp.concatenate([fwd, rev], axis=-1)  # (T', B, H)
        dec_h0 = jnp.concatenate([h_fin[:, 0], h_fin[:, 1]], axis=-1)
        dec_c0 = jnp.concatenate([c_fin[:, 0], c_fin[:, 1]], axis=-1)
    else:
        enc_states = outs[:, 0]
        dec_h0, dec_c0 = h_fin[:, 0], c_fin[:, 0]

    enc_states = jnp.transpose(enc_states, (1, 0, 2))  # (B, T', H)
    new_state = {"cnn_bn": new_cnn_state,
                 "enc_proj_bn": state["enc_proj_bn"]}
    return enc_states, dec_h0, dec_c0, new_state


def _encode_proj(params, state, mcfg, h_cnn, key, train, new_cnn_state,
                 compute_dtype):
    """linear_proj encoder variant: per-layer biLSTM -> Linear+BN+ReLU
    between layers (reference: seq2seq.py:244-291, corrected reversal)."""
    rnn = mcfg["rnn_config"]
    drop = mcfg["dropout"]["rnn"]
    bi = rnn["bi_rnn"]
    n_dirs = 2 if bi else 1
    enc_units = rnn["hidden_units"] // n_dirs
    n_layers = rnn["enc_layers"]
    B, Tp, _ = h_cnn.shape

    seq = jnp.transpose(h_cnn, (1, 0, 2))  # (T', B, C)
    new_proj_state = []
    dec_h0, dec_c0 = [], []

    for l in range(n_layers):
        lp = params["enc"]["lstm"][l]
        if n_dirs == 1:
            lp = jax.tree.map(lambda a: a[None], lp)
        if bi:
            xs = jnp.stack([seq, jnp.flip(seq, axis=0)], axis=1)
        else:
            xs = seq[:, None]
        key, lkey = jax.random.split(key)
        step_keys = jax.random.split(lkey, Tp)
        h0 = jnp.zeros((n_dirs, B, enc_units))
        c0 = jnp.zeros((n_dirs, B, enc_units))

        def step(carry, inp, lp=lp):
            h, c = carry
            x, skey = inp
            z = _dir_lstm_matmul(lp, x, "wx") \
                + _dir_lstm_matmul(lp, h, "wh") + lp["b"][:, None, :]
            h_new, c_new = lstm_gates(z, c, enc_units)
            out = dropout(skey, h_new, drop, train)
            return (h_new, c_new), out

        (h_fin, c_fin), outs = lax.scan(step, (h0, c0), (xs, step_keys))
        if bi:
            layer_out = jnp.concatenate(
                [outs[:, 0], jnp.flip(outs[:, 1], axis=0)], axis=-1)
            dec_h0.append(jnp.concatenate([h_fin[0], h_fin[1]], axis=-1))
            dec_c0.append(jnp.concatenate([c_fin[0], c_fin[1]], axis=-1))
        else:
            layer_out = outs[:, 0]
            dec_h0.append(h_fin[0])
            dec_c0.append(c_fin[0])

        if l < n_layers - 1:
            pp = params["enc"]["proj"][l]
            ps = state["enc_proj_bn"][l]
            flat = layer_out.reshape(-1, layer_out.shape[-1])
            flat = flat @ pp["w"] + pp["b"]
            if train:
                mean = jnp.mean(flat, axis=0)
                var = jnp.var(flat, axis=0)
                ps = {"bn_mean": 0.9 * ps["bn_mean"] + 0.1 * mean,
                      "bn_var": 0.9 * ps["bn_var"] + 0.1 * var}
            else:
                mean, var = ps["bn_mean"], ps["bn_var"]
            flat = (flat - mean) * lax.rsqrt(var + 2e-5)
            flat = flat * pp["bn_gamma"] + pp["bn_beta"]
            seq = jax.nn.relu(flat).reshape(layer_out.shape)
            new_proj_state.append(ps)
        else:
            enc_states = layer_out

    enc_states = jnp.transpose(enc_states, (1, 0, 2))
    new_state = {"cnn_bn": new_cnn_state, "enc_proj_bn": new_proj_state}
    return enc_states, jnp.stack(dec_h0), jnp.stack(dec_c0), new_state


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def decode_step(params, mcfg, enc_states, carry, token, key, train,
                compute_dtype=jnp.float32, enc_mask=None):
    """One decoder step (reference: seq2seq.py:361-396).

    carry: {"h": (L,B,H), "c": (L,B,H), "ht": (B,A)}.
    Returns (logits (B,V), new_carry, alphas (B,T')).
    """
    rnn = mcfg["rnn_config"]
    drop = mcfg["dropout"]
    hidden = rnn["hidden_units"]
    # three independent streams: reusing `key` after a split would make
    # the logits-dropout mask deterministically related to the
    # embed/rnn masks (JAX key-hygiene rule)
    k_emb, k_rnn, k_out = jax.random.split(key, 3)

    emb = params["dec"]["embed"][token]  # (B, E)
    emb = dropout(k_emb, emb, drop["embed"], train)
    if rnn.get("feed_attn", True):
        x = jnp.concatenate([emb, carry["ht"]], axis=-1)
    else:
        x = emb

    lkeys = jax.random.split(k_rnn, len(params["dec"]["lstm"]))
    new_h, new_c = [], []
    for l, lp in enumerate(params["dec"]["lstm"]):
        x_proj = jnp.dot(x.astype(compute_dtype),
                         lp["wx"].astype(compute_dtype),
                         preferred_element_type=jnp.float32)
        z = x_proj + carry["h"][l] @ lp["wh"] + lp["b"]
        h_new, c_new = lstm_gates(z, carry["c"][l], hidden)
        x = dropout(lkeys[l], h_new, drop["rnn"], train)
        if rnn.get("ln", False):
            ln = params["dec"]["ln"][l]
            x = _layernorm(x, ln["g"], ln["b"])
        if rnn.get("rnn_relu", False):
            # legacy knob: feed_rnn serves the decoder too (reference:
            # enc_dec.py:304), so rnn_relu applies here as well
            x = jnp.maximum(x, 0.0)
        new_h.append(h_new)
        new_c.append(c_new)

    ht, alphas = luong_attention(params["attn"], enc_states, x,
                                 enc_mask=enc_mask,
                                 compute_dtype=compute_dtype,
                                 block_size=rnn.get("attn_block_size", 0))
    logits = jnp.dot(ht.astype(compute_dtype),
                     params["dec"]["out_w"].astype(compute_dtype),
                     preferred_element_type=jnp.float32) \
        + params["dec"]["out_b"]
    # out-dropout on logits, as the reference applies it (seq2seq.py:394)
    logits = dropout(k_out, logits, drop["out"], train)
    new_carry = {"h": jnp.stack(new_h), "c": jnp.stack(new_c), "ht": ht}
    return logits, new_carry, alphas


def init_decoder_carry(mcfg, dec_h0, dec_c0):
    """Decoder LSTM state from final encoder states + zero attention vector
    (reference: seq2seq.py:318-333, 419-420)."""
    B = dec_h0.shape[1]
    a_units = mcfg["rnn_config"]["attn_units"]
    return {"h": dec_h0, "c": dec_c0,
            "ht": jnp.zeros((B, a_units))}


# ---------------------------------------------------------------------------
# losses / decoding
# ---------------------------------------------------------------------------

def forward_loss(params, state, mcfg, X, y, key, train=True, n_real=None,
                 teach_ratio=1.0, random_out=0.0, add_noise=0.0,
                 compute_dtype=jnp.float32, enc_mask=None,
                 label_smoothing=0.0):
    """Teacher-forced (scheduled-sampling) sequence loss.

    ``label_smoothing`` (beyond-reference, ``extras.label_smoothing``):
    train-time uniform label smoothing over the real vocabulary —
    per-token loss becomes (1-eps)*NLL(target) + eps*mean_v(-log p_v),
    a static mix of the same log-softmax (no extra matmul).  0.0 (the default and the reference's behavior)
    is the exact teacher-forced CE; eval passes never smooth.

    X: (B, T, D) speech; y: (B, U) int32 targets incl. GO/EOS, PAD-padded.
    Returns (loss, new_state).  Loss = sum over steps of
    mean-over-true-batch PAD-masked CE (reference: seq2seq.py:399-473).
    """
    X = jnp.asarray(X)
    y = jnp.asarray(y)
    B, U = y.shape
    V = mcfg["rnn_config"]["dec_vocab_size"]
    if n_real is None:
        n_real = B
    n_real = jnp.asarray(n_real, jnp.float32)

    key, ekey = jax.random.split(key)
    enc_states, dec_h0, dec_c0, new_state = encode(
        params, state, mcfg, X, ekey, train, add_noise, compute_dtype)

    carry0 = init_decoder_carry(mcfg, dec_h0, dec_c0)
    yT = y.T  # (U, B)
    steps = U - 1
    step_keys = jax.random.split(key, steps)
    idx = jnp.arange(steps)

    def step(scan_carry, inp):
        carry, prev_pred = scan_carry
        i, skey = inp
        k_coin, k_step, k_rand1, k_rand2 = jax.random.split(skey, 4)
        curr_word = yT[i]
        next_word = yT[i + 1]

        # scheduled sampling: one coin per step, first/last always forced
        if train and teach_ratio < 1.0:
            coin = jax.random.bernoulli(k_coin, teach_ratio)
            forced = (i == 0) | (i >= steps - 1)
            use_true = forced | coin
            dec_in = jnp.where(use_true, curr_word, prev_pred)
        else:
            dec_in = curr_word

        logits, carry, _ = decode_step(
            params, mcfg, enc_states, carry, dec_in, k_step, train,
            compute_dtype, enc_mask)
        pred = jnp.argmax(logits, axis=-1).astype(jnp.int32)

        target = next_word
        if train and random_out > 0:
            # label corruption (reference: seq2seq.py:456-466)
            replace = (target >= SYMBOLS.N_SPECIAL) & (
                jax.random.uniform(k_rand1, (B,)) > random_out)
            rand_ids = jax.random.randint(
                k_rand2, (B,), SYMBOLS.N_SPECIAL, V).astype(jnp.int32)
            target = jnp.where(replace, rand_ids, target)

        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, target[:, None], axis=-1)[:, 0]
        if train and label_smoothing > 0:
            eps = label_smoothing
            nll = (1.0 - eps) * nll + eps * -jnp.mean(logp, axis=-1)
        pad_w = (target != SYMBOLS.PAD_ID).astype(jnp.float32)
        step_loss = jnp.sum(nll * pad_w) / n_real
        return (carry, pred), step_loss

    (_, _), step_losses = lax.scan(
        step, (carry0, yT[0]), (idx, step_keys),
        unroll=mcfg["rnn_config"].get("scan_unroll", 1))
    return jnp.sum(step_losses), new_state


def predict_greedy(params, state, mcfg, X, stop_limit,
                   compute_dtype=jnp.float32, enc_mask=None):
    """Batched greedy decode with EOS early exit.

    Returns (preds (B, stop_limit) int32, n_steps).  Positions past a
    sentence's first EOS hold whatever argmax produced — the reference does
    not truncate at EOS either (reference: seq2seq.py:475-527,
    dataloader.py:178-180) — and specials are filtered at detokenization.
    """
    B = X.shape[0]
    key = jax.random.PRNGKey(0)  # eval mode: no randomness consumed
    enc_states, dec_h0, dec_c0, _ = encode(
        params, state, mcfg, X, key, False, 0.0, compute_dtype)

    carry0 = init_decoder_carry(mcfg, dec_h0, dec_c0)

    def cond(loop):
        step, _, _, finished, _ = loop
        return (step < stop_limit) & ~jnp.all(finished)

    def body(loop):
        step, word, carry, finished, out = loop
        logits, carry, _ = decode_step(
            params, mcfg, enc_states, carry, word, key, False,
            compute_dtype, enc_mask)
        pred = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out = lax.dynamic_update_slice(
            out, pred[:, None], (jnp.int32(0), step))
        finished = finished | (pred == SYMBOLS.EOS_ID)
        return step + 1, pred, carry, finished, out

    out0 = jnp.full((B, stop_limit), SYMBOLS.PAD_ID, jnp.int32)
    word0 = jnp.full((B,), SYMBOLS.GO_ID, jnp.int32)
    finished0 = jnp.zeros((B,), bool)
    n_steps, _, _, _, out = lax.while_loop(
        cond, body, (jnp.int32(0), word0, carry0, finished0, out0))
    return out, n_steps


# ---------------------------------------------------------------------------
# utilities
# ---------------------------------------------------------------------------

def make_enc_mask(mcfg, x_len, Tp):
    """(B,) true frame lengths -> (B, Tp) boolean encoder mask.

    Reuses ``ops.cnn.conv_out_len`` (its int arithmetic traces fine on
    jnp arrays) so the mask length includes EVERY time-reducing stage —
    an earlier inline copy of the conv arithmetic silently skipped the
    per-layer max-pool ceil-division, marking ~pool_stride times too
    many frames valid for legacy pooled configs."""
    t = conv_out_len(mcfg["cnn_config"], x_len)
    return jnp.arange(Tp)[None, :] < t[:, None]


def add_weight_noise(params, key, mean, sigma):
    """Gaussian weight noise on LSTM weights + decoder embedding, applied
    persistently per epoch (legacy capability, reference:
    enc_dec.py:587-624, nmt_run.py:850-854)."""
    def noise(k, a):
        return a + mean + sigma * jax.random.normal(k, a.shape)

    flat, treedef = jax.tree.flatten(params["enc"]["lstm"])
    keys = jax.random.split(key, len(flat) + 1 +
                            len(jax.tree.leaves(params["dec"]["lstm"])))
    ki = 0
    new_enc = []
    for leaf in flat:
        new_enc.append(noise(keys[ki], leaf))
        ki += 1
    dec_flat, dec_def = jax.tree.flatten(params["dec"]["lstm"])
    new_dec = []
    for leaf in dec_flat:
        new_dec.append(noise(keys[ki], leaf))
        ki += 1
    out = dict(params)
    out["enc"] = dict(params["enc"])
    out["enc"]["lstm"] = jax.tree.unflatten(treedef, new_enc)
    out["dec"] = dict(params["dec"])
    out["dec"]["lstm"] = jax.tree.unflatten(dec_def, new_dec)
    out["dec"]["embed"] = noise(keys[ki], params["dec"]["embed"])
    return out


def param_count(params):
    return sum(int(x.size) for x in jax.tree.leaves(params))
