"""Pure-NumPy replica of the reference model's forward semantics.

This is the parity oracle SURVEY §4 calls for: an independent, loop-based
re-implementation of the reference forward pass (reference:
seq2seq.py:158-180 forward_cnn, :192-242 feed_rnn/forward_rnn_encode
including the ``X[-i]`` reversal quirk, :318-333 init_decoder_state,
:336-396 attention/decode_step, :399-473 forward_loss with class-weighted
normalize-by-batch CE and the scheduled-sampling input chain, :475-527
greedy predict) operating on the ast_tpu parameter pytree.  It mirrors the
reference's *call structure* (per-timestep Python loops, per-layer state
objects) rather than ast_tpu's scan/einsum formulation, so agreement
between the two is evidence the JAX model computes the reference
semantics, not a tautology.

Deterministic paths only: dropout/noise off (rates 0), ``teach_ratio`` 1.0
(always forced) or 0.0 (non-forced steps consume the previous argmax — no
RNG in either case).  BatchNorm supports both eval mode (running stats)
and train mode (batch stats), matching Chainer's chainer.config.train.
"""

import numpy as np


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def top2_gap(logits):
    """(B,) gap between each row's largest and second-largest logit: how
    far the row's argmax is from a tie."""
    top2 = np.sort(logits, axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


class RefLSTM:
    """Stateful LSTM link (Chainer L.LSTM shape: keeps h, c across calls)."""

    def __init__(self, p):
        self.wx = np.asarray(p["wx"], np.float64)
        self.wh = np.asarray(p["wh"], np.float64)
        self.b = np.asarray(p["b"], np.float64)
        self.hidden = self.wh.shape[0]
        self.h = None
        self.c = None

    def reset_state(self):
        self.h = None
        self.c = None

    def set_state(self, c, h):
        self.c = np.asarray(c, np.float64)
        self.h = np.asarray(h, np.float64)

    def __call__(self, x):
        B = x.shape[0]
        if self.h is None:
            self.h = np.zeros((B, self.hidden))
            self.c = np.zeros((B, self.hidden))
        z = x @ self.wx + self.h @ self.wh + self.b
        H = self.hidden
        i = _sigmoid(z[:, :H])
        f = _sigmoid(z[:, H:2 * H])
        g = np.tanh(z[:, 2 * H:3 * H])
        o = _sigmoid(z[:, 3 * H:])
        self.c = f * self.c + i * g
        self.h = o * np.tanh(self.c)
        return self.h


class ReferenceOracle:
    def __init__(self, params, state, mcfg):
        self.p = params
        self.s = state
        self.mcfg = mcfg
        self.rnn_cfg = mcfg["rnn_config"]
        self.bi = self.rnn_cfg["bi_rnn"]
        n_layers = self.rnn_cfg["enc_layers"]
        # unstack the direction axis of ast_tpu's encoder params into the
        # reference's separate fwd/rev link lists
        self.rnn_enc, self.rnn_rev_enc = [], []
        for lp in params["enc"]["lstm"]:
            if self.bi:
                self.rnn_enc.append(RefLSTM(
                    {k: np.asarray(v)[0] for k, v in lp.items()}))
                self.rnn_rev_enc.append(RefLSTM(
                    {k: np.asarray(v)[1] for k, v in lp.items()}))
            else:
                self.rnn_enc.append(RefLSTM(lp))
        assert len(self.rnn_enc) == n_layers
        self.rnn_dec = [RefLSTM(lp) for lp in params["dec"]["lstm"]]

    # -- CNN (reference: seq2seq.py:158-180) --------------------------------

    def _conv2d(self, x, w, stride, pad):
        B, Ci, H, W = x.shape
        O, _, kh, kw = w.shape
        sh, sw = stride
        ph, pw = pad
        xp = np.pad(x, ((0, 0), (0, 0), (ph, ph), (pw, pw)))
        Ho = (H + 2 * ph - kh) // sh + 1
        Wo = (W + 2 * pw - kw) // sw + 1
        out = np.zeros((B, O, Ho, Wo))
        for i in range(Ho):
            for j in range(Wo):
                patch = xp[:, :, i * sh:i * sh + kh, j * sw:j * sw + kw]
                out[:, :, i, j] = np.tensordot(
                    patch, w, axes=([1, 2, 3], [1, 2, 3]))
        return out

    def forward_cnn(self, X, train):
        X = np.asarray(X)
        if np.issubdtype(X.dtype, np.integer):
            # text-encoder mode: source-token embedding feeds the same
            # conv stack (reference: enc_dec.py:162-164, 517-525)
            X = np.asarray(self.p["enc"]["embed"], np.float64)[X]
        h = np.asarray(X, np.float64)[:, None, :, :]  # (B,1,T,D)
        for li, layer in enumerate(self.mcfg["cnn_config"]["cnn_layers"]):
            p = self.p["cnn"][li]
            h = self._conv2d(h, np.asarray(p["w"], np.float64),
                             layer["stride"], layer["pad"])
            if "bn_gamma" in p:
                s = self.s["cnn_bn"][li]
                if train:
                    mean = h.mean(axis=(0, 2, 3))
                    var = h.var(axis=(0, 2, 3))
                else:
                    mean = np.asarray(s["bn_mean"], np.float64)
                    var = np.asarray(s["bn_var"], np.float64)
                h = (h - mean[None, :, None, None]) / np.sqrt(
                    var[None, :, None, None] + 2e-5)
                h = (h * np.asarray(p["bn_gamma"])[None, :, None, None]
                     + np.asarray(p["bn_beta"])[None, :, None, None])
            h = np.maximum(h, 0.0)
        B, C, Tp, Wp = h.shape
        # swapaxes(1,2) -> reshape -> rollaxis: (T', B, C*W')
        h = h.transpose(0, 2, 1, 3).reshape(B, Tp, C * Wp)
        return np.moveaxis(h, 1, 0)

    # -- encoder (reference: seq2seq.py:192-242) ----------------------------

    def feed_rnn(self, rnn_in, rnn_layers):
        hs = rnn_in
        for link in rnn_layers:
            hs = link(hs)  # dropout rate 0 in deterministic paths
            if self.rnn_cfg.get("rnn_relu", False):
                # legacy rnn_relu: ReLU on every LSTM layer's output
                # (reference: enc_dec.py:282-283); feed_rnn serves both
                # encoder and decoder (enc_dec.py:288, 304)
                hs = np.maximum(hs, 0.0)
        return hs

    def forward_rnn_encode(self, X, rev_quirk):
        for link in self.rnn_enc + self.rnn_rev_enc + self.rnn_dec:
            link.reset_state()
        T = X.shape[0]
        h_fwd, h_rev = [], []
        for i in range(T):
            h_fwd.append(self.feed_rnn(X[i], self.rnn_enc))
            if self.bi:
                idx = (-i) if rev_quirk else (T - 1 - i)
                h_rev.append(self.feed_rnn(X[idx], self.rnn_rev_enc))
        h_fwd = np.stack(h_fwd)
        if self.bi:
            h_rev = np.stack(h_rev)[::-1]  # F.flipud
            rnn_states = np.concatenate([h_fwd, h_rev], axis=2)
        else:
            rnn_states = h_fwd
        self.enc_states = np.swapaxes(rnn_states, 0, 1)  # (B, T, H)

    def forward_rnn_encode_proj(self, X, train):
        """linear_proj variant: per-layer biLSTM -> Linear+BN+ReLU
        between layers (reference: seq2seq.py:244-291).  Follows
        ast_tpu's documented correction: the reverse stack consumes the
        true reversed sequence (the reference feeds the constant LAST
        frame, enc_states[-1], at every step — seq2seq.py:256)."""
        for link in self.rnn_enc + self.rnn_rev_enc + self.rnn_dec:
            link.reset_state()
        T = X.shape[0]
        seq = X
        n_layers = len(self.rnn_enc)
        for l in range(n_layers):
            self.rnn_enc[l].reset_state()
            if self.bi:
                self.rnn_rev_enc[l].reset_state()
            h_fwd, h_rev = [], []
            for i in range(T):
                h_fwd.append(self.rnn_enc[l](seq[i]))
                if self.bi:
                    h_rev.append(self.rnn_rev_enc[l](seq[T - 1 - i]))
            h_fwd = np.stack(h_fwd)
            if self.bi:
                layer_out = np.concatenate(
                    [h_fwd, np.stack(h_rev)[::-1]], axis=2)
            else:
                layer_out = h_fwd
            if l < n_layers - 1:
                pp = self.p["enc"]["proj"][l]
                ps = self.s["enc_proj_bn"][l]
                flat = layer_out.reshape(-1, layer_out.shape[-1])
                flat = flat @ np.asarray(pp["w"], np.float64) \
                    + np.asarray(pp["b"])
                if train:
                    mean = flat.mean(axis=0)
                    var = flat.var(axis=0)
                else:
                    mean = np.asarray(ps["bn_mean"], np.float64)
                    var = np.asarray(ps["bn_var"], np.float64)
                flat = (flat - mean) / np.sqrt(var + 2e-5)
                flat = flat * np.asarray(pp["bn_gamma"]) \
                    + np.asarray(pp["bn_beta"])
                seq = np.maximum(flat, 0.0).reshape(layer_out.shape)
            else:
                rnn_states = layer_out
        self.enc_states = np.swapaxes(rnn_states, 0, 1)  # (B, T, H)

    def encode(self, X, train, rev_quirk):
        h = self.forward_cnn(X, train)
        if self.rnn_cfg.get("linear_proj", False):
            self.forward_rnn_encode_proj(h, train)
        else:
            self.forward_rnn_encode(h, rev_quirk)

    def init_decoder_state(self):
        for enc, rev, dec in zip(
                self.rnn_enc,
                self.rnn_rev_enc if self.bi else self.rnn_enc,
                self.rnn_dec):
            if self.bi:
                h = np.concatenate([enc.h, rev.h], axis=1)
                c = np.concatenate([enc.c, rev.c], axis=1)
            else:
                h, c = enc.h, enc.c
            dec.set_state(c, h)

    # -- attention + decode step (reference: seq2seq.py:336-396) ------------

    def compute_context_vector(self, dec_h, wa):
        ht = dec_h @ np.asarray(wa["w"], np.float64) + np.asarray(wa["b"])
        weights = np.einsum("bth,bh->bt", self.enc_states, ht)
        e = np.exp(weights - weights.max(axis=1, keepdims=True))
        alphas = e / e.sum(axis=1, keepdims=True)
        cv = np.einsum("bth,bt->bh", self.enc_states, alphas)
        return cv, alphas

    def decode_step(self, word, ht):
        emb = np.asarray(self.p["dec"]["embed"], np.float64)[word]
        if self.rnn_cfg.get("feed_attn", True):
            rnn_in = np.concatenate([emb, ht], axis=1)
        else:
            rnn_in = emb
        h = self.feed_rnn(rnn_in, self.rnn_dec)
        cvs = []
        alphas0 = None
        for i, wa in enumerate(self.p["attn"]["wa"]):
            cv, alphas = self.compute_context_vector(h, wa)
            cvs.append(cv)
            if i == 0:
                alphas0 = alphas
        cv_hdec = np.concatenate(cvs + [h], axis=1)
        ctx = self.p["attn"]["context"]
        ht = np.tanh(cv_hdec @ np.asarray(ctx["w"], np.float64)
                     + np.asarray(ctx["b"]))
        logits = (ht @ np.asarray(self.p["dec"]["out_w"], np.float64)
                  + np.asarray(self.p["dec"]["out_b"]))
        return logits, ht, alphas0

    # -- loss (reference: seq2seq.py:399-473) -------------------------------

    def forward_loss(self, X, y, teach_ratio, train=False, rev_quirk=False,
                     gaps=None):
        """teach_ratio must be 1.0 or 0.0 (deterministic coin).  ``gaps``:
        a list that receives each step's (B,) top-2 logit gap."""
        assert teach_ratio in (1.0, 0.0)
        B = X.shape[0]
        self.encode(X, train, rev_quirk)
        self.init_decoder_state()
        yT = np.asarray(y).T  # (U, B)
        U = yT.shape[0]
        a_units = self.rnn_cfg["attn_units"]
        ht = np.zeros((B, a_units))
        loss = 0.0
        decoder_input = yT[0]
        for i in range(U - 1):
            curr_word, next_word = yT[i], yT[i + 1]
            forced = not (0 < i < U - 2)
            if forced or teach_ratio == 1.0:
                decoder_input = curr_word
            logits, ht, _ = self.decode_step(decoder_input, ht)
            if gaps is not None:
                gaps.append(top2_gap(logits))
            decoder_input = np.argmax(logits, axis=1)
            # softmax CE, class_weight zeroing PAD, normalize=True (mean
            # over the batch)
            logp = logits - logits.max(axis=1, keepdims=True)
            logp = logp - np.log(np.exp(logp).sum(axis=1, keepdims=True))
            nll = -logp[np.arange(B), next_word]
            w = (next_word != 0).astype(np.float64)
            loss += (nll * w).sum() / B
        return loss

    # -- greedy predict (reference: seq2seq.py:475-527) ---------------------

    def predict(self, X, start_token, end_token, stop_limit,
                rev_quirk=False, gaps=None):
        """Greedy decode; ``gaps`` as in ``forward_loss``."""
        B = X.shape[0]
        self.encode(X, False, rev_quirk)
        self.init_decoder_state()
        ht = np.zeros((B, self.rnn_cfg["attn_units"]))
        curr = np.full((B,), start_token, np.int64)
        all_eos = np.zeros((B,), bool)
        sents = []
        for _ in range(stop_limit):
            logits, ht, _ = self.decode_step(curr, ht)
            if gaps is not None:
                gaps.append(top2_gap(logits))
            pred = np.argmax(logits, axis=1)
            sents.append(pred)
            curr = pred
            all_eos |= pred == end_token
            if all_eos.all():
                break
        return np.stack(sents).T  # (B, n_steps)
