"""The plain XLA path (``lax.scan`` encoder and decoder, ``lax.while_loop``
greedy decode, the batched beam frontier) against the NumPy oracle of
the reference model, at the small widths the kernel-parity tests used.

Pins: teacher-forced and argmax-fed loss, gradients against float64
finite differences, dropout keyed by the RNG key alone, the bfloat16
decoder within a stated bound of float32, batch-split invariance of
loss, gradients and decoding, and greedy and beam tokens at several
beam sizes.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ast_tpu.models import seq2seq
from ast_tpu.ops import beam as beam_ops
from ast_tpu.symbols import SYMBOLS
from tests.conftest import TINY_MODEL_CFG
from tests.reference_oracle import ReferenceOracle
from tests.test_beam_oracle import sequential_beam

STOP = 8


def _setup(V=12, seed=0, dropout=0.0, B=3, T=24, U=7):
    """Tiny model (dropout as given) with every leaf perturbed so zero
    biases and BN statistics are exercised, plus one batch whose rows
    have different target lengths."""
    mcfg = copy.deepcopy(TINY_MODEL_CFG)
    mcfg["rnn_config"]["dec_vocab_size"] = V
    mcfg["dropout"] = {"embed": dropout, "rnn": dropout, "out": 0}
    params, state = seq2seq.init_model(jax.random.PRNGKey(seed), mcfg)
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + 0.2 * rng.randn(*a.shape),
                              jnp.float32), params)
    state["cnn_bn"] = [{"bn_mean": jnp.asarray(0.1 * rng.randn(
                            *s["bn_mean"].shape), jnp.float32),
                        "bn_var": jnp.asarray(0.5 + np.abs(rng.randn(
                            *s["bn_var"].shape)), jnp.float32)}
                       for s in state["cnn_bn"]]
    X = rng.randn(B, T, 13).astype(np.float32)
    y = np.zeros((B, U), np.int32)
    for b in range(B):
        n = U - 2 - (b % 3)
        y[b, 0] = SYMBOLS.GO_ID
        y[b, 1:1 + n] = rng.randint(SYMBOLS.N_SPECIAL, V, n)
        y[b, 1 + n] = SYMBOLS.EOS_ID
    return mcfg, params, state, X, y


def _loss(params, state, mcfg, X, y, ratio, n_real=None,
          key=jax.random.PRNGKey(0), train=None, dtype=jnp.float32):
    train = (ratio < 1.0) if train is None else train
    return seq2seq.forward_loss(params, state, mcfg, X, y, key, train=train,
                                n_real=n_real, teach_ratio=ratio,
                                compute_dtype=dtype)[0]


# ---------------------------------------------------------------------------
# loss and greedy tokens against the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V", [12, 24])
@pytest.mark.parametrize("ratio", [1.0, 0.0])
def test_loss_matches_oracle(V, ratio):
    """Teacher-forced (eval-mode BN) and argmax-fed (train-mode BN, no
    dropout or noise) loss equal the float64 oracle's."""
    mcfg, params, state, X, y = _setup(V)
    got = float(_loss(params, state, mcfg, X, y, ratio))
    want = ReferenceOracle(params, state, mcfg).forward_loss(
        X, y, ratio, train=ratio < 1.0)
    assert abs(got - want) / abs(want) <= 1e-5


@pytest.mark.parametrize("V", [12, 24])
def test_greedy_matches_oracle(V):
    mcfg, params, state, X, _ = _setup(V)
    preds = np.asarray(seq2seq.predict_greedy(params, state, mcfg, X,
                                              STOP)[0])
    want = ReferenceOracle(params, state, mcfg).predict(
        X, SYMBOLS.GO_ID, SYMBOLS.EOS_ID, STOP)
    for b in range(X.shape[0]):
        w = list(want[b])
        if SYMBOLS.EOS_ID in w:
            w = w[:w.index(SYMBOLS.EOS_ID) + 1]
        assert preds[b, :len(w)].tolist() == w


# ---------------------------------------------------------------------------
# gradients against float64 finite differences of the oracle
# ---------------------------------------------------------------------------

LEAVES = {
    "cnn0_w": lambda p: p["cnn"][0]["w"],
    "enc0_wx": lambda p: p["enc"]["lstm"][0]["wx"],
    "enc1_wh": lambda p: p["enc"]["lstm"][1]["wh"],
    "dec0_wh": lambda p: p["dec"]["lstm"][0]["wh"],
    "attn_ctx_w": lambda p: p["attn"]["context"]["w"],
    "out_w": lambda p: p["dec"]["out_w"],
}


@pytest.mark.parametrize("ratio", [1.0, 0.0])
@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_grads_match_float64_finite_differences(leaf, ratio):
    """d loss / d w for a few elements of each leaf: the jitted f32
    gradient (highest precision) against central differences of the
    float64 oracle (eps 1e-4: truncation error ~1e-8 relative)."""
    mcfg, params, state, X, y = _setup(12, seed=1)
    train = ratio < 1.0
    with jax.default_matmul_precision("highest"):
        grads = jax.jit(jax.grad(
            lambda p: _loss(p, state, mcfg, X, y, ratio)))(params)
    g = np.asarray(LEAVES[leaf](grads))
    p64 = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    rng = np.random.RandomState(7)
    eps = 1e-4
    for _ in range(3):
        idx = tuple(rng.randint(s) for s in g.shape)
        vals = []
        for sign in (1, -1):
            pp = jax.tree.map(np.copy, p64)
            LEAVES[leaf](pp)[idx] += sign * eps
            vals.append(ReferenceOracle(pp, state, mcfg).forward_loss(
                X, y, ratio, train=train))
        fd = (vals[0] - vals[1]) / (2 * eps)
        assert abs(g[idx] - fd) <= 1e-3 * max(1.0, abs(fd)), \
            (leaf, idx, float(g[idx]), fd)


# ---------------------------------------------------------------------------
# dropout: a function of the key alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["rnn", "embed"])
def test_dropout_reproducible_per_key(which):
    mcfg, params, state, X, y = _setup(12, dropout=0.0)
    mcfg["dropout"][which] = 0.3
    f = jax.jit(lambda k: _loss(params, state, mcfg, X, y, 1.0, key=k,
                                train=True))
    k1, k2 = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
    a, b, c = float(f(k1)), float(f(k1)), float(f(k2))
    assert a == b
    assert a != c


@pytest.mark.parametrize("which", ["rnn", "embed"])
def test_dropout_changes_the_train_loss(which):
    """Rate 0.3 in train mode moves the loss; eval mode ignores it."""
    mcfg, params, state, X, y = _setup(12)
    base_train = float(_loss(params, state, mcfg, X, y, 1.0, train=True))
    base_eval = float(_loss(params, state, mcfg, X, y, 1.0))
    mcfg["dropout"][which] = 0.3
    assert float(_loss(params, state, mcfg, X, y, 1.0,
                       train=True)) != base_train
    assert float(_loss(params, state, mcfg, X, y, 1.0)) == base_eval


# ---------------------------------------------------------------------------
# bfloat16 compute
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V", [12, 24])
def test_bf16_decoder_steps_within_bound_of_f32(V):
    """bf16 matmul operands with f32 accumulation keep 8 mantissa bits
    (~4e-3 relative per product).  Over STOP teacher-forced decoder steps
    from the same f32 encoder states, the logits stay within 3e-2 of
    float32 (max abs error over the max abs logit).  The encoder's
    time-batched bf16 einsum has no XLA:CPU kernel, so the end-to-end
    bf16 loss is checked on the GPU (chip_smoke.py parity phase)."""
    mcfg, params, state, X, y = _setup(V)
    key = jax.random.PRNGKey(0)
    enc, h0, c0, _ = seq2seq.encode(params, state, mcfg, X, key, False)

    def run(dtype):
        carry = seq2seq.init_decoder_carry(mcfg, h0, c0)
        out = []
        for t in range(y.shape[1] - 1):
            logits, carry, _ = seq2seq.decode_step(
                params, mcfg, enc, carry, y[:, t], key, False, dtype)
            out.append(np.asarray(logits, np.float32))
        return np.stack(out)

    a, b = run(jnp.float32), run(jnp.bfloat16)
    assert np.max(np.abs(a - b)) <= 3e-2 * np.max(np.abs(a))
    assert np.max(np.abs(a - b)) > 0        # bf16 really ran


# ---------------------------------------------------------------------------
# batch-split invariance (rows never interact outside train-mode BN)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split", [1, 2, 3])
def test_eval_loss_batch_split_invariant(split):
    """Loss normalized by the whole batch's row count is additive over
    any split of the rows."""
    mcfg, params, state, X, y = _setup(12, B=4)
    whole = float(_loss(params, state, mcfg, X, y, 1.0, n_real=4.0))
    parts = (float(_loss(params, state, mcfg, X[:split], y[:split], 1.0,
                         n_real=4.0))
             + float(_loss(params, state, mcfg, X[split:], y[split:], 1.0,
                           n_real=4.0)))
    assert abs(whole - parts) <= 1e-5 * abs(whole)


def test_eval_grads_batch_split_invariant():
    mcfg, params, state, X, y = _setup(12, B=4)

    def g(Xp, yp):
        return jax.grad(lambda p: _loss(p, state, mcfg, Xp, yp, 1.0,
                                        n_real=4.0))(params)

    whole = g(X, y)
    parts = jax.tree.map(lambda a, b: a + b, g(X[:2], y[:2]),
                         g(X[2:], y[2:]))
    for a, b in zip(jax.tree.leaves(whole), jax.tree.leaves(parts)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("kind", ["greedy", "beam"])
def test_decode_batch_split_invariant(kind):
    mcfg, params, state, X, _ = _setup(12, B=4)
    if kind == "greedy":
        def run(Xp):
            return np.asarray(seq2seq.predict_greedy(params, state, mcfg,
                                                     Xp, STOP)[0])
    else:
        dec = beam_ops.make_beam_decoder(mcfg, 3, 3, STOP)

        def run(Xp):
            return np.asarray(dec(params, state, Xp)[0])
    whole = run(X)
    np.testing.assert_array_equal(
        whole, np.concatenate([run(X[:1]), run(X[1:])]))


# ---------------------------------------------------------------------------
# beam sizes against the sequential reference algorithm
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def beam_model():
    mcfg = copy.deepcopy(TINY_MODEL_CFG)
    mcfg["rnn_config"]["dec_vocab_size"] = 24
    mcfg["dropout"] = {"embed": 0.0, "rnn": 0.0, "out": 0}
    params, state = seq2seq.init_model(jax.random.PRNGKey(44), mcfg)
    # EOS biased up so hypotheses freeze at staggered steps
    params["dec"]["out_b"] = params["dec"]["out_b"].at[
        SYMBOLS.EOS_ID].add(2.0)
    X = jax.random.normal(jax.random.PRNGKey(3), (2, 32, 13)) * 0.5
    return mcfg, params, state, X


@pytest.mark.parametrize("N,K", [(3, 3), (4, 2), (5, 5), (8, 8), (16, 8)])
def test_beam_matches_sequential_reference(beam_model, N, K):
    mcfg, params, state, X = beam_model
    stop = 6
    hyps, scores, lengths = (np.asarray(a) for a in
                             beam_ops.make_beam_decoder(mcfg, N, K, stop)(
                                 params, state, X))
    oracle = ReferenceOracle(params, state, mcfg)
    for b in range(X.shape[0]):
        ref = sequential_beam(oracle, np.asarray(X[b:b + 1]), stop, N, K)
        assert len(ref) == N
        for n in range(N):
            assert hyps[b, n, :lengths[b, n]].tolist() == ref[n][0]
            np.testing.assert_allclose(scores[b, n], ref[n][1],
                                       rtol=1e-4, atol=1e-4)
