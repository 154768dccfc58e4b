#!/usr/bin/env python
"""Smoke run of the shipped entry points on one GPU, in one process.

    python chip_smoke.py            # every one-card phase, on one GPU
    python chip_smoke.py --four     # the four-card data/model-parallel
                                    # phase only, on four GPUs

Phases (each prints its wall time and the XLA compile time it spent):

1. device -- JAX's devices must be GPUs; prints the card's name and power
   limit (``nvidia-smi``), the JAX version, ``XLA_FLAGS``, the compile
   cache directory and the arithmetic of a default-precision float32
   matmul (float32 or TF32).
2. parity -- the es_en_20h model at full width (one fixed batch, B=4,
   T=640 frames, U=48) against the NumPy oracle of the reference model
   (``tests/reference_oracle.py``): forward loss at teacher ratio 1.0 and
   0.0 and greedy tokens, at "highest" matmul precision, at the default
   precision and with bfloat16 compute.
3. train -- ``train.py -m <exp> -e 2`` on a synthetic corpus with the
   shortest, a middle and the longest es_en_20h bucket shape, once with
   the recipe's ``train_cfg`` (B=32, float32) and once with the
   recommended extras (bfloat16, device feature cache, 4 steps per
   dispatch); then per-shape warm step times and the longest shape's
   memory analysis.
4. beam -- ``beam.py -n 5 -k 5 -w 0.6`` over the dev split, and beam
   N=K=1 against greedy on one batch.
5. serve -- ``cli/export_model`` (default platforms) and
   ``cli/serve.make_server`` in process: four ``/decode`` requests and one
   ``/decode_batch``, whose texts must equal an in-process decode.  On a
   host without ``flatbuffers`` (jax.export's file format needs it) the
   phase prints ``serve: HELD`` and checks the exported programs in
   process instead.

``--four`` runs ``NN.train_epoch`` at full width on a ``data=4`` mesh and
on a ``data=2, model=2`` mesh against a one-card run of the same batches.

Weights are random (from ``--seed``) and data is synthetic; nothing is
read from outside the checkout.  Generated data goes to
``<checkout>/.bench_data/chip_smoke``.  Any failure exits non-zero; the
last line of a passing run is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
There is no CPU fallback: on a host without a GPU the script stops at
the device phase.  The phase functions take a ``Sizes`` so that tests
can run them at a tiny width on the CPU.
"""

import argparse
import contextlib
import copy
import dataclasses
import importlib.util
import json
import os
import shutil
import sys
import threading
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".bench_data", "chip_smoke")
RECIPE = os.path.join(REPO, "experiments", "es_en_20h")

# loss relative-error bounds against the float64 oracle, teacher-forced
# ("teacher") and fed the model's own argmax ("argmax_fed"; None: not
# gated).  "highest" is float32 arithmetic throughout.  The default and
# bf16 bounds lie between the reading of that setting on an H100 and the
# reading of the next coarser arithmetic, so a silent drop to it fails
# (PERF.md section 2 lists the readings).  Under bf16 the argmax-fed chain
# leaves the oracle's at clear steps, so its loss is reported only.
PARITY_BOUNDS = {
    "highest": {"teacher": 1e-4, "argmax_fed": 1e-4},
    "default": {"teacher": 5e-6, "argmax_fed": 1e-4},
    "bf16": {"teacher": 1e-4, "argmax_fed": None},
}
# settings whose greedy tokens must follow the oracle's, bar a near-tie
TOKEN_EXACT = ("highest", "default")
# a greedy or argmax-fed token may differ from the oracle's only at a
# step whose two best logits are closer than this
NEAR_TIE = 1e-4
# the output projection is scaled up so the random model's logits spread
# (std ~1 instead of ~0.04): argmax ties then are rare, and a token
# comparison means something
LOGIT_SPREAD = 32.0
# per-step loss agreement of the four-card layouts with one card, all at
# "highest" precision: only the order of the cross-device sums differs
FOUR_CARD_RTOL = 1e-3
# decode mode of each of the serve phase's four single-utterance requests
SERVE_MODES = ("greedy", "greedy", "beam", "beam")


@dataclasses.dataclass
class Sizes:
    """How large each phase runs.  ``FULL`` is what the script runs."""
    mcfg: dict                       # model_cfg.json content
    parity: tuple = (4, 640, 48)     # B, T frames, U target steps
    buckets: tuple = (0, 7, 19)      # EPOCH_BUCKETS ids: T=80, 640, 1680
    utts_per_bucket: int = 128       # 4 batches of 32 per bucket
    batch: int = 32
    steps_per_dispatch: int = 4
    serve_batch: int = 4
    four_bucket: int = 7             # T=640 for the four-card phase
    four_epochs: int = 3             # one step each


def full_sizes():
    with open(os.path.join(RECIPE, "model_cfg.json")) as f:
        return Sizes(mcfg=json.load(f))


class Log:
    """Prints phase lines and keeps the phase timing summary."""

    def __init__(self):
        self.compile_s = 0.0
        self.phases = []

    def __call__(self, *parts):
        print(*parts, flush=True)

    def on_event(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.compile_s += duration

    @contextlib.contextmanager
    def phase(self, name):
        self(f"== {name}")
        t0, c0 = time.perf_counter(), self.compile_s
        yield
        wall, comp = time.perf_counter() - t0, self.compile_s - c0
        self.phases.append((name, wall, comp))
        self(f"== {name} ok: wall {wall:.1f} s, compile {comp:.1f} s")


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device(log, require=True):
    """Check JAX's devices and print what the numbers below ran on."""
    import jax

    from ast_tpu.utils.compile_cache import enable_compile_cache
    from ast_tpu.utils.device import device_info, nvidia_smi, require_gpu

    info = require_gpu() if require else device_info()
    log(f"jax {jax.__version__}: {info['count']} x {info['kind']} "
        f"({info['platform']})")
    if info["platform"] == "gpu":
        raw, cards = nvidia_smi()
        log(f"nvidia-smi: {raw}")
        info["gpu"] = cards[0]
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {enable_compile_cache()}")
    errs = matmul_precision()
    log("float32 matmul (1024^3) max rel err vs float64: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f"; the default precision is {precision_class(errs['default'])}")
    return info


def matmul_precision(n=1024, seed=0):
    """Max relative error of an (n x n) float32 matmul on the device
    against float64, at JAX's default matmul precision and at
    "highest"."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(seed)
    a, b = rng.randn(2, n, n).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    errs = {}
    for name in ("default", "highest"):
        ctx = (jax.default_matmul_precision(name) if name == "highest"
               else contextlib.nullcontext())
        with ctx:
            got = np.asarray(jax.jit(jnp.matmul)(a, b))
        errs[name] = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    return errs


def precision_class(err):
    """Name the arithmetic a matmul error of ``matmul_precision`` points
    to: inputs rounded to TF32's 10 mantissa bits give ~1e-4 at n=1024,
    float32's 23 bits ~1e-7."""
    return "float32" if err < 1e-5 else "TF32 or coarser"


# ---------------------------------------------------------------------------
# 2. parity
# ---------------------------------------------------------------------------

def parity_setup(sizes, seed):
    """Deterministic full-width model (dropout off) and one fixed batch
    with rows of different target lengths."""
    import jax

    from ast_tpu.models import seq2seq
    from ast_tpu.symbols import SYMBOLS

    mcfg = copy.deepcopy(sizes.mcfg)
    V = 1098
    mcfg["rnn_config"]["dec_vocab_size"] = V
    mcfg["dropout"] = {"embed": 0, "rnn": 0, "out": 0}
    params, state = seq2seq.init_model(jax.random.PRNGKey(seed), mcfg)
    params["dec"]["out_w"] = params["dec"]["out_w"] * LOGIT_SPREAD
    B, T, U = sizes.parity
    rng = np.random.RandomState(seed)
    X = rng.randn(B, T, 13).astype(np.float32)
    y = np.zeros((B, U), np.int32)
    for b in range(B):
        n = max(1, U - 2 - 5 * b)
        y[b, 0] = SYMBOLS.GO_ID
        y[b, 1:1 + n] = rng.randint(SYMBOLS.N_SPECIAL, V, n)
        y[b, 1 + n] = SYMBOLS.EOS_ID
    return mcfg, params, state, X, y


def token_mismatches(got, want, gaps, eos_id):
    """Rows whose tokens differ from the oracle's before its first EOS.

    Returns (hard, ties): ``hard`` = [(row, step)] of first divergences at
    a clear argmax; ``ties`` = those at a near-tie (gap < NEAR_TIE), which
    a change in the last bits may flip."""
    hard, ties = [], []
    for b in range(want.shape[0]):
        w = list(want[b])
        if eos_id in w:
            w = w[:w.index(eos_id) + 1]
        g = list(got[b][:len(w)])
        d = next((i for i, (a, c) in enumerate(zip(g, w)) if a != c), None)
        if d is None:
            continue
        (ties if gaps[d][b] < NEAR_TIE else hard).append((b, d))
    return hard, ties


def phase_parity(sizes, log, seed=0, settings=tuple(PARITY_BOUNDS)):
    """Forward loss and greedy tokens against the NumPy oracle at each
    arithmetic setting of ``settings`` (keys of PARITY_BOUNDS); returns
    {setting: {metric: value}}."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from reference_oracle import ReferenceOracle

    from ast_tpu.models import seq2seq
    from ast_tpu.symbols import SYMBOLS

    mcfg, params, state, X, y = parity_setup(sizes, seed)
    B, T, U = sizes.parity
    stop = U
    oracle = ReferenceOracle(params, state, mcfg)
    t0 = time.perf_counter()
    gaps1, gaps0, gapsg = [], [], []
    want1 = oracle.forward_loss(X, y, 1.0, train=False, gaps=gaps1)
    want0 = oracle.forward_loss(X, y, 0.0, train=True, gaps=gaps0)
    want_tok = oracle.predict(X, SYMBOLS.GO_ID, SYMBOLS.EOS_ID, stop,
                              gaps=gapsg)
    chain_tie = float(np.min(gaps0))
    log(f"oracle (float64, NumPy) in {time.perf_counter() - t0:.1f} s: "
        f"loss@1.0={want1:.6f} loss@0.0={want0:.6f}; smallest top-2 "
        f"logit gap on the argmax-fed chain {chain_tie:.2e}, in greedy "
        f"{float(np.min(gapsg)):.2e}")

    key = jax.random.PRNGKey(0)
    results = {}
    for name in settings:
        dtype = jnp.bfloat16 if name == "bf16" else jnp.float32
        ctx = (jax.default_matmul_precision(name) if name == "highest"
               else contextlib.nullcontext())
        with ctx:
            def loss(p, s, X, y, ratio, train, dtype=dtype):
                return seq2seq.forward_loss(
                    p, s, mcfg, X, y, key, train=train, teach_ratio=ratio,
                    compute_dtype=dtype)[0]

            loss = jax.jit(loss, static_argnums=(4, 5))
            greedy = jax.jit(lambda p, s, X, dtype=dtype:
                             seq2seq.predict_greedy(p, s, mcfg, X, stop,
                                                    dtype)[0])
            got1 = float(loss(params, state, X, y, 1.0, False))
            got0 = float(loss(params, state, X, y, 0.0, True))
            toks = np.asarray(greedy(params, state, X))
        err1 = abs(got1 - want1) / abs(want1)
        err0 = abs(got0 - want0) / abs(want0)
        hard, ties = token_mismatches(toks, want_tok, gapsg,
                                      SYMBOLS.EOS_ID)
        results[name] = {"loss_rel_err_teacher": err1,
                         "loss_rel_err_argmax_fed": err0,
                         "greedy_rows_diverged": len(hard) + len(ties)}
        bounds = PARITY_BOUNDS[name]
        log(f"parity[{name}]: loss@1.0 rel err {err1:.2e} "
            f"(bound {bounds['teacher']:.0e}), loss@0.0 rel err {err0:.2e} "
            f"(bound {bounds['argmax_fed'] or 'none'}), greedy rows "
            f"diverged {len(hard)} clear + {len(ties)} at near-ties {ties}")
        if not err1 <= bounds["teacher"]:
            raise AssertionError(
                f"parity[{name}]: teacher-forced loss rel err {err1:.2e} "
                f"> {bounds['teacher']:.0e}")
        # a near-tie on the oracle's argmax-fed chain may flip a token
        # and take the chain elsewhere; only a chain without one is gated
        if (bounds["argmax_fed"] and chain_tie >= NEAR_TIE
                and not err0 <= bounds["argmax_fed"]):
            raise AssertionError(
                f"parity[{name}]: argmax-fed loss rel err {err0:.2e} > "
                f"{bounds['argmax_fed']:.0e}")
        if name in TOKEN_EXACT and hard:
            raise AssertionError(
                f"parity[{name}]: greedy tokens diverge from the oracle "
                f"at clear argmax steps (row, step): {hard}")
    return results


# ---------------------------------------------------------------------------
# 3. train
# ---------------------------------------------------------------------------

def _syn_corpus(sizes, root, log, buckets=None, utts=None):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from trainer_epoch_bench import build_corpus

    return build_corpus(root, log=log,
                        buckets=list(buckets or sizes.buckets),
                        utts_per_bucket=utts or sizes.utts_per_bucket)


def write_recipe_config(sizes, root, name, extras, parallel=None):
    """An experiment dir for the synthetic corpus under ``root`` whose
    ``train_cfg.json`` is the es_en_20h recipe's, with only the data
    location, the batch size and ``extras`` changed (the synthetic refs
    hold one reference per utterance, so ``n_evals`` is 1)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from trainer_epoch_bench import write_configs

    exp = write_configs(root, sizes.batch, 1, mcfg=sizes.mcfg,
                        exp_name=name)
    cfg_path = os.path.join(exp, "train_cfg.json")
    with open(cfg_path) as f:
        syn = json.load(f)
    with open(os.path.join(RECIPE, "train_cfg.json")) as f:
        cfg = json.load(f)
    for k in ("enc_key", "dec_key", "speech_path", "map_path",
              "vocab_path", "info_path", "refs_path"):
        cfg["data"][k] = syn["data"][k]
    cfg["data"]["n_evals"] = 1
    cfg.update(train_set=syn["train_set"], dev_set=syn["dev_set"],
               batch_size=sizes.batch)
    cfg["extras"].update(extras)
    if parallel is not None:
        cfg["parallel"] = parallel
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=1)
    return exp


class StepClock:
    """Wraps a jitted train step: blocks on each call and records its
    time per input shape (frames); ``memory()`` compiles the step for the
    longest shape it saw and returns its memory analysis."""

    def __init__(self, fn):
        self.fn = fn
        self.times = {}
        self.longest = (0, None)        # (frames, abstract args)

    def __call__(self, *args):
        import jax

        frames = _frames_of(args[3])
        if frames > self.longest[0]:
            # abstract args; single-device placements stay uncommitted
            self.longest = (frames, jax.tree.map(
                lambda a: jax.ShapeDtypeStruct(
                    a.shape, a.dtype,
                    sharding=a.sharding
                    if len(a.sharding.device_set) > 1 else None)
                if isinstance(a, jax.Array) else a, args))
        t0 = time.perf_counter()
        out = jax.block_until_ready(self.fn(*args))
        self.times.setdefault(frames, []).append(time.perf_counter() - t0)
        return out

    def memory(self):
        return self.fn.lower(*self.longest[1]).compile().memory_analysis()


def _frames_of(X):
    """Frame count of a train-step input: a feature block (..., T, D) or
    a device-cache triple (cache, rows, mask (..., T))."""
    if isinstance(X, tuple):
        return int(X[2].shape[-1])
    return int(X.shape[-2])


def _timed_epochs(exp, set_key, n_epochs, mesh=None):
    """Train ``n_epochs`` more epochs of ``exp`` through a StepClock;
    returns (clock, [epoch losses], nn)."""
    from ast_tpu.train.trainer import NN

    nn = NN(exp, mesh=mesh)
    multi = nn._train_multi_step is not None
    clock = StepClock(nn._train_multi_step if multi else nn._train_step)
    if multi:
        nn._train_multi_step = clock
    else:
        nn._train_step = clock
    start = nn.max_epoch + 1
    losses = [nn.train_epoch(set_key, epoch=e)
              for e in range(start, start + n_epochs)]
    return clock, losses, nn


def _read_log(path):
    with open(path) as f:
        return [tuple(float(v) for v in line.split(","))
                for line in f if line.strip()]


def train_configs(sizes, compute_dtype="bfloat16"):
    """The two training configurations: the recipe's own, and the
    recommended extras on top of it."""
    return {
        "recipe_f32": {"compute_dtype": "float32"},
        "bf16_cache_g4": {"compute_dtype": compute_dtype, "hbm_cache": True,
                          "steps_per_dispatch": sizes.steps_per_dispatch},
    }


def phase_train(sizes, root, log, configs=None):
    """Two epochs through the train CLI for each configuration (default
    ``train_configs``); returns {config name: experiment dir}."""
    import jax

    from ast_tpu.cli import train as train_cli

    n = _syn_corpus(sizes, root, log)
    configs = configs or train_configs(sizes)
    exps = {}
    for name, extras in configs.items():
        exp = write_recipe_config(sizes, root, name, extras)
        for f in os.listdir(exp):             # a rerun starts afresh
            if f not in ("train_cfg.json", "model_cfg.json"):
                p = os.path.join(exp, f)
                shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)
        t0 = time.perf_counter()
        train_cli.main(["-m", exp, "-e", "2"])
        wall = time.perf_counter() - t0
        rows = _read_log(os.path.join(exp, "train.log"))
        losses = [r[1] for r in rows]
        dev = _read_log(os.path.join(exp, "dev.log"))
        log(f"train[{name}]: {n} utts x 2 epochs in {wall:.1f} s, "
            f"train.log losses {losses}, dev.log BLEU {[r[1] for r in dev]}")
        if len(losses) != 2 or not np.all(np.isfinite(losses)):
            raise AssertionError(f"train[{name}]: bad train.log {rows}")
        if not losses[1] < losses[0]:
            raise AssertionError(
                f"train[{name}]: loss did not fall: {losses}")
        if len(dev) != 2:
            raise AssertionError(f"train[{name}]: dev.log rows {dev}")

        clock, more, _ = _timed_epochs(exp, "syn_train", 2)
        warm = {T: float(np.median(v[1:] if len(v) > 1 else v))
                for T, v in sorted(clock.times.items())}
        per = "per dispatch of %d steps" % sizes.steps_per_dispatch \
            if extras.get("steps_per_dispatch", 1) > 1 else "per step"
        log(f"train[{name}]: warm step time {per} by frames: "
            + ", ".join(f"T={T}: {s * 1e3:.1f} ms" for T, s in warm.items())
            + f" (epochs 3-4 losses {[round(v, 4) for v in more]})")
        mem = clock.memory()
        log(f"train[{name}]: T={clock.longest[0]} step memory_analysis: "
            f"arguments {mem.argument_size_in_bytes / 2**20:.1f} MiB, "
            f"outputs {mem.output_size_in_bytes / 2**20:.1f} MiB, "
            f"temporaries {mem.temp_size_in_bytes / 2**20:.1f} MiB, "
            f"aliased {mem.alias_size_in_bytes / 2**20:.1f} MiB, "
            f"code {mem.generated_code_size_in_bytes / 2**20:.1f} MiB")
        stats = jax.devices()[0].memory_stats() or {}
        peak = stats.get("peak_bytes_in_use")
        log(f"train[{name}]: device peak_bytes_in_use "
            + (f"{peak / 2**30:.2f} GiB" if peak else "not reported"))
        exps[name] = exp
    return exps


# ---------------------------------------------------------------------------
# 4. beam
# ---------------------------------------------------------------------------

def phase_beam(exp, log):
    """beam.py 5,5 over the dev split, and beam 1,1 == greedy."""
    import jax

    from ast_tpu.cli import beam as beam_cli
    from ast_tpu.ops.beam import make_beam_decoder
    from ast_tpu.symbols import SYMBOLS
    from ast_tpu.train.trainer import NN

    bleu = beam_cli.main(["-m", exp, "-n", "5", "-k", "5", "-s", "syn_dev",
                          "-w", "0.6"])
    for f in ("syn_dev_beam_N-5_K-5.p", "syn_dev_beam_N-5_K-5_W-0.60.en"):
        if not os.path.getsize(os.path.join(exp, f)):
            raise AssertionError(f"beam: {f} is empty")
    log(f"beam: N=5 K=5 W=0.6 over syn_dev, BLEU {bleu:.2f}")

    nn = NN(exp)
    batch = next(nn.data_loader.get_batch(
        nn.cfg.train["batch_size"], "syn_dev", train=False, labels=False))
    X = jax.device_put(batch["X"])
    stop = nn.cfg.train["data"]["max_pred"]
    greedy = np.asarray(nn._predict_step(nn.params, nn.state, X))
    hyps, _, lengths = (np.asarray(a) for a in make_beam_decoder(
        nn.mcfg, 1, 1, stop, nn.compute_dtype)(nn.params, nn.state, X))
    for b in range(len(batch["utts"])):
        L = int(lengths[b, 0])
        beam_toks = hyps[b, 0, 1:L].tolist()          # drop GO
        if beam_toks != greedy[b, :L - 1].tolist():
            raise AssertionError(
                f"beam N=K=1 != greedy on row {b}: {beam_toks} vs "
                f"{greedy[b, :L - 1].tolist()}")
        if L - 1 < stop and beam_toks[-1] != SYMBOLS.EOS_ID:
            raise AssertionError(f"beam N=K=1 row {b} ends without EOS")
    log(f"beam: N=K=1 == greedy on {len(batch['utts'])} utterances")


# ---------------------------------------------------------------------------
# 5. serve
# ---------------------------------------------------------------------------

def _post(base, path, body):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.load(r)


def can_serialize():
    """True when ``jax.export`` can write and read artifact files: its
    serialization needs the ``flatbuffers`` package."""
    return importlib.util.find_spec("flatbuffers") is not None


def decode_texts(decode, vocab, dec_key, xs, frames, batch, mode, w=0.6):
    """Decode ``xs`` in zero-padded (batch, frames) blocks with
    ``decode[mode]`` (greedy: X -> preds; beam 5,5: X -> (hyps, scores,
    lengths)), and detokenize as the server does."""
    if len(xs) > batch:
        return [t for c in range(0, len(xs), batch)
                for t in decode_texts(decode, vocab, dec_key,
                                      xs[c:c + batch], frames, batch, mode,
                                      w)]
    import jax

    from ast_tpu.cli.serve import _detok
    from ast_tpu.ops.beam import rerank_hypothesis
    from ast_tpu.symbols import SYMBOLS

    X = np.zeros((batch, frames, xs[0].shape[1]), np.float32)
    for i, x in enumerate(xs):
        X[i, :min(frames, len(x))] = x[:frames]
    X = jax.device_put(X)
    out = []
    if mode == "greedy":
        preds = np.asarray(decode["greedy"](X))
        for i in range(len(xs)):
            row = preds[i]
            eos = np.nonzero(row == SYMBOLS.EOS_ID)[0]
            ids = [int(t) for t in (row[:eos[0]] if eos.size else row)]
            out.append(_detok(ids, vocab, dec_key))
        return out
    hyps, scores, lengths = (np.asarray(a) for a in decode["beam"](X))
    for i in range(len(xs)):
        entries = [(hyps[i, n, :int(lengths[i, n])].tolist(),
                    float(scores[i, n])) for n in range(hyps.shape[1])]
        best = [int(t) for t in rerank_hypothesis(entries, w)[0][0]]
        if best and best[0] == SYMBOLS.GO_ID:
            best = best[1:]
        if best and best[-1] == SYMBOLS.EOS_ID:
            best = best[:-1]
        out.append(_detok(best, vocab, dec_key))
    return out


def model_decoders(nn):
    """Greedy and beam 5,5 with the model in process."""
    from ast_tpu.ops.beam import make_beam_decoder

    beam = make_beam_decoder(nn.mcfg, 5, 5, nn.cfg.train["data"]["max_pred"],
                             nn.compute_dtype)
    return {"greedy": lambda X: nn._predict_step(nn.params, nn.state, X),
            "beam": lambda X: beam(nn.params, nn.state, X)}


def exported_decoders(nn, batch, frames):
    """Greedy and beam 5,5 exported as ``cli/export_model`` exports them
    (default platforms), run in process without a file round trip."""
    from ast_tpu import serving

    stop = int(nn.cfg.train["data"]["max_pred"])
    greedy = serving.LoadedArtifact(serving.export_greedy(
        nn.params, nn.state, nn.mcfg, batch, frames, stop,
        nn.compute_dtype))
    beam = serving.LoadedArtifact(serving.export_beam(
        nn.params, nn.state, nn.mcfg, batch, frames, 5, 5, stop,
        nn.compute_dtype))
    return {"greedy": lambda X: greedy.call(X)[0], "beam": beam.call}


def _serve_http(sizes, exp, xs, frames, log):
    """Export through ``cli/export_model``, serve through
    ``cli/serve.make_server`` in process; returns the texts of four
    ``/decode`` requests (2 greedy, 2 beam) and of one greedy
    ``/decode_batch``."""
    from ast_tpu.cli import export_model, serve

    out_dir = export_model.main(
        ["-m", exp, "--batch", str(sizes.serve_batch), "--frames",
         str(frames), "--beam", "5,5", "-o",
         os.path.join(exp, "serving")])
    with open(os.path.join(out_dir, "manifest.json")) as f:
        manifest = json.load(f)
    plats = {tuple(e["platforms"]) for e in manifest["entries"]}
    log(f"serve: exported {len(manifest['entries'])} artifacts for "
        f"platforms {sorted(plats)}")

    httpd, state = serve.make_server(out_dir, port=0, warmup=True)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        t0 = time.perf_counter()
        while not state.ready:
            if state.warm_error:
                raise RuntimeError(f"serve warmup failed: "
                                   f"{state.warm_error}")
            if time.perf_counter() - t0 > 900:
                raise TimeoutError("serve warmup did not finish")
            time.sleep(0.2)
        log(f"serve: warm in {time.perf_counter() - t0:.1f} s on "
            f"{[str(d) for d in state.devices]}")
        single = [_post(base, "/decode", {"features": x.tolist(),
                                          "mode": SERVE_MODES[i],
                                          "w": 0.6})["text"]
                  for i, x in enumerate(xs)]
        batch = _post(base, "/decode_batch",
                      {"batch": [{"features": x.tolist()} for x in xs],
                       "mode": "greedy"})["results"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    return single, [r.get("text") for r in batch]


def phase_serve(sizes, exp, log):
    """Greedy + beam 5,5 artifacts at the default export platforms, served
    over HTTP in process; the texts must equal an in-process decode.

    Without the ``flatbuffers`` package, artifact files can be neither
    written nor read, so ``cli/export_model`` and ``cli/serve`` cannot
    run: the phase then says so and runs the exported programs in
    process instead."""
    from ast_tpu.train.trainer import NN

    nn = NN(exp)
    data = nn.cfg.train["data"]
    dev_dir = os.path.join(data["speech_path"], "syn_dev")
    names = sorted(os.listdir(dev_dir))[:4]
    xs = [np.load(os.path.join(dev_dir, f)) for f in names]
    frames = 80 * -(-max(len(x) for x in xs) // 80)
    vocab = {str(int(i)): (w.decode() if isinstance(w, bytes) else w)
             for i, w in nn.data_loader.dec_i2w.items()}

    def texts(decode):
        single = [decode_texts(decode, vocab, data["dec_key"], [x], frames,
                               sizes.serve_batch, SERVE_MODES[i])[0]
                  for i, x in enumerate(xs)]
        batch = decode_texts(decode, vocab, data["dec_key"], xs, frames,
                             sizes.serve_batch, "greedy")
        return single, batch

    if can_serialize():
        how = "HTTP: 4 /decode (2 greedy, 2 beam) + 1 /decode_batch"
        got = _serve_http(sizes, exp, xs, frames, log)
    else:
        log("serve: HELD: jax.export serialization needs the flatbuffers "
            "package, which this host lacks, so cli/export_model and "
            "cli/serve cannot run here; running the exported programs in "
            "process instead")
        how = "exported programs in process (no artifact file, no HTTP)"
        got = texts(exported_decoders(nn, sizes.serve_batch, frames))
    want = texts(model_decoders(nn))
    for i, (text, ref) in enumerate(zip(got[0], want[0])):
        if text != ref:
            raise AssertionError(f"serve {SERVE_MODES[i]} utt {i}: "
                                 f"{text!r} != in-process {ref!r}")
    for i, (text, ref) in enumerate(zip(got[1], want[1])):
        if text != ref:
            raise AssertionError(f"serve batch utt {i}: {text!r} != "
                                 f"in-process {ref!r}")
    log(f"serve: {how} of {len(xs)} utterances == in-process decode; "
        f"e.g. {got[0][0][:60]!r}")
    return how


# ---------------------------------------------------------------------------
# 6. four cards
# ---------------------------------------------------------------------------

def phase_four(sizes, root, log, n_devices=4):
    """NN.train_epoch on data=4 and data=2,model=2 meshes vs one card,
    same batches, same seed; each epoch is one step."""
    import jax

    from ast_tpu.parallel.mesh import make_mesh

    devices = jax.devices()
    if len(devices) < n_devices:
        raise RuntimeError(f"--four needs {n_devices} devices, JAX sees "
                           f"{len(devices)}")
    _syn_corpus(sizes, root, log, buckets=(sizes.four_bucket,),
                utts=sizes.batch)
    exp = write_recipe_config(sizes, root, "four",
                              {"compute_dtype": "float32"},
                              parallel={"data_axis": 1, "model_axis": 1})
    half = n_devices // 2
    layouts = [
        ("1 card", None),
        (f"data={n_devices}", make_mesh(
            {"data_axis": n_devices, "model_axis": 1},
            devices=devices[:n_devices])),
        (f"data={half},model=2", make_mesh(
            {"data_axis": half, "model_axis": 2},
            devices=devices[:n_devices])),
    ]
    losses = {}
    with jax.default_matmul_precision("highest"):
        for name, mesh in layouts:
            clock, ls, _ = _timed_epochs(exp, "syn_train", sizes.four_epochs,
                                         mesh=mesh)
            losses[name] = ls
            T, times = clock.longest[0], clock.times[clock.longest[0]]
            warm = times[1:] or times
            log(f"four[{name}]: mesh "
                f"{dict(mesh.shape) if mesh is not None else '{}'}, "
                f"per-step losses {ls}, warm step "
                f"{float(np.median(warm)) * 1e3:.1f} ms (B={sizes.batch}, "
                f"T={T}, float32 at highest precision)")
    ref = np.asarray(losses["1 card"])
    for name, ls in losses.items():
        rel = np.max(np.abs(np.asarray(ls) - ref) / np.abs(ref))
        log(f"four[{name}]: max per-step loss rel diff vs 1 card "
            f"{rel:.2e} (tolerance {FOUR_CARD_RTOL:.0e})")
        if not rel <= FOUR_CARD_RTOL:
            raise AssertionError(f"four[{name}]: losses {ls} vs 1 card "
                                 f"{ref.tolist()}")


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase (needs 4 GPUs)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(REPO, "ast_tpu")):
        print("chip_smoke.py: the ast_tpu package is not beside this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import jax

    from ast_tpu.utils.device import NoGpuError

    log = Log()
    jax.monitoring.register_event_duration_secs_listener(log.on_event)
    try:
        with log.phase("device"):
            info = phase_device(log)
    except NoGpuError as e:
        print(f"chip_smoke.py: {e}", file=sys.stderr)
        return 2
    sizes = full_sizes()
    os.makedirs(WORK, exist_ok=True)
    if args.four:
        with log.phase("four"):
            phase_four(sizes, os.path.join(WORK, "four"), log)
    else:
        with log.phase("parity"):
            phase_parity(sizes, log, seed=args.seed)
        with log.phase("train"):
            exps = phase_train(sizes, os.path.join(WORK, "one"), log)
        with log.phase("beam"):
            phase_beam(exps["recipe_f32"], log)
        with log.phase("serve"):
            phase_serve(sizes, exps["recipe_f32"], log)
    for name, wall, comp in log.phases:
        log(f"phase {name:7s} wall {wall:7.1f} s  compile {comp:7.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
