"""Training/eval harness — the ``NN`` facade.

Mirrors the reference harness's public surface (reference: nn.py:42-322):
``NN(cfg_path)`` builds config + dataloader + model + optimizer and
auto-resumes from the latest checkpoint; ``train_epoch`` / ``predict`` /
``decode_beam`` drive the jitted step functions.

Internals:
- one jitted train step per duration bucket shape; parameters are donated
  so the optimizer update is in-place in device memory
- batches are host-assembled (numpy) then device_put; a double-buffered
  prefetcher overlaps host assembly + H2D transfer with device compute
- optional data-parallel mesh: batches sharded over the 'data' axis,
  gradient all-reduce inserted by XLA (see ast_tpu.parallel)
- greedy eval and beam decode are fully batched on device
"""

import collections
import math
import os
import queue
import threading

import jax
import jax.numpy as jnp
import numpy as np

from ast_tpu.config import Config
from ast_tpu.data.dataloader import make_dataloader
from ast_tpu.models import seq2seq
from ast_tpu.ops import beam as beam_ops
from ast_tpu.parallel.mesh import make_mesh, shard_batch, replicate
from ast_tpu.symbols import SYMBOLS
from ast_tpu.train.checkpoint import (
    checkpoint_path, latest_checkpoint, load_checkpoint, merge_into,
    save_checkpoint,
)
from ast_tpu.train.optimizer import build_optimizer
from ast_tpu.utils.profiling import StepTimer
from ast_tpu.utils.seeding import stable_seed


def _seed_to_int(seed):
    return stable_seed(seed, bits=31)


class Prefetcher:
    """Pipeline host batch assembly + host->device staging behind
    device compute.

    ``workers`` > 1 runs ``prepare`` (assembly + ``device_put``) from
    that many threads while yielding results in EXACT generator order —
    the epoch's batch order (and so resume/determinism) is unchanged.
    Parallel workers overlap several batches' assembly and transfer.
    The generator itself is pulled under a lock (generators are not
    thread-safe); only ``prepare`` runs concurrently.
    """

    def __init__(self, gen, prepare, depth=2, workers=1):
        self._closed = False
        self._err = None
        self._buf = {}
        self._next_read = 0        # next index to pull from gen
        self._next_yield = 0       # next index the consumer gets
        self._done_reading = False
        self._cond = threading.Condition()
        self._gen = iter(gen)
        self._prepare = prepare
        self._depth = max(int(depth), int(workers))
        self.threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(max(1, int(workers)))]
        for t in self.threads:
            t.start()

    def _worker(self):
        while True:
            with self._cond:
                while (not self._closed and not self._done_reading
                       and (self._next_read - self._next_yield
                            >= self._depth)):
                    self._cond.wait()
                if self._closed or self._done_reading:
                    return
                idx = self._next_read
                try:
                    item = next(self._gen)
                except StopIteration:
                    self._done_reading = True
                    self._cond.notify_all()
                    return
                except BaseException as e:
                    self._err = e
                    self._done_reading = True
                    self._cond.notify_all()
                    return
                self._next_read += 1
            try:
                out = self._prepare(item)
            except BaseException as e:
                out = e
            with self._cond:
                self._buf[idx] = out
                self._cond.notify_all()

    def __iter__(self):
        try:
            while True:
                with self._cond:
                    while (self._next_yield not in self._buf
                           and not (self._done_reading
                                    and self._next_yield
                                    >= self._next_read)
                           and not self._closed):
                        self._cond.wait()
                    if self._closed:
                        return
                    if self._next_yield in self._buf:
                        item = self._buf.pop(self._next_yield)
                        self._next_yield += 1
                        self._cond.notify_all()
                    else:
                        # stream drained; surface a generator error
                        if self._err is not None:
                            err, self._err = self._err, None
                            raise err
                        return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # consumer abandoned the stream (preemption, exception, or
            # early break): unpark the workers so a long-lived embedding
            # of NN doesn't accumulate stuck threads + an unconsumed
            # generator per aborted epoch
            self.close()

    def close(self):
        """Release the workers and drop anything buffered."""
        with self._cond:
            self._closed = True
            self._buf.clear()
            self._cond.notify_all()
        for t in self.threads:
            if t.is_alive():
                t.join(timeout=1.0)


class PreemptedError(RuntimeError):
    """Raised by ``train_epoch`` after writing an inflight snapshot when
    preemption was requested (e.g. SIGTERM from the cluster scheduler).
    The next run resumes the same epoch at the same batch position."""


def _group_stream(gen, G):
    """Chunk a batch stream into runs of consecutive same-bucket batches,
    at most G long (the dataloader's ``group_runs`` ordering makes full
    runs the common case).  Yields lists of 1..G host batches."""
    buf = []
    for b in gen:
        if buf and (b["bucket"] != buf[0]["bucket"]
                    or b.get("rows") != buf[0].get("rows")
                    or len(buf) == G):
            yield buf
            buf = []
        buf.append(b)
    if buf:
        yield buf


class CrossingGate:
    """Fires when a counter CROSSES a multiple of ``every``.

    An exact-modulo check (``consumed % every == 0``) can be stepped
    over indefinitely when the counter advances by variable step sizes
    (grouped runs of 1..G batches, shrunken tail batches), deferring
    the multi-host preemption allgather to the epoch boundary."""

    def __init__(self, every, start=0):
        self.every = max(1, int(every))
        self.last = start // self.every

    def crossed(self, consumed):
        q = consumed // self.every
        if q == self.last:
            return False
        self.last = q
        return True


class NN:
    """Build/load a model + optimizer for one experiment directory."""

    def __init__(self, cfg_path, mesh=None, ckpt=None):
        """``ckpt``: explicit checkpoint path — load exactly this file
        (e.g. a ``copy_params --average`` artifact) instead of the
        auto-resume scan; inflight recovery is skipped too, since an
        explicit checkpoint means "decode/serve from exactly this"."""
        self.cfg = Config(cfg_path)
        self.model_dir = self.cfg.model["model_dir"]
        self.mcfg = self.cfg.model
        tcfg = self.cfg.train

        from ast_tpu.utils.compile_cache import enable_compile_cache
        enable_compile_cache(tcfg["extras"]["compile_cache"])

        self.seed = _seed_to_int(tcfg["seed"])
        self.rng = jax.random.PRNGKey(self.seed)

        self.compute_dtype = (
            jnp.bfloat16
            if tcfg["extras"].get("compute_dtype") == "bfloat16"
            else jnp.float32
        )
        # extras.transfer_dtype: ship train-batch FEATURES to the device
        # narrow (bfloat16/float16) and widen on device — halves the
        # dominant host->device traffic.  Off (float32, bit-exact) by
        # default: CMVN'd features are ~N(0,1) where a 1-step rounding
        # is harmless for training but is NOT bit-identical, so it is an
        # explicit opt-in.  Feature mode only (wav audio is raw input;
        # eval/decode paths always ship f32).
        _tdt = tcfg["extras"].get("transfer_dtype", "float32")
        if _tdt not in ("float32", "bfloat16", "float16"):
            raise ValueError(
                f"extras.transfer_dtype={_tdt!r}: use float32 | "
                "bfloat16 | float16")
        self.transfer_dtype = None if _tdt == "float32" else (
            jnp.bfloat16 if _tdt == "bfloat16" else np.float16)

        self.data_loader = make_dataloader(tcfg, self.model_dir)

        # on-device feature extraction mode: the loader ships raw audio +
        # CMVN stats; MFCC+CMVN run fused inside the jitted step
        self.wav_mode = tcfg["data"].get("features",
                                         "precomputed") == "wav"
        if self.wav_mode:
            from ast_tpu.ops.fbank import MfccExtractor
            self._mfcc = MfccExtractor()

        # extras.hbm_cache: upload each bucket's padded feature matrix
        # to HBM once and assemble train batches by device-side gather
        # (data/device_cache.py) — per-batch wire traffic drops from
        # the feature block to indices+mask+targets.  Bit-identical to
        # host feeding with the default f32 cache;
        # extras.hbm_cache_dtype="bfloat16" halves cache HBM (features
        # round once on upload — not bit-exact, documented opt-in).
        self.hbm_cache = bool(tcfg["extras"].get("hbm_cache", False))
        if self.hbm_cache:
            if self.wav_mode:
                raise ValueError(
                    "extras.hbm_cache needs precomputed features "
                    "(data.features='wav' ships raw audio; the MFCC "
                    "already runs on device in that mode)")
            if getattr(self.data_loader, "text_mode", False):
                raise ValueError("extras.hbm_cache: text-encoder mode "
                                 "has no feature block to cache")
        _cdt = tcfg["extras"].get("hbm_cache_dtype", "float32")
        if _cdt not in ("float32", "bfloat16"):
            raise ValueError(
                f"extras.hbm_cache_dtype={_cdt!r}: float32 | bfloat16")
        self.hbm_cache_dtype = (jnp.bfloat16 if _cdt == "bfloat16"
                                else np.float32)
        self._hbm_caches = {}

        # mesh: data-parallel axis over local devices (1 device => trivial).
        # With legacy per-bucket batch sizes every size must shard evenly,
        # so the divisibility constraint is their gcd.
        bs = tcfg["batch_size"]
        if isinstance(bs, dict):
            sizes = [int(bs[k]) for k in ("max", "med", "min") if k in bs]
            if not sizes:
                raise ValueError(
                    "batch_size dict must carry at least one of "
                    f"'max'/'med'/'min' (got keys {sorted(bs)})")
            bs = math.gcd(*sizes) if len(sizes) > 1 else sizes[0]
        self.mesh = mesh if mesh is not None else make_mesh(
            tcfg.get("parallel", {}), batch_size=bs)

        # params/state, with auto-resume
        self.model_fname = os.path.join(self.model_dir, "seq2seq.model")
        key, self.rng = jax.random.split(self.rng)
        self.params, self.state = seq2seq.init_model(key, self.mcfg)
        self.max_epoch = 0
        explicit_ckpt = ckpt
        if explicit_ckpt is None:
            ckpt, epoch = latest_checkpoint(self.model_dir)
        else:
            ckpt, epoch = explicit_ckpt, 0
        self.opt, self.opt_state = build_optimizer(
            tcfg["optimizer"], self.params, seed=self.seed)
        if ckpt is not None:
            self._load_snapshot(load_checkpoint(ckpt))
            self.max_epoch = epoch
        self.loaded_ckpt = ckpt  # path actually loaded (None = fresh init)

        # mid-epoch crash recovery: prefer a NEWER inflight snapshot
        # (written every ``checkpoint_steps`` batches).  extra = {epoch e,
        # step s}: "epoch e has consumed s batches"; the deterministic
        # per-epoch batch stream (dataloader ``epoch`` arg) lets the
        # resumed run skip exactly those batches.
        self.inflight_resume = None
        inflight = os.path.join(self.model_dir, "seq2seq_inflight.npz")
        if explicit_ckpt is None and os.path.exists(inflight):
            snap = load_checkpoint(inflight)
            extra = snap.get("extra") or {}
            in_epoch = int(extra.get("epoch", 0))
            in_step = int(extra.get("step", 0))
            in_g = int(extra.get("g", 1))
            cfg_g = max(1, int(tcfg["extras"].get("steps_per_dispatch",
                                                  1)))
            if in_epoch >= 1 and in_epoch - 1 >= self.max_epoch:
                self._load_snapshot(snap)
                self.max_epoch = in_epoch - 1
                if in_step > 0 and in_g != cfg_g:
                    # the epoch stream's grouped order depends on
                    # steps_per_dispatch; a position from a different G
                    # indexes a different stream — keep the params but
                    # restart the epoch (some batches train twice,
                    # which is safe; silent mis-skipping is not)
                    print(f"inflight snapshot was written with "
                          f"steps_per_dispatch={in_g} but the config "
                          f"says {cfg_g}; restarting epoch {in_epoch} "
                          f"from the beginning", flush=True)
                elif in_step > 0:
                    self.inflight_resume = (in_epoch, in_step)

        if self.mesh is not None:
            self.params = replicate(self.params, self.mesh)
            self.state = replicate(self.state, self.mesh)
            self.opt_state = replicate(self.opt_state, self.mesh)

        self.train_log = os.path.join(self.model_dir, "train.log")
        self.dev_log = os.path.join(self.model_dir, "dev.log")

        # graceful preemption: request_preempt() (wired to SIGTERM by the
        # train CLI) makes train_epoch snapshot at the next batch
        # boundary and raise PreemptedError — preempted jobs resume
        # mid-epoch instead of losing the epoch
        self._preempt = False

        self._train_step = self._make_train_step()
        # >1: scan this many consecutive same-bucket batches inside one
        # jitted dispatch — identical math to single steps (same per-batch
        # RNG keys), amortizes per-dispatch host overhead
        self.steps_per_dispatch = max(
            1, int(tcfg["extras"].get("steps_per_dispatch", 1)))
        # tail batches pad to a repeated-half of the bucket batch size
        # instead of the full size (dataloader.tail_rows): min_rows keeps
        # every tail shape a multiple of 8 rows per device.  No kernel
        # needs that alignment any more; it stays because it fixes the
        # set of tail batch shapes (and so compiled programs) a config
        # produces.
        if tcfg["extras"].get("shrink_tail_batches", True):
            shards = self.mesh.shape.get("data", 1) \
                if self.mesh is not None else 1
            self.tail_shrink = 8 * shards
        else:
            self.tail_shrink = 0
        self._train_multi_step = (
            self._make_train_step(multi=True)
            if self.steps_per_dispatch > 1 else None)
        self._predict_step = self._make_predict_step()
        self.timer = StepTimer()

    def _load_snapshot(self, loaded):
        """Merge a checkpoint dict into params/state/opt_state.

        Saved leaves follow the TEMPLATE leaf's dtype: checkpoints store
        f32 (``_savable`` upcasts bf16 moments on save), so restoring
        without the cast would hand the donated train dispatch
        f32 moment buffers where the compiled step expects bf16 — a full
        retrace + doubled moment HBM on every bf16-mu resume."""
        self.params = merge_into(self.params, loaded["params"], "params")
        if loaded.get("state") is not None:
            self.state = merge_into(self.state, loaded["state"], "state")
        if loaded.get("opt") is not None:
            try:
                # leaf-order merge: NPZ stores optax tuples as lists,
                # so a structural tree.map would ALWAYS raise here and
                # the except below would silently restart the moments
                # on every resume (caught by
                # test_checkpoint::test_optimizer_state_roundtrips)
                self.opt_state = merge_into(self.opt_state,
                                            loaded["opt"], "opt")
            except ValueError as e:
                # a genuinely different optimizer config: restart
                # moments, but say so
                print(f"warning: optimizer state not restored ({e}); "
                      "restarting moments")

    # ------------------------------------------------------------------
    # jitted steps
    # ------------------------------------------------------------------
    def _make_train_step(self, multi=False):
        tcfg = self.cfg.train
        extras = tcfg["extras"]
        mcfg = self.mcfg
        opt = self.opt
        compute_dtype = self.compute_dtype

        featurize = self._featurize if self.wav_mode else None

        # data.spec_augment: in-graph time/freq masking on the feature
        # block, train-path only (eval_loss/predict build their own
        # steps).  Statically gated: when absent, the step and its key
        # stream are bit-identical to a build without the feature.
        sa_cfg = tcfg["data"].get("spec_augment") or None

        # extras.remat: rematerialize the forward pass in the backward
        # (jax.checkpoint) — trades ~1 extra forward of FLOPs for not
        # holding encoder/decoder activations across the whole loss,
        # the standard HBM lever for long-utterance or very large-batch
        # configs (identical gradients; tests/test_trainer_e2e.py)
        remat = bool(extras.get("remat", False))

        cached = self.hbm_cache

        def step(params, state, opt_state, X, y, n_real, key,
                 frame_len=None):
            if cached:
                # X = (cache (N+1,T,D), rows (B,), mask (B,T)): gather
                # the batch out of the HBM cache and apply the host-
                # drawn frame-dropout mask.  f32 cache + 0/1 multiply
                # == the host-assembled block bit-for-bit.
                cache_arr, rows, mask = X
                X = jnp.asarray(cache_arr)[rows].astype(jnp.float32) \
                    * mask.astype(jnp.float32)[:, :, None]
            elif not self.wav_mode \
                    and jnp.asarray(X).dtype != jnp.float32:
                # extras.transfer_dtype: features crossed the wire
                # narrow; widen on device before any compute
                X = jnp.asarray(X).astype(jnp.float32)
            if featurize is not None:
                X = featurize(X)
            if sa_cfg is not None:
                from ast_tpu.ops.specaugment import spec_augment
                key, sa_key = jax.random.split(key)
                # frame_len: the loader's TRUE per-row frame counts —
                # time masks place within the real extent in every mode
                X = spec_augment(sa_key, X, sa_cfg, lengths=frame_len)

            def loss_fn(p):
                return seq2seq.forward_loss(
                    p, state, mcfg, X, y, key, train=True, n_real=n_real,
                    teach_ratio=extras["teach_ratio"],
                    random_out=extras["random_out"],
                    add_noise=extras["speech_noise"],
                    compute_dtype=compute_dtype,
                    label_smoothing=extras["label_smoothing"],
                )

            if remat:
                loss_fn = jax.checkpoint(loss_fn)
            (loss, new_state), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = jax.tree.map(lambda p, u: p + u, params, updates)
            return params, new_state, opt_state, loss

        # per-batch RNG keys are derived IN-GRAPH from (epoch_key, batch
        # index) — folding on the host would cost one extra device
        # dispatch per batch (G+1 per group), which on dispatch-bound
        # runtimes eats the multi-step win.  Same fold_in math, so the
        # key stream is bit-identical to host-side derivation.
        if multi:
            # one dispatch advances G stacked batches: lax.scan over the
            # leading (step) axis with (params, state, opt_state) carried
            # — bit-identical to G sequential ``step`` calls
            def multi_step(params, state, opt_state, Xs, ys, n_reals,
                           epoch_key, start, frame_lens=None):
                if cached:
                    # the cache array has no step axis: keep it a scan
                    # constant, stack only rows/masks
                    cache_arr, rows_s, masks_s = Xs
                    G = rows_s.shape[0]

                    def body(carry, inp):
                        p, s, o = carry
                        rows, mask, y, n_real, j, frame_len = inp
                        key = jax.random.fold_in(epoch_key, start + j)
                        p, s, o, loss = step(
                            p, s, o, (cache_arr, rows, mask), y,
                            n_real, key, frame_len)
                        return (p, s, o), loss

                    (params, state, opt_state), losses = jax.lax.scan(
                        body, (params, state, opt_state),
                        (rows_s, masks_s, ys, n_reals, jnp.arange(G),
                         frame_lens))
                    return params, state, opt_state, losses
                G = Xs[0].shape[0] if isinstance(Xs, tuple) \
                    else Xs.shape[0]

                def body(carry, inp):
                    p, s, o = carry
                    X, y, n_real, j, frame_len = inp
                    key = jax.random.fold_in(epoch_key, start + j)
                    p, s, o, loss = step(p, s, o, X, y, n_real, key,
                                         frame_len)
                    return (p, s, o), loss

                (params, state, opt_state), losses = jax.lax.scan(
                    body, (params, state, opt_state),
                    (Xs, ys, n_reals, jnp.arange(G), frame_lens))
                return params, state, opt_state, losses

            fn = multi_step
        else:
            def single_step(params, state, opt_state, X, y, n_real,
                            epoch_key, idx, frame_len=None):
                key = jax.random.fold_in(epoch_key, idx)
                return step(params, state, opt_state, X, y, n_real, key,
                            frame_len)

            fn = single_step

        donate = (0, 1, 2)
        if self.mesh is not None:
            from ast_tpu.parallel.dp import shard_train_step
            return shard_train_step(fn, self.mesh, donate)
        return jax.jit(fn, donate_argnums=donate)

    def _make_predict_step(self):
        mcfg = self.mcfg
        compute_dtype = self.compute_dtype
        stop_limit = self.cfg.train["data"]["max_pred"]

        featurize = self._featurize if self.wav_mode else None

        def step(params, state, X):
            if featurize is not None:
                X = featurize(X)
            preds, _ = seq2seq.predict_greedy(
                params, state, mcfg, X, stop_limit, compute_dtype)
            return preds

        if self.mesh is not None:
            from ast_tpu.parallel.dp import shard_eval_step
            return shard_eval_step(step, self.mesh)
        return jax.jit(step)

    def _featurize(self, X):
        """(audio (B,S), cmvn mean/std (B,D)) -> normalized MFCC (B,T,D),
        traced inside the jitted step so XLA fuses it with the encoder."""
        audio, mean, std = X
        feats = self._mfcc(audio)
        return (feats - mean[:, None, :]) / std[:, None, :]

    # ------------------------------------------------------------------
    # epoch loops
    # ------------------------------------------------------------------
    def _device_batch(self, batch, labels=True, narrow=False):
        if "rows_idx" in batch:
            # HBM-cache mode: only indices + dropout mask (+ targets)
            # cross the wire; the cache array joins at dispatch time
            out = {
                "rows_idx": batch["rows_idx"],
                "drop_mask": batch["drop_mask"],
                "n_real": np.float32(batch["n_real"]),
            }
            if labels:
                out["y"] = batch["y"]
                out["frame_len"] = batch["frame_len"]
            if self.mesh is not None:
                out = shard_batch(out, self.mesh)
            else:
                out = jax.device_put(out)
            out["utts"] = batch["utts"]
            out["bucket"] = batch["bucket"]
            return out
        if self.wav_mode:
            x_val = (batch["audio"], batch["cmvn_mean"],
                     batch["cmvn_std"])
        else:
            x_val = batch["X"]
            if narrow and self.transfer_dtype is not None:
                # extras.transfer_dtype: halve feature bytes on the
                # wire; the train step widens on device
                x_val = x_val.astype(self.transfer_dtype)
        out = {
            "X": x_val,
            "n_real": np.float32(batch["n_real"]),
        }
        if labels:
            out["y"] = batch["y"]
            if "frame_len" in batch:
                out["frame_len"] = batch["frame_len"]
        if self.mesh is not None:
            out = shard_batch(out, self.mesh)
        else:
            out = jax.device_put(out)
        out["utts"] = batch["utts"]
        return out

    def _device_group(self, batches):
        """Stack G same-bucket host batches into one (G, B, ...) device
        batch for the scanned multi-step dispatch.  Partial runs (< G,
        stream tails) fall back to single-step dicts — the per-bucket
        single program exists anyway, and this avoids compiling a
        program per (bucket, run-length) pair."""
        if len(batches) < self.steps_per_dispatch:
            return ("singles", [self._device_batch(b, True, narrow=True)
                                for b in batches])
        if "rows_idx" in batches[0]:
            out = {
                "rows_idx": np.stack([b["rows_idx"] for b in batches]),
                "drop_mask": np.stack([b["drop_mask"] for b in batches]),
                "y": np.stack([b["y"] for b in batches]),
                "n_real": np.asarray([b["n_real"] for b in batches],
                                     np.float32),
                "frame_len": np.stack([b["frame_len"] for b in batches]),
            }
            if self.mesh is not None:
                out = shard_batch(out, self.mesh, axis=1)
            else:
                out = jax.device_put(out)
            out["sizes"] = [max(1, len(b["utts"])) for b in batches]
            out["bucket"] = batches[0]["bucket"]
            return ("multi", out)
        if self.wav_mode:
            xs = tuple(np.stack([b[k] for b in batches])
                       for k in ("audio", "cmvn_mean", "cmvn_std"))
        else:
            xs = np.stack([b["X"] for b in batches])
            if self.transfer_dtype is not None:
                xs = xs.astype(self.transfer_dtype)
        out = {
            "X": xs,
            "y": np.stack([b["y"] for b in batches]),
            "n_real": np.asarray([b["n_real"] for b in batches],
                                 np.float32),
        }
        if all("frame_len" in b for b in batches):
            out["frame_len"] = np.stack(
                [b["frame_len"] for b in batches])
        if self.mesh is not None:
            # leading axis is the scan (step) axis; shard batch rows
            out = shard_batch(out, self.mesh, axis=1)
        else:
            out = jax.device_put(out)
        out["sizes"] = [max(1, len(b["utts"])) for b in batches]
        return ("multi", out)

    def _hbm_cache_for(self, set_key):
        """Build (once per split) the HBM-resident feature cache."""
        if set_key not in self._hbm_caches:
            from ast_tpu.data.device_cache import EpochFeatureCache
            cache = EpochFeatureCache(
                self.data_loader, set_key, mesh=self.mesh,
                dtype=self.hbm_cache_dtype)
            print(f"hbm_cache[{set_key}]: "
                  f"{cache.nbytes / 1e6:.0f} MB resident", flush=True)
            self._hbm_caches[set_key] = cache
        return self._hbm_caches[set_key]

    def _gather_cached(self, cache, batch):
        """Eval-path batch assembly out of the HBM cache: one small
        jitted gather whose output feeds the (unchanged) eval/decode
        steps on device — no feature bytes cross the wire.  train=False
        streams carry an all-ones drop mask, so this equals the
        host-assembled block exactly."""
        fn = getattr(self, "_gather_fn", None)
        if fn is None:
            @jax.jit
            def fn(cache_arr, rows, mask):
                return jnp.asarray(cache_arr)[rows].astype(jnp.float32) \
                    * mask.astype(jnp.float32)[:, :, None]
            self._gather_fn = fn
        return fn(cache.bucket_array(batch["bucket"]),
                  batch["rows_idx"], batch["drop_mask"])

    def train_epoch(self, set_key, epoch=0):
        tcfg = self.cfg.train
        batch_size = tcfg["batch_size"]
        cache = self._hbm_cache_for(set_key) if self.hbm_cache else None

        # legacy weight-noise schedule (reference: nmt_run.py:850-854)
        wn_iter = tcfg["extras"].get("weight_noise_iter", 0)
        if wn_iter and epoch >= wn_iter:
            key, self.rng = jax.random.split(self.rng)
            self.params = seq2seq.add_weight_noise(
                self.params, key,
                tcfg["extras"]["weight_noise_mean"],
                tcfg["extras"]["weight_noise_sigma"])

        # device-side loss accumulation: converting per step would force a
        # host sync per batch and stall the dispatch pipeline
        losses, sizes = [], []
        epoch_key = jax.random.fold_in(jax.random.PRNGKey(self.seed), epoch)

        # mid-epoch resume: the per-epoch batch stream is deterministic
        # (dataloader derives its RNGs from (seed, set_key, epoch)), so
        # skipping the consumed prefix resumes exactly where the crash hit
        skip = 0
        if self.inflight_resume and self.inflight_resume[0] == epoch:
            skip = self.inflight_resume[1]
            self.inflight_resume = None

        # multi-process note: every host builds the IDENTICAL stream (the
        # epoch-keyed dataloader RNGs guarantee it) and shard_batch places
        # each host's local rows of the global batch — one SPMD program,
        # so the step key must also be identical across hosts
        G = self.steps_per_dispatch
        gen = self.data_loader.get_batch(
            batch_size, set_key, train=True, labels=True,
            curriculum=tcfg.get("curriculum", False), epoch=epoch,
            group_runs=G, tail_shrink=self.tail_shrink,
            index_cache=cache)
        if skip:
            import itertools
            gen = itertools.islice(gen, skip, None)

        # in-epoch crash-recovery snapshots (the reference only
        # checkpoints at epoch boundaries — SURVEY §5 failure detection)
        ckpt_steps = tcfg.get("checkpoint_steps", 0)

        import time as _time
        t_epoch = _time.perf_counter()
        consumed = skip
        last_snap = skip

        # multi-host: hosts must agree on the stop step or the ones that
        # keep running block forever in the next dispatch's collectives.
        # Local flags are OR-combined over DCN at a fixed cadence (the
        # consumed counter is identical on every host, so all hosts hit
        # the collective together and reach the same decision).
        sync_gate = CrossingGate(
            tcfg["extras"].get("preempt_sync_steps", ckpt_steps or 8),
            start=skip)

        def preempt_agreed():
            if jax.process_count() <= 1:
                return self._preempt
            # fire on CROSSING a sync boundary (CrossingGate), never on
            # exact equality — consumed advances by variable group
            # sizes.  The consumed counter is identical on every host,
            # so all hosts reach the collective together.
            if not sync_gate.crossed(consumed):
                return False
            from jax.experimental import multihost_utils
            flags = multihost_utils.process_allgather(
                np.int32(1 if self._preempt else 0))
            return bool(np.any(np.asarray(flags)))

        def maybe_snapshot():
            nonlocal last_snap
            if ckpt_steps and consumed - last_snap >= ckpt_steps:
                self.save_inflight(epoch, consumed)
                last_snap = consumed
            if preempt_agreed():
                self.save_inflight(epoch, consumed)
                raise PreemptedError(
                    f"preempted: epoch {epoch} snapshotted after "
                    f"{consumed} batches")

        def run_single(batch):
            if cache is not None:
                X_in = (cache.bucket_array(batch["bucket"]),
                        batch["rows_idx"], batch["drop_mask"])
            else:
                X_in = batch["X"]
            p, s, o, loss = self._train_step(
                self.params, self.state, self.opt_state,
                X_in, batch["y"], batch["n_real"],
                epoch_key, consumed, batch.get("frame_len"))
            self.params, self.state, self.opt_state = p, s, o
            losses.append(loss)
            sizes.append(max(1, len(batch["utts"])))

        # multi-process SPMD: replicated device_put runs a cross-process
        # equality collective, so every process must issue its puts in
        # the SAME order — parallel prepare would interleave batches
        # differently per host and pair mismatched collectives (caught
        # by test_multihost_mp).  One worker preserves the global order.
        pf_workers = 1 if jax.process_count() > 1 else max(
            1, int(tcfg["extras"].get("prefetch_workers", 2)))
        if G > 1:
            prefetch = Prefetcher(_group_stream(gen, G),
                                  self._device_group,
                                  depth=2 * pf_workers,
                                  workers=pf_workers)
            for kind, payload in prefetch:
                if kind == "multi":
                    if cache is not None:
                        Xs_in = (cache.bucket_array(payload["bucket"]),
                                 payload["rows_idx"],
                                 payload["drop_mask"])
                    else:
                        Xs_in = payload["X"]
                    p, s, o, loss_vec = self._train_multi_step(
                        self.params, self.state, self.opt_state,
                        Xs_in, payload["y"], payload["n_real"],
                        epoch_key, consumed, payload.get("frame_len"))
                    self.params, self.state, self.opt_state = p, s, o
                    losses.append(loss_vec)
                    sizes.extend(payload["sizes"])
                    consumed += G
                else:
                    for batch in payload:
                        run_single(batch)
                        consumed += 1
                maybe_snapshot()
        else:
            prefetch = Prefetcher(
                gen, lambda b: self._device_batch(b, True, narrow=True),
                depth=2 * pf_workers, workers=pf_workers)
            for batch in prefetch:
                run_single(batch)
                consumed += 1
                maybe_snapshot()

        if ckpt_steps:
            # mark the epoch complete: "epoch+1 has consumed 0 batches"
            self.save_inflight(epoch + 1, 0)

        if not losses:
            return 0.0
        # loss reporting normalized by true batch rows, matching the
        # current reference path (nn.py:189 divides by batch size).
        # device_get is the real sync point — throughput is attributed
        # over the whole epoch including the queue drain.
        vals = np.concatenate(
            [np.ravel(v) for v in jax.device_get(losses)])
        self.timer.add(_time.perf_counter() - t_epoch, sum(sizes),
                       len(vals))
        return float(sum(v / s for v, s in zip(vals, sizes)) / len(vals))

    def request_preempt(self):
        """Ask the running epoch to snapshot and stop at the next batch
        boundary (signal-handler safe: only sets a flag)."""
        self._preempt = True

    def preempt_pending(self):
        """Host-agreed preemption status OUTSIDE the batch loop (epoch
        phase boundaries: after train, after dev decode).  All hosts
        must call this at the same point; the OR over hosts means a
        SIGTERM delivered to any one host stops all of them."""
        if jax.process_count() <= 1:
            return self._preempt
        from jax.experimental import multihost_utils
        flags = multihost_utils.process_allgather(
            np.int32(1 if self._preempt else 0))
        return bool(np.any(np.asarray(flags)))

    def save_inflight(self, epoch, step):
        """Atomic mid-epoch snapshot for crash recovery (process 0 only:
        in multi-host runs all hosts hold identical params and consume
        their stride of the same deterministic stream in lockstep)."""
        if jax.process_index() != 0:
            return
        import numpy as _np
        path = os.path.join(self.model_dir, "seq2seq_inflight.npz")
        # save_checkpoint itself writes tmp-then-rename now
        save_checkpoint(path, self.params, self.state, self.opt_state,
                        extra={"epoch": _np.int64(epoch),
                               "step": _np.int64(step),
                               # the grouped stream order depends on G;
                               # resume validates it matches
                               "g": _np.int64(self.steps_per_dispatch)})

    def eval_loss(self, set_key):
        """Teacher-forced loss on a split without updating anything —
        the legacy harness's dev-loss pass (reference: nmt_run.py:909,
        feed_model with train=False)."""
        # jit once and cache on self: a fresh closure per call would
        # recompile every epoch's dev-loss pass
        loss_step = getattr(self, "_eval_loss_step", None)
        if loss_step is None:
            mcfg = self.mcfg
            compute_dtype = self.compute_dtype
            featurize = self._featurize if self.wav_mode else None

            @jax.jit
            def loss_step(params, state, X, y, n_real):
                if featurize is not None:
                    X = featurize(X)
                loss, _ = seq2seq.forward_loss(
                    params, state, mcfg, X, y, jax.random.PRNGKey(0),
                    train=False, n_real=n_real,
                    compute_dtype=compute_dtype)
                return loss

            self._eval_loss_step = loss_step

        losses, sizes = [], []
        cache = self._hbm_cache_for(set_key) if self.hbm_cache else None
        gen = self.data_loader.get_batch(
            self.cfg.train["batch_size"], set_key, train=False, labels=True,
            # multi-host SPMD: every host must assemble the identical
            # stream (same reasoning as predict's pinned epoch) — the
            # stateful py_rng would otherwise let hosts diverge
            epoch=0 if jax.process_count() > 1 else None,
            tail_shrink=self.tail_shrink, index_cache=cache)
        prefetch = Prefetcher(gen, lambda b: self._device_batch(b, True))
        for batch in prefetch:
            X = self._gather_cached(cache, batch) if cache is not None \
                else batch["X"]
            losses.append(loss_step(self.params, self.state, X,
                                    batch["y"], batch["n_real"]))
            sizes.append(max(1, len(batch["utts"])))
        if not losses:
            return 0.0
        vals = [float(v) for v in jax.device_get(losses)]
        return sum(v / s for v, s in zip(vals, sizes)) / len(vals)

    def predict(self, set_key):
        """Greedy-decode a split.  Multi-process: hosts run the same SPMD
        program over identical streams; the eval step's outputs are
        replicated (dp.shard_eval_step), so every host returns the FULL
        split — downstream BLEU indexes all of eval.ids (eval/bleu.py)."""
        batch_size = self.cfg.train["batch_size"]
        preds = []
        cache = self._hbm_cache_for(set_key) if self.hbm_cache else None
        gen = self.data_loader.get_batch(
            batch_size, set_key, train=False, labels=False,
            epoch=0 if jax.process_count() > 1 else None,
            tail_shrink=self.tail_shrink, index_cache=cache)
        prefetch = Prefetcher(gen, lambda b: self._device_batch(b, False))
        inflight = collections.deque()

        def drain():
            batch, p = inflight.popleft()
            p = np.asarray(p)[: len(batch["utts"])]
            preds.extend(zip(batch["utts"], p.tolist()))

        # keep `decode_pipeline` batches in flight: np.asarray blocks
        # until THAT batch finishes, so draining eagerly parks the
        # device while the host materializes + postprocesses; the deque
        # overlaps batch i's host work with batch i+1's device work
        depth = self._decode_pipeline_depth()
        for batch in prefetch:
            X = self._gather_cached(cache, batch) if cache is not None \
                else batch["X"]
            p = self._predict_step(self.params, self.state, X)
            inflight.append((batch, p))
            if len(inflight) >= depth:
                drain()
        while inflight:
            drain()
        return preds

    def _decode_pipeline_depth(self, heavy_outputs=False):
        """Decode dispatches kept in flight.  ``None`` (the default)
        resolves to 2, except 1 when ``heavy_outputs`` (save_attn beam
        histories) would double a near-limit memory footprint; an
        explicit ``extras.decode_pipeline`` always wins."""
        depth = self.cfg.train["extras"].get("decode_pipeline")
        if depth is None:
            return 1 if heavy_outputs else 2
        return max(1, int(depth))

    # ------------------------------------------------------------------
    # beam decode (batched on device)
    # ------------------------------------------------------------------
    def decode_beam_set(self, set_key, N, K, batch_size=None,
                        save_attn=False):
        """Beam-decode a whole split.  Returns {utt: [(hyp_ids, score)]},
        or {utt: [(hyp_ids, score, attn_history)]} with ``save_attn``
        (attn_history: (len, T') float32 — reference beam entries carry
        the per-step alphas, reference: beam.py:121)."""
        if batch_size is None:
            batch_size = self.cfg.train["batch_size"]
        stop_limit = self.cfg.train["data"]["max_pred"]
        results = {}
        cache = self._hbm_cache_for(set_key) if self.hbm_cache else None
        gen = self.data_loader.get_batch(
            batch_size, set_key, train=False, labels=False,
            # multi-host SPMD: identical streams on every host (see
            # predict) — test_multihost_mp pins identical beam content
            epoch=0 if jax.process_count() > 1 else None,
            tail_shrink=self.tail_shrink, index_cache=cache)
        prefetch = Prefetcher(gen, lambda b: self._device_batch(b, False))
        decode = beam_ops.make_beam_decoder(
            self.mcfg, N=N, K=K, stop_limit=stop_limit,
            compute_dtype=self.compute_dtype, return_attn=save_attn,
            mesh=self.mesh)
        # one jit per decode set, not per batch (jitting a fresh bound
        # method in the loop would recompile every iteration)
        featurize = jax.jit(self._featurize) if self.wav_mode else None
        inflight = collections.deque()

        def drain():
            batch, out = inflight.popleft()
            hyps, scores, lengths = (np.asarray(a) for a in out[:3])
            attn = np.asarray(out[3]) if save_attn else None
            for j, utt in enumerate(batch["utts"]):
                entries = []
                for n in range(hyps.shape[1]):
                    L = int(lengths[j, n])
                    e = (hyps[j, n, :L].tolist(), float(scores[j, n]))
                    if save_attn:
                        e = e + (attn[j, n, :L],)
                    entries.append(e)
                results[utt] = entries

        # pipeline the dispatches (see predict): the per-hyp Python
        # loop below is the heaviest host postprocess in the repo —
        # without the deque the device idles through all of it
        depth = self._decode_pipeline_depth(heavy_outputs=save_attn)
        for batch in prefetch:
            if cache is not None:
                X = self._gather_cached(cache, batch)
            else:
                X = batch["X"]
                if featurize is not None:
                    X = featurize(X)
            inflight.append((batch, decode(self.params, self.state, X)))
            if len(inflight) >= depth:
                drain()
        while inflight:
            drain()
        return results

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------
    def save(self, epoch):
        if jax.process_index() != 0:
            return
        save_checkpoint(
            checkpoint_path(self.model_dir, epoch),
            self.params, self.state, self.opt_state,
        )
