"""Bucketed, statically-shaped batch production.

Re-design of the reference loaders (reference: dataloader.py:49-316) for an
XLA world: every batch a bucket emits has the *same* shape — speech padded to
the bucket's frame width, targets padded to a per-bucket target length, and
the batch axis padded to ``batch_size`` with all-PAD dummy rows (whose loss
contribution is exactly zero through the PAD class weight).  This bounds the
number of XLA compilations to (#buckets x 2 programs) instead of recompiling
per ragged shape.

Semantics preserved from the reference:
- shuffle within bucket, chunk, then shuffle the batch list
  (reference: dataloader.py:125-134)
- speech truncated to ``max_sp = (num_b+1)*width_b`` frames
  (reference: dataloader.py:118)
- target ids = [GO] + ids[:max_pred-2] + [EOS], UNK for OOV
  (reference: dataloader.py:147-150)
- frame dropout on train splits: ``int(rate*len)`` indices drawn *with*
  replacement, zeroed (reference: dataloader.py:83-93)
- Fisher speech loaded lazily from per-utt ``.npy`` with the
  ``utt.split('_',1)[0]`` subdirectory fallback (reference: dataloader.py:95-103)
- GlobalPhone speech from one in-RAM pickle dict (reference: dataloader.py:234-241)
- ``get_hyps`` detokenization incl. BPE merge + specials filtering
  (reference: dataloader.py:167-183)
"""

import os
import pickle
import random

import numpy as np

from ast_tpu.data import buckets as prep_buckets
from ast_tpu.symbols import SYMBOLS
from ast_tpu.utils.seeding import stable_seed


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _group_bucket_runs(batch_list, run_len):
    """Permute a shuffled [(utts, bucket)] list into runs of up to
    ``run_len`` consecutive same-bucket entries by pulling later
    same-bucket entries forward (first-seen bucket order preserved).
    Deterministic given the input order; every entry appears once."""
    from collections import deque
    pending = {}
    order = []
    for item in batch_list:
        pending.setdefault(item[1], deque()).append(item)
        order.append(item[1])
    out = []
    for b in order:
        q = pending[b]
        run = 0
        while q and run < run_len:
            out.append(q.popleft())
            run += 1
    return out


class DataLoader:
    """Shared bucketing/batching/detokenization logic."""

    def __init__(self, data_cfg, model_dir, seed="seed"):
        self.data_cfg = data_cfg
        self.model_dir = model_dir
        self.seed = seed
        self.py_rng = random.Random(seed)
        self.np_rng = np.random.RandomState(stable_seed(seed, bits=32))

        with open(data_cfg["map_path"], "rb") as f:
            self.map = pickle.load(f)
        with open(data_cfg["vocab_path"], "rb") as f:
            self.vocab = pickle.load(f)
        with open(data_cfg["info_path"], "rb") as f:
            self.info = pickle.load(f)

        # speech runs bucket on frame counts; text-encoder mode (legacy
        # capability) buckets on source token counts
        self.enc_key = data_cfg.get("enc_key", "sp")
        self.text_mode = self.enc_key != "sp"
        bucket_key = "sp" if not self.text_mode else self.enc_key
        self.buckets = prep_buckets.buckets_main(
            self.model_dir,
            data_cfg["buckets_num"],
            data_cfg["buckets_width"],
            key=bucket_key,
            scale=data_cfg["train_scale"],
            seed="haha",
            info_dict=self.info,
        )

        self.n_utts = {
            key: sum(len(b) for b in self.buckets[key]["buckets"])
            for key in self.buckets
        }

        self._compute_target_lengths()

    # ------------------------------------------------------------------
    # static-shape policy
    # ------------------------------------------------------------------
    def _compute_target_lengths(self):
        """Per-bucket static decoder length: max target tokens (+GO+EOS) of
        any utterance in the bucket, rounded up to ``target_pad_multiple``
        and capped at ``max_pred``.  Bucket index then fully determines the
        (T, U) pair XLA compiles against."""
        dec_key = self.data_cfg["dec_key"]
        max_pred = self.data_cfg["max_pred"]
        mult = self.data_cfg.get("target_pad_multiple", 16)
        # limit_vocab+add_unk substitutes a single UNK for an all-OOV
        # (incl. empty) target at assembly time, so the static U must
        # cover [GO, UNK, EOS] even when the raw token count is 0
        min_n = 1 if (self.data_cfg.get("limit_vocab", False)
                      and self.data_cfg.get("add_unk", False)) else 0
        self.target_len = {}
        for set_key in self.buckets:
            num_b = self.buckets[set_key]["num_b"]
            lens = [2] * num_b
            for b, bucket in enumerate(self.buckets[set_key]["buckets"]):
                for u in bucket:
                    n = max(self._n_target_tokens(set_key, u, dec_key),
                            min_n)
                    lens[b] = max(lens[b], min(n + 2, max_pred))
            self.target_len[set_key] = [
                min(_round_up(l, mult), max_pred) for l in lens
            ]

    def _n_target_tokens(self, set_key, utt, dec_key):
        entry = self.map.get(set_key, {}).get(utt)
        if entry is not None and dec_key in entry:
            return len(entry[dec_key])
        # fall back to info counts when the map lacks this key
        return int(self.info[set_key][utt].get(dec_key, 2))

    # ------------------------------------------------------------------
    # augmentation
    # ------------------------------------------------------------------
    def _drop_frames(self, x_data, drop_rate, np_rng=None):
        np_rng = self.np_rng if np_rng is None else np_rng
        num_drop = int(drop_rate * len(x_data))
        if num_drop > 0:
            mask = np.ones(len(x_data), dtype=np.float32)
            inds = np_rng.choice(np.arange(len(x_data)), size=num_drop)
            mask[inds] = 0
            return x_data * mask[:, np.newaxis]
        return x_data

    def _load_speech(self, utt, set_key, max_sp):
        raise NotImplementedError

    # ------------------------------------------------------------------
    # batching
    # ------------------------------------------------------------------
    def _bucket_batch_size(self, batch_size, b, num_b):
        """Flat int, or legacy per-bucket sizes {max, med, min} by bucket
        thirds (reference: nmt_run.py:416-426)."""
        if isinstance(batch_size, dict):
            if b < num_b // 3:
                return int(batch_size["max"])
            if b < (num_b * 2) // 3:
                return int(batch_size["med"])
            return int(batch_size["min"])
        return int(batch_size)

    @staticmethod
    def tail_rows(n, b_size, min_rows):
        """Smallest repeated-half of ``b_size`` that holds ``n`` real
        rows: tail batches pad to this instead of the full ``b_size``.
        Halves stay multiples of ``min_rows`` (8 x the mesh data shards:
        every tail shape shards evenly, and the set of statically
        compiled tail shapes stays small).  No kernel needs the 8-row
        alignment any more; it is kept so batch shapes do not change."""
        B = b_size
        while B // 2 >= max(n, min_rows) and (B // 2) % min_rows == 0:
            B //= 2
        return B

    def get_batch(self, batch_size, set_key, train, labels=False,
                  pad_batch=True, curriculum=False, epoch=None,
                  group_runs=1, tail_shrink=0, _skip_speech=False,
                  index_cache=None):
        """Generator of statically-shaped batch dicts.

        Yields {"X": (B,T,D) f32, "y": (B,U) i32 [labels], "utts": [ids],
        "n_real": int, "bucket": int}.  ``n_real`` counts true rows; dummy
        rows are zeros / all-PAD and contribute zero loss.

        ``curriculum=True`` feeds buckets short-to-long without shuffling
        the batch order (legacy capability, reference: nmt_run.py:406-446).

        ``epoch`` (optional): derive the shuffle/augmentation RNGs from
        (seed, set_key, epoch) instead of the loader's stateful streams, so
        the batch order of any epoch is reproducible in a fresh process —
        this is what makes mid-epoch crash recovery (skip consumed batches)
        and multi-host striding exact.

        ``group_runs`` (optional, >1): deterministically regroup the
        shuffled batch order into runs of up to ``group_runs`` consecutive
        same-bucket batches, so the trainer can fuse each run into ONE
        device dispatch (``extras.steps_per_dispatch``) — same-bucket
        batches share a static shape.  The regrouping is a permutation of
        the shuffled order and is itself part of the deterministic epoch
        stream, keeping prefix-based crash resume exact.

        ``index_cache`` (optional): an
        :class:`ast_tpu.data.device_cache.EpochFeatureCache` for this
        split.  Batches then carry ``rows_idx`` (B,) int32 cache-row
        indices and ``drop_mask`` (B, T) uint8 instead of the feature
        block ``X`` — the trainer gathers features out of HBM on
        device.  The frame-dropout RNG draws are IDENTICAL to the
        host-assembly path (same stream, same counts), so the resulting
        on-device X is bit-identical to host-fed batches.

        ``tail_shrink`` (optional, >0 = min_rows): pad each bucket's
        LAST partial batch to the smallest repeated-half of the bucket
        batch size that holds it (see ``tail_rows``) instead of the
        full size.  Recovers the ~(B/2 per bucket per epoch) padded-row
        waste — the measured ~8% real-vs-slot throughput gap — at the
        cost of a few extra cached compile shapes.  Not in the
        reference (Chainer ran the true ragged tail; XLA needs static
        shapes, this is the closest static equivalent — and it also
        brings tail-batch BatchNorm statistics closer to the
        reference's, which never saw dummy rows).
        """
        if epoch is not None:
            tag = f"{self.seed}|{set_key}|{epoch}"
            py_rng = random.Random(tag)
            np_rng = np.random.RandomState(stable_seed(tag, bits=32))
        else:
            py_rng, np_rng = self.py_rng, self.np_rng

        num_b = self.buckets[set_key]["num_b"]
        width_b = self.buckets[set_key]["width_b"]
        max_sp = (num_b + 1) * width_b

        if labels:
            dec_key = self.data_cfg["dec_key"]
            max_pred = self.data_cfg["max_pred"]

        batch_list = []
        for b, bucket in enumerate(self.buckets[set_key]["buckets"]):
            b_size = self._bucket_batch_size(batch_size, b, num_b)
            bucket = list(bucket)
            py_rng.shuffle(bucket)
            for i in range(0, len(bucket), b_size):
                batch_list.append((bucket[i:i + b_size], b))
        if not curriculum:
            py_rng.shuffle(batch_list)
        if group_runs > 1:
            batch_list = _group_bucket_runs(batch_list, group_runs)

        for utts, b in batch_list:
            # bucket b holds utts with < (b+1)*width_b frames (last bucket
            # additionally holds everything longer, truncated to max_sp)
            T = max_sp if b == num_b - 1 else (b + 1) * width_b
            b_size = self._bucket_batch_size(batch_size, b, num_b)
            B = b_size if pad_batch else len(utts)
            if pad_batch and tail_shrink > 0 and len(utts) < b_size:
                B = self.tail_rows(len(utts), b_size, tail_shrink)
            # true per-row real frame counts (dummy rows 0) — consumed by
            # in-graph SpecAugment so time masks place within the REAL
            # extent even when zero_input dropout zeroes the final frame
            # (a last-nonzero heuristic would undercount) and in wav mode
            # (where it couldn't be inferred from features at all)
            frame_len = np.zeros((B,), dtype=np.int32)
            rows_idx = drop_mask = None
            if _skip_speech:
                # raw-audio loaders assemble their own speech tensor
                # (and overwrite frame_len from audio sample counts)
                X = None
            elif index_cache is not None:
                # HBM-cache mode: emit gather indices + dropout mask;
                # the RNG consumption below mirrors _drop_frames
                # exactly (choice over arange(L), L = the truncated
                # length the host path would have loaded)
                X = None
                rate = (self.data_cfg.get("zero_input", 0)
                        if train and "train" in set_key else 0)
                rows_idx = np.full((B,), index_cache.pad_row(b),
                                   dtype=np.int32)
                drop_mask = np.ones((B, T), dtype=np.uint8)
                for j, u in enumerate(utts):
                    rows_idx[j] = index_cache.row_of[u]
                    L = min(index_cache.true_len[u], max_sp)
                    num_drop = int(rate * L)
                    if num_drop > 0:
                        inds = np_rng.choice(np.arange(L), size=num_drop)
                        drop_mask[j, inds] = 0
                    frame_len[j] = min(L, T)
            elif self.text_mode:
                # text-encoder source: padded int token ids
                w2i = self.vocab[self.enc_key]["w2i"]
                X = np.full((B, T), SYMBOLS.PAD_ID, dtype=np.int32)
                for j, u in enumerate(utts):
                    ids = [w2i.get(w, SYMBOLS.UNK_ID)
                           for w in self.map[set_key][u][self.enc_key]][:T]
                    X[j, : len(ids)] = ids
                    frame_len[j] = len(ids)
            else:
                feats = [self._load_speech(u, set_key, max_sp) for u in utts]
                D = feats[0].shape[1]
                X = np.zeros((B, T, D), dtype=np.float32)
                for j, x in enumerate(feats):
                    if train and self.data_cfg.get("zero_input", 0) > 0 \
                            and "train" in set_key:
                        x = self._drop_frames(x, self.data_cfg["zero_input"],
                                              np_rng)
                    X[j, : len(x)] = x
                    frame_len[j] = min(len(x), T)

            batch = {
                "X": X,
                "utts": list(utts),
                "n_real": len(utts),
                "bucket": b,
                "rows": B,
                "frame_len": frame_len,
            }
            if rows_idx is not None:
                batch["rows_idx"] = rows_idx
                batch["drop_mask"] = drop_mask
            if _skip_speech:
                batch["X_rows"] = B

            if labels:
                U = self.target_len[set_key][b]
                y = np.full((B, U), SYMBOLS.PAD_ID, dtype=np.int32)
                limit_vocab = self.data_cfg.get("limit_vocab", False)
                add_unk = self.data_cfg.get("add_unk", False)
                w2i = (self.vocab["w2i"] if limit_vocab
                       else self.vocab[dec_key]["w2i"])
                for j, u in enumerate(utts):
                    toks = self.map[set_key][u][dec_key]
                    if limit_vocab:
                        # OOV dropped, not UNK'd (reference:
                        # nmt_run.py:348-358)
                        ids = [w2i[w] for w in toks if w in w2i]
                        if not ids and add_unk:
                            ids = [SYMBOLS.UNK_ID]
                    else:
                        ids = [w2i.get(w, SYMBOLS.UNK_ID) for w in toks]
                    y_ids = [SYMBOLS.GO_ID] + ids[: max_pred - 2] \
                        + [SYMBOLS.EOS_ID]
                    y[j, : len(y_ids)] = y_ids
                batch["y"] = y

            yield batch

    # ------------------------------------------------------------------
    # detokenization
    # ------------------------------------------------------------------
    @property
    def dec_i2w(self):
        """The decoder-side id->token table (limit_vocab-aware)."""
        return (self.vocab["i2w"]
                if self.data_cfg.get("limit_vocab", False)
                else self.vocab[self.data_cfg["dec_key"]]["i2w"])

    def get_hyps(self, preds):
        """id sequences -> word lists, keyed by utt.

        Matches reference semantics exactly (the shared contract lives
        in :mod:`ast_tpu.data.detok`): specials (< 4) are dropped
        wherever they occur, tokens after EOS are *kept* (the reference's
        EOS truncation is commented out), BPE joiners are merged.
        """
        from ast_tpu.data.detok import ids_to_text

        dec_key = self.data_cfg["dec_key"]
        i2w = self.dec_i2w
        en_hyps = {}
        for utt, p in preds:
            if hasattr(p, "tolist"):          # accept np/jnp id arrays
                p = p.tolist()
            if not isinstance(p, (list, tuple)):
                # an unconvertible pred must not silently become an
                # empty hypothesis (it reads as a catastrophic BLEU,
                # not as the type bug it is)
                raise TypeError(
                    f"get_hyps: pred for {utt!r} must be a token-id "
                    f"sequence, got {type(p).__name__}")
            en_hyps[utt] = ids_to_text(
                p, lambda i: i2w[i].decode(), dec_key).split()
        return en_hyps


class FisherDataLoader(DataLoader):
    """Fisher corpus: per-utterance ``.npy`` MFCC features on disk, with an
    optional in-RAM cache so epochs after the first do zero disk I/O.

    If ``<speech_path>/<set_key>.pack`` exists (built by ``prep_data
    pack-features``, see :mod:`ast_tpu.data.feature_pack`), the split is
    served from that single memory-mapped file instead — no
    per-utterance opens and no Python-side cache growth."""

    def __init__(self, data_cfg, model_dir, seed="seed", cache_features=True):
        super().__init__(data_cfg, model_dir, seed)
        self.cache_features = cache_features
        self._cache = {}
        self._packs = {}

    def _pack_for(self, set_key):
        if set_key not in self._packs:
            path = os.path.join(self.data_cfg["speech_path"],
                                f"{set_key}.pack")
            if os.path.exists(path):
                from ast_tpu.data.feature_pack import FeaturePack
                self._packs[set_key] = FeaturePack(path)
            else:
                self._packs[set_key] = None
        return self._packs[set_key]

    def _load_speech(self, utt, set_key, max_sp):
        pack = self._pack_for(set_key)
        if pack is not None and utt in pack:
            return pack.get(utt, max_rows=max_sp)
        key = (set_key, utt)
        if self.cache_features and key in self._cache:
            return self._cache[key]
        sp_path = os.path.join(self.data_cfg["speech_path"], set_key)
        utt_path = os.path.join(sp_path, f"{utt}.npy")
        if not os.path.exists(utt_path):
            utt_path = os.path.join(
                sp_path, utt.split("_", 1)[0], f"{utt}.npy"
            )
        x = np.load(utt_path)[:max_sp].astype(np.float32)
        if self.cache_features:
            self._cache[key] = x
        return x


class GlobalPhoneDataLoader(DataLoader):
    """GlobalPhone corpus: all features live in one pickled dict
    (``speech_path`` -> {set_key: {utt: (T,D) array}})."""

    def __init__(self, data_cfg, model_dir, seed="seed"):
        super().__init__(data_cfg, model_dir, seed)
        with open(data_cfg["speech_path"], "rb") as f:
            self.speech_data = pickle.load(f)

    def _load_speech(self, utt, set_key, max_sp):
        return np.asarray(
            self.speech_data[set_key][utt][:max_sp], dtype=np.float32
        )


def make_dataloader(train_cfg, model_dir):
    """Loader factory keyed on ``data.dataloader`` (reference: nn.py:57-65)
    and ``data.features`` ("wav" => on-device MFCC+CMVN pipeline)."""
    data_cfg = train_cfg["data"]
    seed = train_cfg.get("seed", "seed")
    if data_cfg.get("features", "precomputed") == "wav":
        from ast_tpu.data.wav_loader import WavDataLoader
        return WavDataLoader(data_cfg, model_dir, seed)
    if data_cfg.get("dataloader") == "globalphone":
        return GlobalPhoneDataLoader(data_cfg, model_dir, seed)
    return FisherDataLoader(data_cfg, model_dir, seed)
