"""HBM-resident epoch feature cache (``extras.hbm_cache``).

The reference re-ships every batch's feature block host->GPU every epoch
(reference: dataloader.py:111-164 assembles on host, nn.py:168 uploads
per batch).  On transfer-bound hosts that feed can bound the trainer.
A 20h Fisher feature
set is ~375 MB f32 — it fits in HBM with room to spare, so this module
uploads each bucket's padded feature matrix ONCE and the jitted train
step assembles batches by a device-side gather over the epoch's
permuted row indices.  Per-batch wire traffic drops from the feature
block (~8 MB at B=32, T=1600) to indices + dropout mask + targets
(~60 KB).

Bit-exactness contract (tested in tests/test_device_cache.py): with a
float32 cache, ``gather(cache, rows)[j] * drop_mask[j]`` is bit-equal
to the host-assembled batch — rows are stored exactly as
``_load_speech`` returns them (zero-padded to the bucket width, the
same zeros the host batch buffer has), the dataloader draws the
frame-dropout indices from the identical RNG stream
(dataloader.get_batch ``index_cache`` mode), and multiplying by a 0/1
f32 mask is the exact operation the host path performs
(dataloader._drop_frames).  ``dtype=bfloat16`` halves HBM at the cost
of that bit-exactness (features round once on upload) — explicit
opt-in via ``extras.hbm_cache_dtype``.
"""

import numpy as np

import jax


class EpochFeatureCache:
    """Per-bucket HBM feature matrices for one split.

    ``bucket_array(b)`` is a ``(N_b + 1, T_b, D)`` device array whose
    final row is all zeros (the gather target for batch-padding rows);
    ``row_of[utt]`` / ``true_len[utt]`` feed the dataloader's
    index-mode batches.
    """

    def __init__(self, loader, set_key, mesh=None, dtype=np.float32):
        if getattr(loader, "text_mode", False):
            raise ValueError("hbm_cache: text-encoder mode buckets "
                             "token ids, not features")
        info = loader.buckets[set_key]
        num_b, width_b = info["num_b"], info["width_b"]
        max_sp = (num_b + 1) * width_b
        self.set_key = set_key
        self.row_of = {}
        self.true_len = {}
        self._arrays = [None] * num_b
        self._pad_rows = [0] * num_b

        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec
            sharding = NamedSharding(mesh, PartitionSpec())
        else:
            sharding = None

        # the loader's host-RAM feature cache would retain a second
        # full copy of every array loaded here (it will never be read
        # again in cache mode — the device holds the data); disable it
        # for the duration of the build
        prev_cache_flag = getattr(loader, "cache_features", None)
        if prev_cache_flag:
            loader.cache_features = False
        try:
            total = self._build(loader, info, num_b, width_b, max_sp,
                                dtype, sharding)
        finally:
            if prev_cache_flag is not None:
                loader.cache_features = prev_cache_flag
        self.nbytes = total

    def _build(self, loader, info, num_b, width_b, max_sp, dtype,
               sharding):
        total = 0
        for b, bucket in enumerate(info["buckets"]):
            if not bucket:
                continue
            T = max_sp if b == num_b - 1 else (b + 1) * width_b
            feats = []
            for row, utt in enumerate(bucket):
                x = loader._load_speech(utt, self.set_key, max_sp)
                self.row_of[utt] = row
                self.true_len[utt] = len(x)
                feats.append(np.asarray(x, np.float32))
            D = feats[0].shape[1]
            arr = np.zeros((len(bucket) + 1, T, D), dtype=np.float32)
            for row, x in enumerate(feats):
                arr[row, : len(x)] = x
            if dtype != np.float32:
                arr = arr.astype(dtype)
            self._pad_rows[b] = len(bucket)
            if sharding is not None:
                self._arrays[b] = jax.device_put(arr, sharding)
            else:
                self._arrays[b] = jax.device_put(arr)
            total += arr.nbytes
        return total

    def bucket_array(self, b):
        return self._arrays[b]

    def pad_row(self, b):
        """Index of the all-zero row batch padding gathers."""
        return self._pad_rows[b]
