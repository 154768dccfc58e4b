"""Duration bucketing.

Batches are formed only from utterances of similar speech duration so the
padded, *static* per-bucket shapes XLA compiles against waste little compute.
Semantics match the reference exactly (reference: preprocessing/
prep_buckets.py:41-108):

- bucket index = ``min(frames // width_b, num_b - 1)``
- optional train-set subsampling by ``scale`` (``random.sample`` with a
  dedicated seed)
- the resulting dict is persisted as ``buckets_<key>.dict`` in the model dir

On the device this bucketing is the *length policy*: bucket ``b`` trains with input
length ``(b+1)*width_b``, giving at most ``num_b`` encoder shapes.
"""

import os
import pickle
import random


def create_buckets(cat_dict, num_b, width_b, key, scale, seed):
    """Assign each utterance id to a duration bucket.

    ``cat_dict``: {utt_id: {key: n_frames, ...}} for one dataset split.
    Returns {"buckets": [list of utt ids per bucket], "num_b", "width_b"}.
    """
    buckets_info = {
        "buckets": [[] for _ in range(num_b)],
        "num_b": num_b,
        "width_b": width_b,
    }

    for utt_id in cat_dict:
        bucket = min(cat_dict[utt_id][key] // width_b, num_b - 1)
        buckets_info["buckets"][bucket].append(utt_id)

    if scale > 1:
        rng = random.Random(seed)
        for i in range(len(buckets_info["buckets"])):
            sample_len = int(len(buckets_info["buckets"][i]) // scale)
            buckets_info["buckets"][i] = rng.sample(
                buckets_info["buckets"][i], sample_len
            )

    return buckets_info


def buckets_main(save_path, num_b, width_b, key, scale=1, seed="haha",
                 info_path="", info_dict=None):
    """Bucket every split in an info dict and persist the result.

    Matches reference prep_buckets.buckets_main, with one extension: an
    already-loaded ``info_dict`` may be passed directly (used by in-memory
    pipelines and tests).
    """
    if not os.path.exists(save_path):
        raise FileNotFoundError(f"model dir does not exist: {save_path}")

    if info_dict is None:
        if not os.path.exists(info_path):
            raise FileNotFoundError(f"info path does not exist: {info_path}")
        with open(info_path, "rb") as f:
            info_dict = pickle.load(f)

    bucket_dict = {}
    for cat in info_dict:
        # subsampling only applies to training splits
        scale_val = scale if "train" in cat else 1
        bucket_dict[cat] = create_buckets(
            info_dict[cat], num_b, width_b, key, scale_val, seed
        )

    # atomic write: multi-host runs share the model dir, and every process
    # computes (identical) buckets — interleaved writes must not corrupt
    bucket_dict_path = os.path.join(save_path, f"buckets_{key}.dict")
    tmp_path = f"{bucket_dict_path}.tmp.{os.getpid()}"
    with open(tmp_path, "wb") as f:
        pickle.dump(bucket_dict, f)
    os.replace(tmp_path, bucket_dict_path)
    return bucket_dict
