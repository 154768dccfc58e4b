"""Test configuration: an 8-device virtual CPU mesh before JAX init.

The tests run on the CPU (``JAX_PLATFORMS=cpu`` unless the caller sets
another platform).  Multi-device sharding is validated on a host-platform
device mesh (``--xla_force_host_platform_device_count=8``).  Tests marked
``gpu`` take the ``gpu`` fixture and skip unless JAX's backend is a GPU;
on a GPU host run them with ``JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/``.
"""

import json
import os
import pickle
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    )

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


TINY_MODEL_CFG = {
    "dropout": {"embed": 0.1, "rnn": 0.1, "out": 0},
    "rnn_config": {
        "bi_rnn": True,
        "enc_layers": 2,
        "dec_layers": 2,
        "hidden_units": 16,
        "embedding_units": 8,
        "attn_units": 16,
        "n_attn": 1,
        "feed_attn": True,
        "ln": False,
    },
    "cnn_config": {
        "bn": True,
        "cnn_layers": [
            {"in_channels": None, "out_channels": 8, "ksize": [3, 13],
             "stride": [2, 13], "pad": [1, 0]},
            {"in_channels": None, "out_channels": 16, "ksize": [3, 1],
             "stride": [2, 1], "pad": [1, 0]},
        ],
    },
}


def make_tiny_experiment(root, n_train=12, n_dev=6, vocab_words=8,
                         batch_size=4, extras=None, optimizer=None,
                         seed=0):
    """Create a complete synthetic experiment directory tree.

    Layout: <root>/exp (configs+model dir), <root>/data (pickles, refs),
    <root>/speech/<set_key>/<utt>.npy features.
    """
    rng = np.random.RandomState(seed)
    exp = os.path.join(root, "exp")
    data = os.path.join(root, "data")
    speech = os.path.join(root, "speech")
    refs = os.path.join(data, "refs")
    os.makedirs(exp, exist_ok=True)
    os.makedirs(data, exist_ok=True)

    words = [f"w{i}".encode() for i in range(vocab_words)]
    specials = [b"_PAD", b"_GO", b"_EOS", b"_UNK"]
    all_types = specials + words
    w2i = {w: i for i, w in enumerate(all_types)}
    i2w = {i: w for w, i in w2i.items()}
    vocab = {"en_w": {"w2i": w2i, "i2w": i2w,
                      "freq": {w: 5 for w in words}}}

    sets = {"tiny_train": n_train, "tiny_dev": n_dev}
    map_dict, info_dict = {}, {}
    for set_key, n in sets.items():
        map_dict[set_key] = {}
        info_dict[set_key] = {}
        os.makedirs(os.path.join(speech, set_key), exist_ok=True)
        for i in range(n):
            utt = f"{set_key}_utt{i:03d}"
            T = int(rng.randint(30, 200))
            feats = rng.randn(T, 13).astype(np.float32)
            np.save(os.path.join(speech, set_key, f"{utt}.npy"), feats)
            n_words = int(rng.randint(2, 7))
            toks = [words[rng.randint(len(words))] for _ in range(n_words)]
            map_dict[set_key][utt] = {"en_w": toks}
            info_dict[set_key][utt] = {"sp": T, "en_w": n_words}

    for name, obj in [("tiny.vocab", vocab), ("tiny.map", map_dict),
                      ("tiny.info", info_dict)]:
        with open(os.path.join(data, name), "wb") as f:
            pickle.dump(obj, f)

    # refs for dev (single reference = the target sentence)
    dev_refs = os.path.join(refs, "tiny_dev")
    os.makedirs(dev_refs, exist_ok=True)
    dev_utts = sorted(map_dict["tiny_dev"].keys())
    with open(os.path.join(dev_refs, "eval.ids"), "w") as f:
        f.write("\n".join(dev_utts) + "\n")
    with open(os.path.join(dev_refs, "ref.en0"), "w") as f:
        for u in dev_utts:
            f.write(" ".join(w.decode()
                             for w in map_dict["tiny_dev"][u]["en_w"]) + "\n")

    train_cfg = {
        "seed": "tiny-seed",
        "iters_save": 2,
        "train_set": "tiny_train",
        "dev_set": "tiny_dev",
        "extras": dict({"random_out": 0, "speech_noise": 0.1,
                        "teach_ratio": 0.8}, **(extras or {})),
        "data": {
            "enc_key": "sp",
            "dec_key": "en_w",
            "speech_path": speech,
            "map_path": os.path.join(data, "tiny.map"),
            "vocab_path": os.path.join(data, "tiny.vocab"),
            "max_pred": 16,
            "info_path": os.path.join(data, "tiny.info"),
            "refs_path": refs,
            "n_evals": 1,
            "buckets_num": 4,
            "buckets_width": 50,
            "train_scale": 1,
            "zero_input": 0.1,
            "target_pad_multiple": 8,
        },
        "optimizer": dict({"type": 0, "lr": 0.01, "l2": 0.0001,
                           "grad_clip": 2, "grad_noise_eta": 0,
                           "freeze": []}, **(optimizer or {})),
        "batch_size": batch_size,
    }

    with open(os.path.join(exp, "model_cfg.json"), "w") as f:
        json.dump(TINY_MODEL_CFG, f)
    with open(os.path.join(exp, "train_cfg.json"), "w") as f:
        json.dump(train_cfg, f)

    return exp


@pytest.fixture
def gpu():
    """For tests marked ``gpu``: skip unless JAX's default backend is a
    GPU.  Decided here, when the test runs, so that every xdist worker
    collects the same tests."""
    backend = jax.default_backend()
    if backend != "gpu":
        pytest.skip(f"needs a GPU; JAX's default backend is {backend!r}")


@pytest.fixture
def tiny_exp(tmp_path):
    return make_tiny_experiment(str(tmp_path))
