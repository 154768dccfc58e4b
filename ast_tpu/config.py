"""Experiment configuration.

An experiment directory holds two JSON files — ``model_cfg.json`` (network
architecture) and ``train_cfg.json`` (data paths, optimizer, extras) — with
the exact same schema as the reference (reference: config.py:15-31,
experiments/es_en_20h/*.json), so existing experiment dirs run unchanged.

On load we inject:
- ``model["rnn_config"]["dec_vocab_size"]`` from the vocab pickle
  (reference: config.py:23-25)
- ``model["model_dir"] = cfg_path`` (reference: config.py:29)

Defaults for optional knobs are centralized here instead of being probed
defensively at use sites (reference probes with ``in`` checks at
seq2seq.py:107-113).
"""

import json
import os
import pickle


# Optimizer type enum (reference: nn.py:38-39)
OPT_ADAM = 0
OPT_SGD = 1

# Optional model_cfg knobs -> default values (reference: seq2seq.py:91,107,111)
_RNN_DEFAULTS = {
    "n_attn": 1,
    "feed_attn": True,
    "linear_proj": False,
    "ln": False,
    # legacy enc_dec.py knob: ReLU on every LSTM layer output in both
    # encoder and decoder (reference: enc_dec.py:282-283, 288, 304)
    "rnn_relu": False,
}

# Optional train_cfg knobs -> defaults. `weight_noise` / `curriculum` /
# per-bucket batch sizes come from the reference's legacy path
# (nmt_run.py:406-446, 850-854) and are first-class options here.
_TRAIN_DEFAULTS = {
    "iters_save": 10,
}

_EXTRAS_DEFAULTS = {
    "random_out": 0,
    "speech_noise": 0,
    "teach_ratio": 1.0,
    # Legacy-path capabilities carried forward (reference: nmt_run.py:850-854)
    "weight_noise_iter": 0,   # epoch >= this (and > 0) => add weight noise
    "weight_noise_mean": 0.0,
    "weight_noise_sigma": 0.0,
    # numerics: "float32" | "bfloat16" compute for matmul-heavy ops
    "compute_dtype": "float32",
    # train-batch FEATURE dtype on the host->device wire ("float32" |
    # "bfloat16" | "float16"); narrow halves the dominant transfer and
    # is widened on device before any compute.  Not bit-exact vs f32 —
    # explicit opt-in for transfer-bound hosts
    "transfer_dtype": "float32",
    # threads assembling + staging train batches ahead of the step
    # (order-preserving, bit-identical results at any value): >1
    # overlaps host->device transfers
    "prefetch_workers": 2,
    # label smoothing epsilon for the train-path cross entropy
    # (models/seq2seq.py forward_loss); 0.0 = exact reference loss
    "label_smoothing": 0.0,
    # >1: fuse that many consecutive same-bucket train batches into ONE
    # jitted dispatch (lax.scan over steps) — identical math to single
    # steps, amortizes per-dispatch host overhead; the dataloader groups
    # the shuffled order into same-bucket runs deterministically
    "steps_per_dispatch": 1,
    # pad each bucket's last partial batch to a repeated-half of the
    # bucket batch size instead of the full size (recovers the ~8%
    # real-vs-padded-slot throughput gap; a few extra cached compile
    # shapes).  Not in the reference: Chainer ran the true ragged tail.
    "shrink_tail_batches": True,
    # rematerialize the forward pass in the backward (jax.checkpoint):
    # ~1 extra forward of FLOPs buys not holding activations in HBM —
    # for long-utterance / very large-batch configs
    "remat": False,
    # persistent XLA compilation cache: None (default: <checkout>/.jax_cache),
    # False to disable, or an explicit directory.  Re-runs, resumes and
    # decode passes reload compiled executables instead of compiling each
    # bucket shape again.  Env JAX_COMPILATION_CACHE_DIR wins
    # (utils/compile_cache.py).
    "compile_cache": None,
    # upload each bucket's padded feature matrix to HBM once and gather
    # train batches on device (data/device_cache.py) — per-batch wire
    # traffic drops from the feature block to indices+mask+targets.
    # Bit-identical losses to host feeding (f32 cache).  Precomputed-
    # feature mode only; a 20h Fisher split is ~375 MB f32.
    "hbm_cache": False,
    # "bfloat16" halves the cache's HBM (one rounding at upload — NOT
    # bit-exact vs host feeding; explicit opt-in like transfer_dtype)
    "hbm_cache_dtype": "float32",
    # decode dispatches kept in flight during predict/decode_beam_set:
    # materializing a batch blocks until it finishes, so depth 1 parks
    # the device through the host's hyp postprocess; depth 2 overlaps
    # them.  Identical outputs at any depth (FIFO drain).  None = auto:
    # 2, except 1 when the outputs are memory-heavy (save_attn beams
    # carry a (B, N, stop_limit, T') history per in-flight batch —
    # doubling THAT near the device-memory limit can OOM a config that
    # decoded fine before pipelining existed).
    "decode_pipeline": None,
}

_DATA_DEFAULTS = {
    "train_scale": 1,
    "zero_input": 0,
    "n_evals": 1,
    "dataloader": "fisher",
    # quantization step for decoder-length padding (static shapes for XLA);
    # not present in the reference (it pads to the ragged batch max).
    "target_pad_multiple": 16,
    # in-graph SpecAugment (arXiv:1904.08779), beyond-reference: a dict
    # {"freq_masks", "freq_width", "time_masks", "time_width", "time_p"}
    # enables time/frequency masking inside the jitted train step (zero
    # host cost, deterministic per (epoch_key, batch)); None disables.
    # The reference's zero_input frame dropout is independent of this.
    "spec_augment": None,
}

_OPT_DEFAULTS = {
    "type": OPT_ADAM,
    "lr": 1e-3,
    "l2": 0,
    "grad_clip": 0,
    "grad_noise_eta": 0,
    "freeze": [],
    # Legacy linear LR scaling for SGD (reference: nmt_run.py:567-576)
    "lr_scale": 1,
    # dtype of Adam's first-moment accumulator ("bfloat16" halves its
    # HBM footprint/traffic; second moment + amsgrad max stay f32 for
    # numerics).  None/"" => float32, the reference's behavior.
    "moments_dtype": None,
}

_PARALLEL_DEFAULTS = {
    # data-parallel shards; 0 => use all local devices
    "data_axis": 0,
    # tensor-model-parallel shards for vocab-dim matrices; 1 => off
    "model_axis": 1,
}


# model_cfg rnn_config keys of kernels that no longer exist; a config
# carrying one is refused rather than silently run on another path
_REMOVED_RNN_KEYS = ("fused_encoder", "fused_decoder", "fused_infer",
                     "fused_interpret", "fused_tokens_per_step")


def check_rnn_config(rnn: dict) -> None:
    """Refuse ``rnn_config`` keys that select removed code paths."""
    bad = [k for k in rnn if k in _REMOVED_RNN_KEYS]
    if bad:
        raise ValueError(
            f"model_cfg rnn_config key(s) {', '.join(bad)} are no longer "
            "supported: the fused Pallas kernels were removed and every "
            "model runs the lax.scan path; delete the key(s)")


def _fill(dst: dict, defaults: dict) -> dict:
    for k, v in defaults.items():
        dst.setdefault(k, v)
    return dst


class Config:
    """Load and normalize an experiment directory's configuration."""

    def __init__(self, cfg_path: str) -> None:
        self.cfg_path = cfg_path
        with open(os.path.join(cfg_path, "model_cfg.json"), "r") as f:
            self.model = json.load(f)
        with open(os.path.join(cfg_path, "train_cfg.json"), "r") as f:
            self.train = json.load(f)

        # Fill defaults
        _fill(self.train, _TRAIN_DEFAULTS)
        _fill(self.train.setdefault("extras", {}), _EXTRAS_DEFAULTS)
        _fill(self.train.setdefault("data", {}), _DATA_DEFAULTS)
        _fill(self.train.setdefault("optimizer", {}), _OPT_DEFAULTS)
        _fill(self.train.setdefault("parallel", {}), _PARALLEL_DEFAULTS)
        check_rnn_config(self.model.setdefault("rnn_config", {}))
        _fill(self.model["rnn_config"], _RNN_DEFAULTS)

        # Inject decoder vocab size from the vocab pickle
        vocab_path = self.train["data"]["vocab_path"]
        dec_key = self.train["data"]["dec_key"]
        with open(vocab_path, "rb") as f:
            vocab = pickle.load(f)
        if self.train["data"].get("limit_vocab", False):
            # limited flat vocab (legacy capability, reference:
            # nmt_run.py:657-660): top-level w2i, OOV targets dropped
            self.model["rnn_config"]["dec_vocab_size"] = len(vocab["w2i"])
        else:
            self.model["rnn_config"]["dec_vocab_size"] = (
                len(vocab[dec_key]["w2i"]))

        # text-encoder mode (legacy capability, reference:
        # enc_dec.py:162-164): non-speech enc_key embeds source tokens
        enc_key = self.train["data"].get("enc_key", "sp")
        if enc_key != "sp":
            self.model["rnn_config"]["enc_vocab_size"] = (
                len(vocab[enc_key]["w2i"]))

        self.model["model_dir"] = cfg_path
