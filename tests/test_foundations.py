"""Symbols / config / bucketing / vocab / BLEU foundations."""

import os
import pickle

import numpy as np
import pytest

from ast_tpu.config import Config
from ast_tpu.data.buckets import buckets_main, create_buckets
from ast_tpu.data.vocab import build_map_and_info, build_vocab
from ast_tpu.eval.bleu import Eval, corpus_bleu
from ast_tpu.eval.metrics import unigram_precision_recall
from ast_tpu.symbols import SYMBOLS


def test_symbols_contract():
    assert SYMBOLS.PAD_ID == 0
    assert SYMBOLS.GO_ID == 1
    assert SYMBOLS.EOS_ID == 2
    assert SYMBOLS.UNK_ID == 3
    assert SYMBOLS.START_VOCAB == [b"_PAD", b"_GO", b"_EOS", b"_UNK"]


def test_config_loads_and_injects(tiny_exp):
    cfg = Config(tiny_exp)
    assert cfg.model["rnn_config"]["dec_vocab_size"] == 12  # 4 specials + 8
    assert cfg.model["model_dir"] == tiny_exp
    assert cfg.train["extras"]["teach_ratio"] == 0.8
    # defaults filled
    assert cfg.model["rnn_config"]["n_attn"] == 1
    assert cfg.train["optimizer"]["lr_scale"] == 1


@pytest.mark.parametrize("key", ["fused_encoder", "fused_decoder",
                                 "fused_infer", "fused_interpret",
                                 "fused_tokens_per_step"])
def test_config_rejects_removed_kernel_keys(tiny_exp, key):
    """A model config that still selects a removed kernel fails at load
    and names the key, instead of silently running another path."""
    import json

    path = os.path.join(tiny_exp, "model_cfg.json")
    with open(path) as f:
        mcfg = json.load(f)
    mcfg["rnn_config"][key] = False
    with open(path, "w") as f:
        json.dump(mcfg, f)
    with pytest.raises(ValueError, match=key):
        Config(tiny_exp)


def test_bucket_formula():
    cat = {"a": {"sp": 0}, "b": {"sp": 79}, "c": {"sp": 80},
           "d": {"sp": 9999}}
    b = create_buckets(cat, num_b=4, width_b=80, key="sp", scale=1, seed="x")
    assert "a" in b["buckets"][0] and "b" in b["buckets"][0]
    assert "c" in b["buckets"][1]
    assert "d" in b["buckets"][3]  # clamped to last bucket


def test_bucket_scale_subsampling():
    cat = {f"u{i}": {"sp": 10} for i in range(100)}
    b1 = create_buckets(cat, 2, 80, "sp", scale=2, seed="s")
    assert len(b1["buckets"][0]) == 50
    b2 = create_buckets(cat, 2, 80, "sp", scale=2, seed="s")
    assert b1["buckets"][0] == b2["buckets"][0]  # deterministic


def test_buckets_main_persists(tmp_path):
    info = {"train": {f"u{i}": {"sp": i * 30} for i in range(10)},
            "dev": {"d0": {"sp": 10}}}
    out = buckets_main(str(tmp_path), 4, 50, "sp", info_dict=info)
    assert set(out.keys()) == {"train", "dev"}
    saved = pickle.load(open(tmp_path / "buckets_sp.dict", "rb"))
    assert saved["train"]["num_b"] == 4


def test_meteor_refs_match_reference_file(tmp_path):
    """export_meteor_refs reproduces the shipped meteor_4refs.en exactly."""
    from ast_tpu.eval.bleu import export_meteor_refs
    refs_dir = "/root/reference/data/fisher/refs/fisher_dev"
    if not os.path.exists(os.path.join(refs_dir, "meteor_4refs.en")):
        pytest.skip("reference data not mounted")
    out = export_meteor_refs(refs_dir, 4,
                             out_path=str(tmp_path / "meteor.en"))
    with open(out, encoding="utf-8") as f:
        got = f.read()
    with open(os.path.join(refs_dir, "meteor_4refs.en"),
              encoding="utf-8") as f:
        want = f.read()
    assert got == want


def test_bucket_parity_with_reference_info():
    """Golden check on the real fisher_20h.info shipped with the reference."""
    info_path = "/root/reference/data/fisher/fisher_20h.info"
    if not os.path.exists(info_path):
        pytest.skip("reference data not mounted")
    with open(info_path, "rb") as f:
        info = pickle.load(f)
    assert len(info["fisher_train"]) == 17306
    b = create_buckets(info["fisher_dev"], 20, 80, "sp", 1, "haha")
    total = sum(len(x) for x in b["buckets"])
    assert total == 3977
    # every utt's bucket satisfies the formula
    for i, bucket in enumerate(b["buckets"]):
        for u in bucket[:5]:
            assert min(info["fisher_dev"][u]["sp"] // 80, 19) == i


def test_build_vocab_specials_first():
    vocab = build_vocab({"en_w": [["a", "b", "a"], ["a", "c"]]})
    w2i = vocab["en_w"]["w2i"]
    assert w2i[b"_PAD"] == 0 and w2i[b"_UNK"] == 3
    assert w2i[b"a"] == 4  # most frequent first
    assert vocab["en_w"]["i2w"][4] == b"a"


def test_build_map_and_info():
    m, i = build_map_and_info(
        {"train": {"u0": {"en_w": ["x", "y"]}}},
        {"train": {"u0": 42}})
    assert m["train"]["u0"]["en_w"] == [b"x", b"y"]
    assert i["train"]["u0"] == {"sp": 42, "en_w": 2}


def test_bleu_matches_nltk():
    import nltk.translate.bleu_score as nb

    rng = np.random.RandomState(0)
    vocab = [f"w{i}" for i in range(20)]
    refs, hyps = [], []
    for _ in range(30):
        n_refs = rng.randint(1, 5)
        refs.append([
            [vocab[rng.randint(20)] for _ in range(rng.randint(3, 12))]
            for _ in range(n_refs)
        ])
        hyps.append([vocab[rng.randint(20)]
                     for _ in range(rng.randint(1, 12))])

    smooth = nb.SmoothingFunction()
    expected = nb.corpus_bleu(refs, hyps, weights=(0.25,) * 4,
                              smoothing_function=smooth.method2)
    got = corpus_bleu(refs, hyps)
    assert abs(got - expected) < 1e-12


def test_bleu_empty_hyps():
    assert corpus_bleu([[["a", "b"]]], [[]]) == 0.0


def test_eval_protocol(tmp_path):
    d = tmp_path / "refs"
    d.mkdir()
    (d / "eval.ids").write_text("u1\nu0\n")
    (d / "ref.en0").write_text("a b c\nx y\n")
    ev = Eval(str(d), 1)
    assert ev.ids == ["u1", "u0"]
    hyps = {"u0": ["x", "y"], "u1": ["a", "b", "c"]}
    # perfect hyps on a tiny corpus: smoothing still caps this below 1.0;
    # pin exact parity with NLTK instead
    import nltk.translate.bleu_score as nb
    expected = nb.corpus_bleu(
        [ev.refs[i] for i in range(2)],
        [hyps[u] for u in ev.ids],
        smoothing_function=nb.SmoothingFunction().method2)
    assert abs(ev.calc_bleu(hyps) - expected) < 1e-12
    out = tmp_path / "hyp.en"
    ev.write_to_file(hyps, str(out))
    assert out.read_text() == "a b c\nx y\n"


def test_unigram_precision_recall():
    refs = [[["a", "b", "c"]]]
    hyps = [["a", "b", "x"]]
    prec, rec = unigram_precision_recall(refs, hyps)
    assert abs(prec - 100 * 2 / 3) < 1e-9
    assert abs(rec - 100 * 2 / 3) < 1e-9
