"""Serving-artifact export (ast_tpu/serving.py + cli/export_model.py).

Pins the portability contract: an exported artifact deserializes from
bytes alone and reproduces the in-process decoder's outputs exactly,
and the CLI writes runnable artifacts + a framework-free manifest from
an experiment directory.
"""

import copy
import json
import os

import numpy as np
import pytest

import jax

from conftest import TINY_MODEL_CFG, make_tiny_experiment

from ast_tpu import serving
from ast_tpu.models import seq2seq


def _mcfg(vocab=12):
    m = copy.deepcopy(TINY_MODEL_CFG)
    m["rnn_config"]["dec_vocab_size"] = vocab
    return m


def test_greedy_export_roundtrip(tmp_path):
    mcfg = _mcfg()
    params, state = seq2seq.init_model(jax.random.PRNGKey(0), mcfg)
    B, T, stop = 4, 40, 8
    X = np.random.RandomState(0).randn(B, T, 13).astype(np.float32)

    exp = serving.export_greedy(params, state, mcfg, B, T, stop,
                                platforms=("cpu",))
    path = str(tmp_path / "greedy.jaxexp")
    assert serving.save_artifact(exp, path) > 0

    loaded = serving.load_artifact(path)
    preds, n_steps = loaded.call(X)
    ref_preds, ref_steps = seq2seq.predict_greedy(
        params, state, mcfg, X, stop)
    np.testing.assert_array_equal(np.asarray(preds),
                                  np.asarray(ref_preds))
    assert int(n_steps) == int(ref_steps)

    # repeat calls must hit the jit cache, not re-trace and re-lower the
    # whole weights-baked-in module on every call
    preds2, _ = loaded.call(X)
    np.testing.assert_array_equal(np.asarray(preds2), np.asarray(preds))
    assert isinstance(loaded, serving.LoadedArtifact)
    assert loaded.call._cache_size() == 1


def test_beam_export_roundtrip(tmp_path):
    from ast_tpu.ops.beam import make_beam_decoder

    mcfg = _mcfg()
    params, state = seq2seq.init_model(jax.random.PRNGKey(1), mcfg)
    B, T, N, K, stop = 2, 40, 2, 2, 6
    X = np.random.RandomState(1).randn(B, T, 13).astype(np.float32)

    exp = serving.export_beam(params, state, mcfg, B, T, N, K, stop,
                              platforms=("cpu",))
    path = str(tmp_path / "beam.jaxexp")
    serving.save_artifact(exp, path)

    hyps, scores, lengths = serving.load_artifact(path).call(X)
    decode = make_beam_decoder(mcfg, N, K, stop)
    ref_hyps, ref_scores, ref_lengths = decode(params, state, X)
    np.testing.assert_array_equal(np.asarray(hyps), np.asarray(ref_hyps))
    np.testing.assert_allclose(np.asarray(scores),
                               np.asarray(ref_scores), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(lengths),
                                  np.asarray(ref_lengths))


def test_export_cli_default_frames_ladder(tmp_path):
    """No --frames: a quarter-point ladder + the trainer's truncation
    cap, so serving padding stays near training conditions (tiny exp:
    4 buckets x 50 -> [50, 100, 150, 250])."""
    from ast_tpu.cli import export_model

    exp_dir = make_tiny_experiment(str(tmp_path))
    out = export_model.main(
        ["-m", exp_dir, "--batch", "1", "--platforms", "cpu",
         "--dtype", "float32"])
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    assert [e["frames"] for e in manifest["entries"]] == [50, 100, 150, 250]


def test_export_cli_writes_runnable_artifacts(tmp_path):
    from ast_tpu.cli import export_model

    exp_dir = make_tiny_experiment(str(tmp_path))
    out = export_model.main(
        ["-m", exp_dir, "--batch", "2", "--frames", "40",
         "--beam", "2,2", "--platforms", "cpu", "--dtype", "float32"])

    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    kinds = sorted(e["kind"] for e in manifest["entries"])
    assert kinds == ["beam", "greedy"]
    assert manifest["symbols"]["EOS"] == 2

    # the id->token table lets a server detokenize without pickles
    with open(os.path.join(out, manifest["vocab"])) as f:
        vocab = json.load(f)
    assert vocab["1"] == "_GO"
    assert len(vocab) == manifest["dec_vocab_size"]

    greedy = next(e for e in manifest["entries"] if e["kind"] == "greedy")
    loaded = serving.load_artifact(os.path.join(out, greedy["file"]))
    X = np.random.RandomState(2).randn(2, 40, 13).astype(np.float32)
    preds, _ = loaded.call(X)
    assert np.asarray(preds).shape == (2, manifest["stop_limit"])


def test_quantize_params_error_bound_and_roundtrip(tmp_path):
    """int8 weight-only quantization: per-channel dequant error is
    bounded by scale/2, and the quantized artifact reproduces the
    in-process decode over dequantized params exactly."""
    from ast_tpu.serving import _is_q8, dequantize_params, quantize_params

    mcfg = _mcfg()
    params, state = seq2seq.init_model(jax.random.PRNGKey(2), mcfg)
    q = quantize_params(params, min_size=64)

    n_q = sum(_is_q8(x) for x in jax.tree.leaves(
        q, is_leaf=lambda x: _is_q8(x) or not isinstance(x, (dict, list))))
    assert n_q >= 4, "expected the big weight leaves to quantize"

    deq = dequantize_params(q)
    for w, d in zip(jax.tree.leaves(params), jax.tree.leaves(deq)):
        w, d = np.asarray(w, np.float32), np.asarray(d, np.float32)
        if w.ndim >= 2:
            # per-output-channel: OIHW conv -> axis 0, matmul -> last
            out_axis = 0 if w.ndim == 4 else w.ndim - 1
            red = tuple(i for i in range(w.ndim) if i != out_axis)
            amax = np.max(np.abs(w), axis=red, keepdims=True)
        else:
            amax = 0
        bound = np.broadcast_to(np.maximum(amax / 254.0 * 1.001, 1e-8),
                                w.shape)
        assert np.all(np.abs(w - d) <= bound) or w.shape == d.shape and \
            np.array_equal(w, d)

    B, T, stop = 2, 40, 8
    X = np.random.RandomState(3).randn(B, T, 13).astype(np.float32)
    exp = serving.export_greedy(params, state, mcfg, B, T, stop,
                                platforms=("cpu",), quantize=True,
                                q_min_size=64)
    path = str(tmp_path / "greedy_q8.jaxexp")
    qbytes = serving.save_artifact(exp, path)
    preds, _ = serving.load_artifact(path).call(X)
    ref_preds, _ = seq2seq.predict_greedy(
        deq, state, mcfg, X, stop)
    np.testing.assert_array_equal(np.asarray(preds), np.asarray(ref_preds))

    # the int8 constants make the artifact materially smaller.  Assert
    # on the absolute byte saving vs the number of quantized weight
    # elements (f32 -> int8 saves 3 B/elem minus per-channel scales),
    # not a whole-artifact ratio: on a tiny model the fixed StableHLO
    # module overhead dominates and makes any ratio threshold brittle.
    n_q_elems = sum(
        np.asarray(x[serving._Q8_KEY]).size for x in jax.tree.leaves(
            q, is_leaf=_is_q8) if _is_q8(x))
    fexp = serving.export_greedy(params, state, mcfg, B, T, stop,
                                 platforms=("cpu",))
    fbytes = serving.save_artifact(fexp, str(tmp_path / "greedy_f32.jaxexp"))
    assert fbytes - qbytes >= 2.5 * n_q_elems, (qbytes, fbytes, n_q_elems)


def test_export_cli_quantize(tmp_path):
    from ast_tpu.cli import export_model

    exp_dir = make_tiny_experiment(str(tmp_path))
    out = export_model.main(
        ["-m", exp_dir, "--batch", "1", "--frames", "40",
         "--platforms", "cpu", "--dtype", "float32",
         "--quantize", "int8", "--quantize-min-size", "64"])
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    assert "int8" in manifest["quantization"]
    entry = manifest["entries"][0]
    assert entry["file"].endswith("_q8.jaxexp")
    loaded = serving.load_artifact(os.path.join(out, entry["file"]))
    X = np.random.RandomState(4).randn(1, 40, 13).astype(np.float32)
    preds, _ = loaded.call(X)
    assert np.asarray(preds).shape == (1, manifest["stop_limit"])


def test_quantized_beam_export_roundtrip(tmp_path):
    """Quantized beam artifact == in-process beam decode over the
    dequantized params (exactness of the export mechanism, independent
    of quantization's accuracy effect)."""
    from ast_tpu.ops.beam import make_beam_decoder
    from ast_tpu.serving import dequantize_params, quantize_params

    mcfg = _mcfg()
    params, state = seq2seq.init_model(jax.random.PRNGKey(5), mcfg)
    B, T, N, K, stop = 2, 40, 2, 2, 6
    X = np.random.RandomState(6).randn(B, T, 13).astype(np.float32)

    exp = serving.export_beam(params, state, mcfg, B, T, N, K, stop,
                              platforms=("cpu",), quantize=True,
                              q_min_size=64)
    path = str(tmp_path / "beam_q8.jaxexp")
    serving.save_artifact(exp, path)
    hyps, scores, lengths = serving.load_artifact(path).call(X)

    deq = dequantize_params(quantize_params(params, min_size=64))
    decode = make_beam_decoder(mcfg, N, K, stop)
    ref_hyps, ref_scores, ref_lengths = decode(deq, state, X)
    np.testing.assert_array_equal(np.asarray(hyps), np.asarray(ref_hyps))
    np.testing.assert_allclose(np.asarray(scores),
                               np.asarray(ref_scores), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(lengths),
                                  np.asarray(ref_lengths))


@pytest.mark.parametrize("kind", ["greedy", "beam", "greedy_q8"])
def test_cuda_export_runs_its_cpu_lowering(tmp_path, kind):
    """Artifacts lowered for the default ("cpu", "cuda") platforms: the
    CUDA lowering needs no GPU at export time, the serialized artifact
    keeps both platforms, and its CPU lowering reproduces the in-process
    decode."""
    from ast_tpu.ops.beam import make_beam_decoder
    from ast_tpu.serving import dequantize_params, quantize_params

    mcfg = _mcfg()
    params, state = seq2seq.init_model(jax.random.PRNGKey(7), mcfg)
    B, T, stop = 2, 40, 6
    X = np.random.RandomState(8).randn(B, T, 13).astype(np.float32)
    if kind == "beam":
        exp = serving.export_beam(params, state, mcfg, B, T, 2, 2, stop)
        want = make_beam_decoder(mcfg, 2, 2, stop)(params, state, X)[0]
    else:
        q = kind.endswith("q8")
        exp = serving.export_greedy(params, state, mcfg, B, T, stop,
                                    quantize=q, q_min_size=64)
        ref_params = (dequantize_params(quantize_params(params, 64))
                      if q else params)
        want = seq2seq.predict_greedy(ref_params, state, mcfg, X, stop)[0]
    assert exp.platforms == ("cpu", "cuda")
    path = str(tmp_path / f"{kind}.jaxexp")
    serving.save_artifact(exp, path)
    loaded = serving.load_artifact(path)
    assert loaded.exported.platforms == ("cpu", "cuda")
    got = loaded.call(X)[0]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_default_platforms_are_cpu_and_cuda():
    import inspect

    assert serving.DEFAULT_PLATFORMS == ("cpu", "cuda")
    for fn in (serving.export_greedy, serving.export_beam):
        assert inspect.signature(fn).parameters["platforms"].default == \
            ("cpu", "cuda")


def test_export_cli_default_platforms(tmp_path):
    """No --platforms: the manifest and the artifact carry cpu + cuda."""
    from ast_tpu.cli import export_model

    exp_dir = make_tiny_experiment(str(tmp_path))
    out = export_model.main(["-m", exp_dir, "--batch", "1", "--frames",
                             "40", "--dtype", "float32"])
    with open(os.path.join(out, "manifest.json")) as f:
        entry = json.load(f)["entries"][0]
    assert entry["platforms"] == ["cpu", "cuda"]
    loaded = serving.load_artifact(os.path.join(out, entry["file"]))
    assert loaded.exported.platforms == ("cpu", "cuda")


@pytest.mark.parametrize("platforms", [None, "cuda", "gpu,cpu"])
def test_serve_workers_refused_unless_cpu(monkeypatch, capsys, platforms):
    """--workers N > 1 starts one process per worker; only one process
    can use a GPU, so it is refused (before any device is opened) unless
    JAX_PLATFORMS=cpu, and the error points to --replicas."""
    from ast_tpu.cli import serve

    if platforms is None:
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    else:
        monkeypatch.setenv("JAX_PLATFORMS", platforms)
    with pytest.raises(SystemExit) as e:
        serve.main(["-d", "unused", "--port", "8123", "--workers", "2"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "--replicas" in err and "JAX_PLATFORMS=cpu" in err
