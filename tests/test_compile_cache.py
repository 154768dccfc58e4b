"""Persistent XLA compilation cache (ast_tpu/utils/compile_cache.py).

The reference recompiles everything per process (Chainer define-by-run
has no cross-process compile artifact at all); here re-runs / resumes /
post-training decode passes reload compiled executables.  These tests pin
the resolution order (``JAX_COMPILATION_CACHE_DIR``, then
``extras.compile_cache``, then the fixed ``<checkout>/.jax_cache``)
in-process and the actual cross-process reload in subprocesses.
"""

import os
import subprocess
import sys

import pytest

import ast_tpu.utils.compile_cache as cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset_module_state(monkeypatch):
    import jax

    monkeypatch.setattr(cc, "_enabled_dir", None)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    yield
    # leave the session-wide jax config as it was
    jax.config.update("jax_compilation_cache_dir", before)


def test_disabled_by_setting(tmp_path):
    # explicit disables never touch jax
    assert cc.enable_compile_cache(False) is None
    assert cc.enable_compile_cache("off") is None
    assert cc.enable_compile_cache("") is None


@pytest.mark.parametrize("env,setting,want", [
    ("ENV", "CFG", "ENV"),          # JAX's own variable wins
    ("ENV", False, "ENV"),          # ... even over a config disable
    (None, "CFG", "CFG"),           # then extras.compile_cache
    (None, False, None),
    (None, "off", None),
    (None, None, "DEFAULT"),        # then on by default, in the checkout
    (None, True, "DEFAULT"),
])
def test_resolution_order(tmp_path, monkeypatch, env, setting, want):
    names = {"ENV": str(tmp_path / "env"), "CFG": str(tmp_path / "cfg"),
             "DEFAULT": str(tmp_path / "default"), None: None}
    monkeypatch.setattr(cc, "DEFAULT_DIR", names["DEFAULT"])
    if env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", names[env])
    assert cc.enable_compile_cache(names.get(setting, setting)) == \
        names[want]


def test_jax_env_dir_is_left_to_jax(tmp_path, monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set the module reports that
    directory and sets no other path in JAX's config."""
    import jax

    env_dir = str(tmp_path / "envdir")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    before = jax.config.jax_compilation_cache_dir
    assert cc.enable_compile_cache(str(tmp_path / "cfgdir")) == env_dir
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "cfgdir").exists()


def test_config_path_sets_jax(tmp_path):
    import jax

    d = str(tmp_path / "cfgdir")
    assert cc.enable_compile_cache(d) == d
    assert os.path.isdir(d)
    assert jax.config.jax_compilation_cache_dir == d


def test_explicit_path_and_idempotence(tmp_path):
    d1 = str(tmp_path / "one")
    assert cc.enable_compile_cache(d1) == d1
    # second call (different path) keeps the first resolved dir
    assert cc.enable_compile_cache(str(tmp_path / "two")) == d1


def test_default_path_is_fixed_in_checkout():
    """The default is <checkout>/.jax_cache — never a temporary name, a
    pid or a time, which would miss on every later run — and git
    ignores it."""
    assert cc.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    assert cc.resolve_cache_dir() == cc.resolve_cache_dir(None) == \
        cc.DEFAULT_DIR
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


_CHILD = r"""
import logging, sys
logging.basicConfig(level=logging.DEBUG)
import jax
sys.path.insert(0, {repo!r})
from ast_tpu.utils.compile_cache import enable_compile_cache
assert enable_compile_cache() == {cache!r}
import jax.numpy as jnp
f = jax.jit(lambda x: (x @ x).sum() * 2.5)
print("RESULT", float(f(jnp.ones((32, 32)))))
"""


def test_cross_process_cache_hit(tmp_path):
    """Second process reloads the first process's compiled executable
    from JAX_COMPILATION_CACHE_DIR: the persistent-cache 'hit' log line
    appears for the jitted program and the numerical result is
    identical."""
    cache = str(tmp_path / "xla")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=cache,
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    script = _CHILD.format(repo=REPO, cache=cache)

    runs = []
    for _ in range(2):
        p = subprocess.run([sys.executable, "-c", script], env=env,
                           capture_output=True, text=True, timeout=300)
        assert p.returncode == 0, p.stderr[-2000:]
        runs.append(p)

    assert os.listdir(cache), "first run must write cache entries"
    r0 = [l for l in runs[0].stdout.splitlines() if l.startswith("RESULT")]
    r1 = [l for l in runs[1].stdout.splitlines() if l.startswith("RESULT")]
    assert r0 == r1 == ["RESULT 81920.0"]
    assert "Persistent compilation cache hit for 'jit__lambda'" in (
        runs[1].stdout + runs[1].stderr), \
        "second process must reload the compiled lambda from the cache"
