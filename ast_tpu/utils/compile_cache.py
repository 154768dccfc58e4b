"""Persistent XLA compilation cache for the CLIs.

Every distinct (bucket shape x batch size x config) pair costs a fresh
XLA compile, and the published recipe touches ~20 bucket shapes.  The
reference pays that cost once per *process* (Chainer has no AOT compile
step); here a second ``train.py`` run, a ``beam.py`` pass after training,
or a resume after preemption would all recompile the identical programs
from scratch.  JAX's persistent compilation cache keys compiled
executables on (HLO, compile options, backend version) and reloads them
across processes, so only the first-ever run of a config pays the
compile time.

Resolution order:

1. env ``JAX_COMPILATION_CACHE_DIR`` — JAX reads it itself; this module
   then sets no other path;
2. the ``setting`` argument (``extras.compile_cache`` in
   ``train_cfg.json``) — a directory path, or ``False``/``"off"`` to
   disable;
3. otherwise the cache is on, at the fixed path ``<checkout>/.jax_cache``
   (the directory holding the ``ast_tpu`` package).  A fixed path matters:
   the directory is part of what a later process looks up, so a path made
   from a temporary name, a pid or the time would never hit.

Enabling is idempotent and never fatal: an unwritable directory degrades
to a one-line warning (JAX itself treats persistent-cache failures as
warnings unless ``jax_raise_persistent_cache_errors`` is set).  How long a
compile must take before it is stored is JAX's own
``JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS``.
"""

import os
import warnings

_DISABLE_VALUES = ("0", "off", "false", "no", "")
_enabled_dir = None

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def resolve_cache_dir(setting=None):
    """The directory steps 2-3 of the order above select, or ``None``
    when disabled.  ``setting``: ``None``/``True`` (default path),
    ``False`` or a disable string, or a directory path."""
    if setting is False or (
            isinstance(setting, str)
            and setting.strip().lower() in _DISABLE_VALUES):
        return None
    if isinstance(setting, str):
        return os.path.abspath(os.path.expanduser(setting))
    return DEFAULT_DIR


def enable_compile_cache(setting=None):
    """Apply the order above; returns the directory in use, or ``None``
    when disabled.  Safe to call multiple times (e.g. once per CLI main
    and once in ``NN.__init__``); the first successful call wins.
    """
    global _enabled_dir

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env                  # JAX reads it itself: nothing to set
    path = resolve_cache_dir(setting)
    if path is None:
        return None
    if _enabled_dir is not None:
        return _enabled_dir
    try:
        import jax

        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
        _enabled_dir = path
        return path
    except Exception as e:  # pragma: no cover - environment-specific
        warnings.warn(f"persistent compilation cache disabled: {e}")
        return None
