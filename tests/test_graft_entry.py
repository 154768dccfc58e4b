"""Entry points of ``__graft_entry__``: the flagship compile check and
the multi-device dry run, both in process on JAX's own devices (no
probe process, no fallback to another platform)."""

import sys

sys.path.insert(0, ".")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import __graft_entry__ as graft  # noqa: E402


def _record_python_children(monkeypatch):
    """Record every Python child process started through subprocess.run
    (a probe or rehearsal process); other children pass through."""
    started, real = [], graft.subprocess.run

    def run(cmd, *a, **k):
        if isinstance(cmd, (list, tuple)) and cmd[0] == sys.executable:
            started.append(cmd)
        return real(cmd, *a, **k)

    monkeypatch.setattr(graft.subprocess, "run", run)
    return started


def test_entry_compiles_on_cpu_without_probe(monkeypatch):
    started = _record_python_children(monkeypatch)
    assert not hasattr(graft, "_default_backend_alive")
    fn, args = graft.entry()
    lowered = jax.jit(fn).lower(*args)
    assert lowered.compile() is not None
    params, state, X, y, key = args
    assert X.shape == (4, 320, 13)
    assert params["dec"]["out_w"].shape == (512, 1098)
    assert started == []


def test_dryrun_multichip_runs_in_process(monkeypatch, capsys):
    """conftest gives 8 virtual CPU devices, so dryrun_multichip(4) runs
    here on a 2x2 mesh instead of starting its rehearsal process."""
    started = _record_python_children(monkeypatch)
    assert len(jax.devices()) >= 4
    graft.dryrun_multichip(4)
    out = capsys.readouterr().out
    assert "dryrun_multichip(4) ok: mesh={'data': 2, 'model': 2}" in out
    assert "harness ok" in out
    losses = [float(v) for v in out.split("losses=[")[1].split("]")[0]
              .split(",")]
    assert np.all(np.isfinite(losses))
    assert started == []
