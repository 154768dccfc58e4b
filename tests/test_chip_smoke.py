"""chip_smoke.py: its device check, output contract and option handling
on the CPU, and each one-card phase function at a tiny width (the
script's own ``main`` runs them at full width, on a GPU only)."""

import copy
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from tests.conftest import TINY_MODEL_CFG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from ast_tpu.utils import device  # noqa: E402

H100_LINE = "NVIDIA H100 80GB HBM3, 700.00 W"


def _tiny_sizes():
    return chip_smoke.Sizes(
        mcfg=copy.deepcopy(TINY_MODEL_CFG), parity=(2, 40, 8),
        buckets=(0, 1), utts_per_bucket=8, batch=4, steps_per_dispatch=2,
        serve_batch=2, four_bucket=1, four_epochs=2)


# ---------------------------------------------------------------------------
# device identification
# ---------------------------------------------------------------------------

def test_device_check_refuses_cpu_and_names_it():
    with pytest.raises(device.NoGpuError, match="'cpu'"):
        device.require_gpu()


def test_device_info_reports_what_jax_reports():
    info = device.device_info()
    d = jax.devices()
    assert info == {"platform": d[0].platform, "kind": d[0].device_kind,
                    "count": len(d)}


@pytest.mark.parametrize("text,want", [
    (H100_LINE + "\n", [("NVIDIA H100 80GB HBM3", "700.00 W")]),
    (H100_LINE + "\n" + H100_LINE.replace("700.00", "500.00") + "\n",
     [("NVIDIA H100 80GB HBM3", "700.00 W"),
      ("NVIDIA H100 80GB HBM3", "500.00 W")]),
])
def test_parse_recorded_nvidia_smi(text, want):
    got = device.parse_nvidia_smi(text)
    assert [(c["name"], c["power_limit"]) for c in got] == want


@pytest.mark.parametrize("text", ["", "no comma here\n"])
def test_parse_nvidia_smi_rejects_garbage(text):
    with pytest.raises(ValueError):
        device.parse_nvidia_smi(text)


def test_missing_nvidia_smi_is_an_error():
    with pytest.raises(FileNotFoundError, match="not found"):
        device.nvidia_smi("nvidia-smi-that-does-not-exist")


# ---------------------------------------------------------------------------
# main: device check, option handling, output contract
# ---------------------------------------------------------------------------

def test_main_on_cpu_exits_nonzero_without_ok(capsys):
    """main never skips the device check: on the CPU it stops there."""
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "'cpu'" in out.err


def test_script_alone_fails(tmp_path):
    """Copied into a directory with nothing else of the repo, the script
    exits non-zero and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def _stub_device(calls, count):
    def device_phase(log, require=True):
        calls.append("device")
        log(f"nvidia-smi: {H100_LINE}")
        return {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                "count": count}
    return device_phase


@pytest.fixture()
def fake_gpu(monkeypatch, tmp_path):
    """Stub every phase of chip_smoke; record which ones run."""
    calls = []
    monkeypatch.setattr(chip_smoke, "phase_device", _stub_device(calls, 1))
    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path))
    for name in ("parity", "train", "beam", "serve", "four"):
        def stub(*a, _name=name, **k):
            calls.append(_name)
            return {"recipe_f32": "exp"} if _name == "train" else None
        monkeypatch.setattr(chip_smoke, f"phase_{name}", stub)
    return calls


def test_last_line_is_the_contract(fake_gpu, capsys):
    assert chip_smoke.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == ('{"ok": true, "device": {"platform": "gpu", '
                         '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert any(H100_LINE in l for l in lines[:-1])
    assert fake_gpu == ["device", "parity", "train", "beam", "serve"]


def test_four_selects_only_its_phase(fake_gpu, capsys, monkeypatch):
    monkeypatch.setattr(chip_smoke, "phase_device",
                        _stub_device(fake_gpu, 4))
    assert chip_smoke.main(["--four"]) == 0
    assert fake_gpu == ["device", "four"]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["device"]["count"] == 4


# ---------------------------------------------------------------------------
# the phase functions themselves, at a tiny width on the CPU
# ---------------------------------------------------------------------------

def test_phase_device_without_requirement():
    info = chip_smoke.phase_device(chip_smoke.Log(), require=False)
    assert info["platform"] == "cpu"


def test_phase_parity_tiny():
    """XLA:CPU has no kernel for the bf16 encoder einsum, so the CPU run
    takes the two float32 settings."""
    res = chip_smoke.phase_parity(_tiny_sizes(), chip_smoke.Log(),
                                  settings=("highest", "default"))
    assert res["highest"]["loss_rel_err_teacher"] <= 1e-4
    assert res["highest"]["greedy_rows_diverged"] == 0


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    sizes = _tiny_sizes()
    root = str(tmp_path_factory.mktemp("smoke"))
    exps = chip_smoke.phase_train(
        sizes, root, chip_smoke.Log(),
        chip_smoke.train_configs(sizes, compute_dtype="float32"))
    return sizes, exps


def test_phase_train_tiny(trained):
    _, exps = trained
    assert sorted(exps) == ["bf16_cache_g4", "recipe_f32"]
    for exp in exps.values():
        assert os.path.exists(os.path.join(exp, "dev.log"))


def test_phase_beam_tiny(trained):
    _, exps = trained
    chip_smoke.phase_beam(exps["recipe_f32"], chip_smoke.Log())


def test_phase_serve_tiny(trained):
    sizes, exps = trained
    assert chip_smoke.can_serialize()
    how = chip_smoke.phase_serve(sizes, exps["recipe_f32"], chip_smoke.Log())
    assert how.startswith("HTTP")


def test_phase_serve_without_flatbuffers_runs_exported_programs(
        trained, monkeypatch, capsys):
    """A host without jax.export's serialization still runs the exported
    programs, says the file and HTTP path was held, and checks texts."""
    sizes, exps = trained
    monkeypatch.setattr(chip_smoke, "can_serialize", lambda: False)
    how = chip_smoke.phase_serve(sizes, exps["recipe_f32"], chip_smoke.Log())
    assert "in process" in how
    assert "HELD" in capsys.readouterr().out


@pytest.mark.parametrize("err,want", [
    (8e-7, "float32"), (4e-4, "TF32 or coarser"), (3e-3, "TF32 or coarser"),
])
def test_precision_class(err, want):
    assert chip_smoke.precision_class(err) == want


def test_matmul_precision_on_cpu_is_float32():
    errs = chip_smoke.matmul_precision(n=128)
    assert set(errs) == {"default", "highest"}
    assert all(chip_smoke.precision_class(e) == "float32"
               for e in errs.values())


def test_parity_bounds_cover_every_setting():
    """Each setting gates its teacher-forced loss; the default precision's
    bound is tighter than bf16's, so a silent drop to bf16 fails."""
    b = chip_smoke.PARITY_BOUNDS
    assert set(b) == {"highest", "default", "bf16"}
    assert all(v["teacher"] for v in b.values())
    assert b["default"]["teacher"] < b["bf16"]["teacher"]
    assert set(chip_smoke.TOKEN_EXACT) <= set(b)


def test_phase_four_tiny_on_virtual_devices(tmp_path):
    """conftest's 8 virtual CPU devices stand in for four cards."""
    chip_smoke.phase_four(_tiny_sizes(), str(tmp_path), chip_smoke.Log())


# ---------------------------------------------------------------------------
# the same phases on a GPU (skipped here)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_phase_parity_full_width_on_gpu(gpu):
    res = chip_smoke.phase_parity(chip_smoke.full_sizes(),
                                  chip_smoke.Log())
    assert set(res) == set(chip_smoke.PARITY_BOUNDS)
