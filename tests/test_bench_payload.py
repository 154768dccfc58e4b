"""bench.py result payload and its device identification (no GPU
required).  The benchmark names the device every number ran on and has
no fallback: without a GPU it exits non-zero and prints no result."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DEV = {"device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                  "count": 1},
       "gpu": {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"},
       "nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W"}


@pytest.fixture()
def bench():
    spec = importlib.util.spec_from_file_location(
        "bench_under_test", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_payload_real_trainer_headline(bench):
    """The headline is the median warm NN.train_epoch epoch."""
    p = bench.train_payload(DEV, [7600.0, 7700.0, 7650.0], 17306,
                            3000.0, 1500.0)
    assert p["metric"] == bench.METRIC
    assert p["value"] == 7650.0
    assert p["unit"] == "utts/sec/device"
    assert "NN.train_epoch" in p["config"] and "17306" in p["config"]
    assert p["trainer_epoch_seconds"] == pytest.approx(17306 / 7650.0)
    json.dumps(p)


def test_payload_step_model_ratio_is_bf16_over_f32(bench):
    p = bench.train_payload(DEV, [100.0], 1000, 3000.0, 1500.0)
    sm = p["step_model"]
    assert sm["bf16_utts_per_sec"] == 3000.0
    assert sm["f32_utts_per_sec"] == 1500.0
    assert sm["bf16_vs_f32"] == 2.0
    assert "fused" not in json.dumps(p)


def test_payload_names_the_device(bench):
    p = bench.train_payload(DEV, [100.0], 1000, 2.0, 1.0)
    assert p["device"] == DEV["device"]
    assert p["gpu"]["power_limit"] == "700.00 W"
    assert p["nvidia_smi"].startswith("NVIDIA H100")


def test_payload_nothing_measured_is_an_error(bench):
    """No warm epoch, no number: never a 0.0 headline."""
    with pytest.raises(ValueError, match="no warm"):
        bench.train_payload(DEV, [], 1000, 2.0, 1.0)


def test_device_fields_refuses_cpu(bench):
    from ast_tpu.utils.device import NoGpuError

    with pytest.raises(NoGpuError, match="'cpu'"):
        bench.device_fields()


def test_bench_exits_nonzero_on_cpu_without_a_result():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, os.path.join(REPO, "bench.py")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert "'cpu'" in p.stderr
    assert '"value"' not in p.stdout
    assert '"ok": true' not in p.stdout
