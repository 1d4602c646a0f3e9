"""The pure parts of chip_smoke.py and the peak table it and the
benchmark divide by.  The card phases themselves run only on a GPU."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from eigen_value.utils import timing  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"


def _dev(kind=H100, platform="gpu"):
    return types.SimpleNamespace(platform=platform, device_kind=kind)


@pytest.mark.parametrize("count", [1, 4])
def test_final_line_schema(count):
    line = chip_smoke.final_line([_dev()] * count)
    assert "\n" not in line
    rec = json.loads(line)
    assert rec == {
        "ok": True,
        "device": {"platform": "gpu", "kind": H100, "count": count},
    }


def test_check_raises_with_its_message():
    chip_smoke.check(True, "fine")
    with pytest.raises(AssertionError, match="rounds 18"):
        chip_smoke.check(False, "rounds 18")


def test_in_turns_runs_plain_kernel_kernel_plain():
    order = []

    def plain(x):
        order.append("plain")
        return x

    def kernel(x):
        order.append("kernel")
        return x

    (p1, p2), (k1, k2) = chip_smoke.in_turns(plain, kernel, 1.0, reps=1)
    assert order == ["plain", "kernel", "kernel", "plain"]
    assert min(p1, p2, k1, k2) >= 0.0


def test_no_gpu_exits_without_result():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no GPU" in out.stderr


def test_script_alone_fails(tmp_path):
    """Without the program beside it the script cannot run, and says so
    by its exit code, never by a result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_device_peak_h100():
    peak = timing.device_peak(_dev())
    assert peak.hbm_gbps == 3350.0
    assert peak.nvlink_gbps_each_way == 450.0
    assert "data sheet" in peak.source


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB"])
def test_device_peak_unknown_kind_raises(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        timing.device_peak(_dev(kind=kind))


def test_roofline_pct():
    # 1 GB in 1 ms is 1000 GB/s: 50% of a 2000 GB/s peak
    assert timing.roofline_pct(1.0, 10**9, 2000.0) == pytest.approx(50.0)
    assert timing.roofline_pct(0.0, 10**9, 2000.0) != timing.roofline_pct(
        0.0, 10**9, 2000.0
    )  # NaN for a vanished time
