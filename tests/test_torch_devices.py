"""The port's accelerator probe (vbx_tpu_torch.utils.devices): the probe's
dict has vbx_tpu's keys (vbx_tpu/utils/devices.py:probe_accelerator), it
answers from a subprocess, and a launcher's pick follows it. Here there is no card: the probe says so, and
pick_backend gives 'cpu'; on a card the gpu-marked test holds the
'cuda' answer."""

import json
import os
import subprocess
import sys

import pytest
import torch

from vbx_tpu_torch.utils import devices as tdev

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"backend", "usable", "devices", "probe_s", "error"}


def test_probe_answers_with_vbx_tpus_keys():
    info = tdev.probe_accelerator(timeout_s=120)
    assert set(info) == KEYS
    assert info["usable"] is torch.cuda.is_available()
    if not info["usable"]:
        assert info["backend"] == "cpu" and info["devices"] == 0
        assert info["error"] == "no CUDA device"
        assert tdev.pick_backend(timeout_s=120) == "cpu"


def test_probe_timeout_and_crash_are_not_usable(monkeypatch):
    monkeypatch.setattr(tdev, "_PROBE", "import time; time.sleep(30)")
    info = tdev.probe_accelerator(timeout_s=0.5)
    assert info["usable"] is False and info["backend"] is None
    assert "timed out" in info["error"]
    monkeypatch.setattr(tdev, "_PROBE", "raise SystemExit('broken driver')")
    info = tdev.probe_accelerator(timeout_s=60)
    assert info["usable"] is False and "broken driver" in info["error"]
    assert tdev.pick_backend(timeout_s=60) == "cpu"


def test_module_prints_one_json_line():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-m", "vbx_tpu_torch.utils.devices",
                          "--timeout", "120"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1
    info = json.loads(lines[0])
    assert set(info) == KEYS
    assert res.returncode == (0 if info["usable"] else 1)


@pytest.mark.gpu
def test_probe_finds_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    info = tdev.probe_accelerator(timeout_s=300)
    assert info["usable"] and info["backend"] == "cuda"
    assert info["devices"] == torch.cuda.device_count()
    assert tdev.pick_backend(timeout_s=300) == "cuda"
