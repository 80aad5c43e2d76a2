"""The port stands alone: vbx_tpu_torch imports neither jax nor vbx_tpu, and
its entry points never fall back to the CPU on their own."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "vbx_tpu_torch")


def _modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_importing_every_module_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax'\n"
            "             or k.startswith(('jax.', 'jaxlib'))\n"
            "             or k == 'vbx_tpu' or k.startswith('vbx_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("rel", sorted(
    [os.path.relpath(os.path.join(d, f), ROOT)
     for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")]
    + ["chip_smoke.py"]))
def test_no_jax_or_vbx_tpu_import_in_source(rel):
    for name in _imports(os.path.join(ROOT, rel)):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "vbx_tpu", "flax"), \
            f"{rel} imports {name}"


def test_entry_points_raise_without_a_card_unless_given_cpu(tmp_path):
    """With no CUDA card an entry point raises unless the caller passes
    device='cpu' — it never moves itself to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from vbx_tpu_torch.config import get_preset
    from vbx_tpu_torch.device import resolve_device
    from vbx_tpu_torch.engine.pipeline import Diarizer, diarize_ark
    from vbx_tpu_torch.engine.vbhmm import vbx, vbx_batched

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    X = np.zeros((1, 4, 3), np.float32)
    g = np.full((1, 4, 2), 0.5, np.float32)
    pi = np.full((1, 2), 0.5, np.float32)
    args = (X, np.ones(3, np.float32), g, pi, np.ones((1, 4), bool),
            np.ones((1, 2), bool), 0.9, 0.3, 17.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vbx_batched(*args, fb_impl="pallas")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vbx(X[0], np.ones(3), gamma=g[0])
    assert vbx_batched(*args, max_iters=2, device="cpu").gamma.device.type \
        == "cpu"
    plda = (np.zeros(3), np.eye(3), np.ones(3))
    transform = (np.zeros(4), np.eye(4)[:, :3], np.zeros(3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Diarizer(get_preset("example"), plda, transform)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        diarize_ark("a.ark", "segs", str(tmp_path), get_preset("example"),
                    "plda", "t.h5")


def test_full_fp32_guard_turns_tf32_off_and_restores():
    from vbx_tpu_torch.device import full_fp32_matmuls

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with full_fp32_matmuls():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
