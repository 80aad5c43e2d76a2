"""The port's ONNX weight import (vbx_tpu_torch.io.onnx +
vbx_tpu_torch.models.onnx_import) against vbx_tpu's, on exports of the
port's own ResNet made here with torch.onnx.export(dynamo=False).

Each export is read by both packages; both imported models must give the
exported model's embeddings within 2e-4 x max (tests/test_onnx.py's bar),
for BN folded into the convs (an eval export, the released final.onnx
form) and kept as BatchNormalization nodes (a training-mode export).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vbx_tpu.io.onnx import read_onnx as j_read_onnx
from vbx_tpu.models.onnx_import import load_onnx_checkpoint as j_load
from vbx_tpu_torch.io.onnx import read_onnx
from vbx_tpu_torch.models import resnet as tr
from vbx_tpu_torch.models.onnx_import import load_onnx_checkpoint

BAR = 2e-4


@pytest.fixture(autouse=True)
def _no_onnxscript_postpass(monkeypatch):
    """torch.onnx.export's last pass re-parses the proto with the `onnx`
    package (not installed) only to splice in custom onnxscript functions,
    a no-op for these plain CNN graphs: skip it, as tests/test_onnx.py
    does."""
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils
    monkeypatch.setattr(onnx_proto_utils, "_add_onnxscript_fn",
                        lambda model_bytes, custom_opsets: model_bytes)


def _model(block, num_blocks, seed, feat_dim=32):
    torch.manual_seed(seed)
    m = tr.ResNetXVector(getattr(tr, block), num_blocks, m_channels=8,
                         feat_dim=feat_dim, embed_dim=64)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for bn in m.modules():
            if isinstance(bn, torch.nn.BatchNorm2d):
                bn.running_mean.uniform_(-0.5, 0.5, generator=g)
                bn.running_var.uniform_(0.5, 2.0, generator=g)
    return m


def _export(tmp_path, model, name, feat_dim=32, **kw):
    path = str(tmp_path / name)
    torch.onnx.export(model, (torch.randn(1, feat_dim, 24),), path,
                      dynamo=False, input_names=["feats"],
                      output_names=["embedding"],
                      dynamic_axes={"feats": {0: "B", 2: "T"}}, **kw)
    model.eval()
    return path


@pytest.mark.parametrize("block,num_blocks,folded", [
    ("Bottleneck", (1, 1, 1, 1), True),
    ("BasicBlock", (2, 1, 1, 1), True),
    ("Bottleneck", (1, 1, 1, 1), False),
])
def test_onnx_import_matches_vbx_tpus(tmp_path, block, num_blocks, folded):
    tm = _model(block, num_blocks, seed=len(num_blocks) + folded)
    kw = {} if folded else dict(training=torch.onnx.TrainingMode.TRAINING,
                                do_constant_folding=False)
    path = _export(tmp_path, tm, "m.onnx", **kw)
    has_bn = any(n.op_type == "BatchNormalization"
                 for n in read_onnx(path).graph.nodes)
    assert has_bn == (not folded)
    assert [n.op_type for n in read_onnx(path).graph.nodes] == \
        [n.op_type for n in j_read_onnx(path).graph.nodes]

    port = load_onnx_checkpoint(path, feat_dim=32)
    assert port.num_blocks == num_blocks and port.m_channels == 8
    assert port.embed_dim == 64 and port.block is getattr(tr, block)
    fm, variables = j_load(path, feat_dim=32)

    feat = np.random.default_rng(1).standard_normal(
        (2, 32, 40)).astype(np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(feat)).numpy()
        got = port(torch.from_numpy(feat)).numpy()
    ref = np.asarray(jax.jit(fm.apply)(variables, jnp.asarray(feat)))
    for out in (got, ref):
        np.testing.assert_allclose(out, want, rtol=0,
                                   atol=BAR * np.abs(want).max())
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=BAR * np.abs(ref).max())


def test_wrong_feat_dim_is_rejected_as_vbx_tpu_rejects_it(tmp_path):
    path = _export(tmp_path, _model("Bottleneck", (1, 1, 1, 1), seed=3),
                   "dim.onnx")
    with pytest.raises(ValueError, match="feat_dim") as ours:
        load_onnx_checkpoint(path, feat_dim=64)
    with pytest.raises(ValueError) as theirs:
        j_load(path, feat_dim=64)
    assert str(ours.value) == str(theirs.value)
