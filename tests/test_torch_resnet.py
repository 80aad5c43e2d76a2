"""The port's ResNet x-vector model (vbx_tpu_torch.models.resnet) against
vbx_tpu's Flax model with the same weights.

The port's random init -> state_dict() -> vbx_tpu's
convert_torch_state_dict -> both models on the same numpy-seeded inputs:
embeddings within 2e-4 x max (tests/test_resnet.py's bar), with masked
lengths [10, 77, 144], the SE variant and fold_batchnorm.

BatchNorm tensors are randomized so that the mapping of each shows. The
padded and short windows run with the BN shifts (bias, running mean) at
zero: with a shift, the zeros past a short window's end leave channels
nearly constant over the 2 pooled frames of a 10-frame window, and the
pool's std, sqrt(meansq - mean^2 + 1e-10) in float32 (the reference's
formula, kept as it is), cancels to a negative value in one package and
not the other: NaN by rounding, in vbx_tpu as in the port. The shifts are
held by the full-length windows and the bit-equal state-dict round trips.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vbx_tpu.models import resnet as jr
from vbx_tpu_torch.models import resnet as tr

BAR = 2e-4
LENGTHS = [10, 77, 144]


def _randomize_bn(model, seed, shift=True):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(0.5 + torch.rand(n, generator=g))
                m.running_var.copy_(0.5 + torch.rand(n, generator=g))
                if shift:
                    m.bias.copy_(0.2 * torch.randn(n, generator=g))
                    m.running_mean.copy_(0.2 * torch.randn(n, generator=g))
    return model


ARCHS = {
    "bottleneck": dict(block="Bottleneck", num_blocks=(1, 1, 1, 1),
                       m_channels=16, se_reduction=0),
    "basic": dict(block="BasicBlock", num_blocks=(2, 2, 2, 2),
                  m_channels=8, se_reduction=0),
    "se_basic": dict(block="BasicBlock", num_blocks=(2, 2, 2, 2),
                     m_channels=16, se_reduction=4),
    "se_bottleneck": dict(block="Bottleneck", num_blocks=(1, 1, 1, 1),
                          m_channels=16, se_reduction=4),
}


def _models(arch, seed=0, feat_dim=64, embed_dim=32, shift=True):
    a = ARCHS[arch]
    torch.manual_seed(seed)
    tm = _randomize_bn(tr.ResNetXVector(
        getattr(tr, a["block"]), a["num_blocks"], a["m_channels"], feat_dim,
        embed_dim, a["se_reduction"]), seed, shift)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    params, stats = jr.convert_torch_state_dict(sd, num_blocks=a["num_blocks"])
    fm = jr.ResNetXVector(block=getattr(jr, a["block"]),
                          num_blocks=a["num_blocks"],
                          m_channels=a["m_channels"], feat_dim=feat_dim,
                          embed_dim=embed_dim, se_reduction=a["se_reduction"])
    return tm, fm, {**params, **stats}


def _padded_feats(seed, feat_dim=64, T=144):
    rng = np.random.default_rng(seed)
    feat = np.zeros((len(LENGTHS), feat_dim, T), np.float32)
    for i, L in enumerate(LENGTHS):
        feat[i, :, :L] = rng.standard_normal((feat_dim, L))
    return feat


def _port(tm, feat, lengths=None):
    with torch.no_grad():
        return tm(torch.from_numpy(feat), lengths=None if lengths is None
                  else torch.tensor(lengths)).numpy()


def _flax(fm, variables, feat, lengths=None):
    """vbx_tpu's model, jitted (op by op it is several times slower)."""
    run = jax.jit(lambda v, x, ln: fm.apply(v, x, lengths=ln))
    return np.asarray(run(variables, jnp.asarray(feat), None if lengths
                          is None else jnp.asarray(lengths)))


def _close(got, ref, bar=BAR):
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=bar * np.abs(ref).max())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_embeddings_match_vbx_tpu_masked_and_unmasked(arch):
    tm, fm, variables = _models(arch, seed=1, shift=False)
    feat = _padded_feats(2)
    _close(_port(tm, feat, LENGTHS), _flax(fm, variables, feat, LENGTHS))
    # unmasked, with BN shifts, at a length no stride divides
    tm, fm, variables = _models(arch, seed=1)
    full = np.random.default_rng(3).standard_normal(
        (2, 64, 101)).astype(np.float32)
    _close(_port(tm, full), _flax(fm, variables, full))


@pytest.mark.parametrize("arch", ["bottleneck", "se_basic"])
def test_padded_window_is_its_true_length_run(arch):
    """A zero-padded window with its length gives the embedding of the
    unpadded window alone; the input tensor is left as it was."""
    tm, _, _ = _models(arch, seed=4, shift=False)
    feat = _padded_feats(5)
    before = feat.copy()
    padded = _port(tm, feat, LENGTHS)
    np.testing.assert_array_equal(feat, before)
    for i, L in enumerate(LENGTHS):
        alone = _port(tm, feat[i:i + 1, :, :L])[0]
        _close(padded[i], alone)


def test_fold_batchnorm_matches_vbx_tpus_fold():
    tm, fm, variables = _models("bottleneck", seed=6)
    feat = np.random.default_rng(7).standard_normal(
        (3, 64, 144)).astype(np.float32)
    folded = tr.ResNetXVector(tr.Bottleneck, (1, 1, 1, 1), 16, 64, 32)
    folded.load_state_dict(tr.fold_batchnorm(tm.state_dict()))
    got = _port(folded, feat)
    _close(got, _flax(fm, jr.fold_batchnorm(variables), feat))
    _close(got, _port(tm, feat), bar=1e-4)
    sd = tr.fold_batchnorm(tm.state_dict())
    assert float(sd["bn1.running_mean"].abs().max()) == 0.0
    np.testing.assert_allclose(sd["layer1.0.bn2.running_var"].numpy(),
                               1.0 - 1e-5)


def test_state_dict_from_flax_round_trip():
    """vbx_tpu's variables carry over: converted variables map back to the
    port's state dict bit for bit, and variables in the tree Flax's own
    init builds (its names, shapes and layouts, from jax.eval_shape, filled
    with seeded values) load into the port and give its embeddings."""
    tm, _, variables = _models("se_bottleneck", seed=8)
    back = tr.state_dict_from_flax(variables)
    sd = tm.state_dict()
    assert back.keys() == sd.keys()
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)

    fm = jr.ResNetXVector(block=jr.BasicBlock, num_blocks=(2, 1, 1, 1),
                          m_channels=8, feat_dim=40, embed_dim=24)
    feat = np.random.default_rng(9).standard_normal(
        (2, 40, 64)).astype(np.float32)
    rng = np.random.default_rng(0)
    v = jax.tree_util.tree_map_with_path(
        lambda path, s: (rng.uniform(0.5, 1.5, s.shape)
                         if path[-1].key == "var"
                         else 0.2 * rng.standard_normal(s.shape)
                         ).astype(np.float32),
        jax.eval_shape(fm.init, jax.random.key(0), jnp.asarray(feat)))
    port = tr.ResNetXVector(tr.BasicBlock, (2, 1, 1, 1), 8, 40, 24)
    port.load_state_dict(tr.state_dict_from_flax(v))
    _close(_port(port, feat), _flax(fm, v, feat))


def _error(fn):
    with pytest.raises(ValueError) as exc:
        fn()
    return str(exc.value)


def test_depth_mismatch_errors_are_vbx_tpus():
    tm = tr.ResNetXVector(tr.Bottleneck, (1, 2, 1, 1), 4, 32, 16)
    sd_t = tm.state_dict()
    sd_n = {k: v.numpy() for k, v in sd_t.items()}
    for nb, text in (((1, 1, 1, 1), "not consumed"),
                     ((1, 3, 1, 1), "shallower")):
        ours = _error(lambda: tr.convert_torch_state_dict(sd_t, nb))
        theirs = _error(lambda: jr.convert_torch_state_dict(sd_n, nb))
        assert text in ours and ours == theirs


def test_convert_strips_module_prefix_and_warns_on_extras():
    tm, fm, variables = _models("bottleneck", seed=10)
    sd = {f"module.{k}": v for k, v in tm.state_dict().items()}
    sd["module.cls_head.weight"] = torch.zeros(4, 32)
    with pytest.warns(UserWarning, match="non-extractor"):
        conv = tr.convert_torch_state_dict(sd, num_blocks=(1, 1, 1, 1))
    port = tr.ResNetXVector(tr.Bottleneck, (1, 1, 1, 1), 16, 64, 32)
    port.load_state_dict(conv)
    feat = _padded_feats(11)
    _close(_port(port, feat, LENGTHS), _port(tm, feat, LENGTHS), bar=0)


def test_load_torch_checkpoint_reads_state_dicts_and_pickled_models(
        tmp_path):
    tm = _randomize_bn(tr.resnet34(feat_dim=32, embed_dim=16), 12)
    feat = np.random.default_rng(13).standard_normal(
        (2, 32, 40)).astype(np.float32)
    want = _port(tm, feat)
    torch.save({"state_dict": {f"module.{k}": v for k, v in
                               tm.state_dict().items()}},
               tmp_path / "wrapped.pth")
    torch.save(tm, tmp_path / "whole.pt")
    for name in ("wrapped.pth", "whole.pt"):
        m = tr.load_torch_checkpoint(str(tmp_path / name), feat_dim=32,
                                     embed_dim=16, arch="ResNet34")
        _close(_port(m, feat), want, bar=0)
    with pytest.raises(ValueError, match="unknown arch"):
        tr.load_torch_checkpoint(str(tmp_path / "whole.pt"), arch="VGG")
    with pytest.raises(ValueError, match="shallower"):
        tr.load_torch_checkpoint(str(tmp_path / "whole.pt"), feat_dim=32,
                                 embed_dim=16, arch="ResNet101")


def test_bfloat16_model_keeps_norms_pool_and_head_in_float32():
    """dtype=bfloat16: convolutions and the SE gate in bfloat16, BatchNorm
    and the embedding in float32; embeddings within cosine 0.999 of
    vbx_tpu's float32 model (tests/test_extractor.py's bar)."""
    tm, fm, variables = _models("se_basic", seed=14, shift=False)
    bf = tr.ResNetXVector(tr.BasicBlock, (2, 2, 2, 2), 16, 64, 32, 4,
                          dtype=torch.bfloat16)
    bf.load_state_dict(tm.state_dict())
    assert bf.conv1.weight.dtype == torch.bfloat16
    assert bf.layer2[0].se.fc[0].weight.dtype == torch.bfloat16
    assert bf.bn1.weight.dtype == torch.float32
    assert bf.embedding.weight.dtype == torch.float32
    feat = _padded_feats(15)
    got = _port(bf, feat, LENGTHS)
    ref = _flax(fm, variables, feat, LENGTHS)
    assert got.dtype == np.float32
    cos = (got * ref).sum(1) / (np.linalg.norm(got, axis=1)
                                * np.linalg.norm(ref, axis=1))
    assert cos.min() > 0.999, cos


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tuple(v.shape)
    return out


def test_full_depth_resnet101_maps_every_tensor():
    """The shipped architecture at full depth ([3, 4, 23, 3], 32 base
    channels, 256-d), no JAX forward: the port's state dict converts into
    exactly the tree Flax's resnet101 initializes (every key and shape),
    and state_dict_from_flax maps it back key for key."""
    tm = tr.resnet101(64, 256)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        params, stats = jr.convert_torch_state_dict(sd, (3, 4, 23, 3))
    want = jax.eval_shape(jr.resnet101(64, 256).init, jax.random.key(0),
                          jnp.zeros((1, 64, 32), jnp.float32))
    assert _shapes({**params, **stats}) == _shapes(want)
    n_convs = sum(k.endswith(".weight") and v.ndim == 4 and "shortcut"
                  not in k for k, v in sd.items())
    assert n_convs == 1 + 3 * (3 + 4 + 23 + 3)
    back = tr.state_dict_from_flax({**params, **stats})
    assert back.keys() == tm.state_dict().keys()
    assert all(back[k].shape == v.shape for k, v in tm.state_dict().items())
