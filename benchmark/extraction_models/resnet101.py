"""ResNet101 over fbank + CMVN (VBx's ResNet101_16kHz), the extraction
model of a configuration that names none: the program's `resnet101` in
its `XVectorExtractor`, and the plain float32 ResNet101 of
benchmark/reference/xvector.py on the same weights and the reference's
own features of the same samples.

A spec module of benchmark/extraction_models/ gives the extraction driver
its model: `build(cell, device) -> (extractor, state)`, the engine
`extract_to_ark` takes with its weights drawn from the seed on `device`,
`state` holding them; `reference(cell, state, device, tf32=False) ->
embed`, where `embed(items)` maps [(dithered pcm, VAD row in samples,
first frame, frames)] to float32 embeddings [n, embed_dim] of the plain
model, TF32 `tf32` (False: the reference; True: its control).
"""

from benchmark import datagen
from benchmark.drivers.extract import ref_settings
from benchmark.reference import xvector as ref


def _plain(cell):
    w = cell.config["widths"]
    return ref.ResNet101(w["feat_dim"], w["embed_dim"],
                         w["resnet_m_channels"], w["resnet_blocks"])


def build(cell, device):
    from vbx_tpu_torch.config import ExtractorConfig, config_from_dict
    from vbx_tpu_torch.engine.extractor import XVectorExtractor
    from vbx_tpu_torch.models.resnet import resnet101

    w = cell.config["widths"]
    state = datagen.resnet_state(cell.seed, _plain(cell), device)
    model = resnet101(w["feat_dim"], w["embed_dim"])
    model.load_state_dict(state)
    ext = XVectorExtractor(
        model, config_from_dict(cell.config["diarization"]).sample_rate,
        ExtractorConfig(**cell.config["diarization"]["extractor"]),
        batch_size=cell.traffic["batch_size"], device=device)
    return ext, state


def reference(cell, state, device, tf32=False):
    from vbx_tpu_torch.config import config_from_dict

    cfg = config_from_dict(cell.config["diarization"])
    rs = ref_settings(cfg, cfg.sample_rate)
    model = _plain(cell)
    model.load_state_dict(state)
    model.to(device)

    def embed(items):
        feats = [ref.segment_features(pcm, lab, rs)[start:start + n]
                 for pcm, lab, start, n in items]
        return ref.embed(model, feats, device, tf32=tf32)

    return embed
