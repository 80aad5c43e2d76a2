"""First-party diarization scoring: exact event-based DER (md-eval
semantics: collar, overlap exclusion, optimal speaker mapping) plus JER and
frame-based clustering metrics — the dscore-equivalent layer (reference
invokes dscore/score.py, e.g. AMI_run.sh:63-65)."""

from vbx_tpu_torch.metrics.der import (  # noqa: F401
    Turn, score_recording, score_corpus, der_from_rttm_files,
)
from vbx_tpu_torch.metrics.frame_metrics import frame_clustering_metrics  # noqa: F401
