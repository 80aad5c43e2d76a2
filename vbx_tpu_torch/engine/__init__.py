"""The batched VB-HMM engine and the diarization pipeline built around it
(AHC / random initialization, label post-processing).

The x-vector extractor (engine.extractor) and the debug oracle
(engine.debug, needs scipy.optimize) are not imported eagerly: the
diarization path does not depend on them; import those modules
directly."""

from vbx_tpu_torch.engine.vbhmm import (  # noqa: F401
    VBxResult, vbx, vbx_batched, vbx_batched_checkpointed)
from vbx_tpu_torch.engine.ahc import (  # noqa: F401
    ahc_labels, random_labels, smooth_labels_to_gamma,
)
from vbx_tpu_torch.engine.pipeline import (  # noqa: F401
    DiarizationOutput, diarize_ark, diarize_xvectors,
)
