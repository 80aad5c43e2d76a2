"""The batched VB-HMM engine and the diarization pipeline built around it
(AHC / random initialization, label post-processing).

The debug oracle (engine.debug, needs scipy.optimize) is not imported
eagerly: the diarization path does not depend on it; import that module
directly."""

from vbx_tpu_torch.engine.vbhmm import (  # noqa: F401
    VBxResult, vbx, vbx_batched, vbx_batched_checkpointed)
