"""Compute ops of the port: VB E/M-steps, the structured, dense and
associative-scan forward-backward smoothers, the forward-backward CUDA
kernels with their plain twins, pairwise similarities and score
calibration."""

from vbx_tpu_torch.ops.lse import NEG_INF, masked_logsumexp  # noqa: F401
from vbx_tpu_torch.ops.forward_backward import (  # noqa: F401
    forward_backward_assoc,
    forward_backward_dense,
    forward_backward_structured,
)
from vbx_tpu_torch.ops.vb_steps import (  # noqa: F401
    vb_elbo_model_term, vb_log_likelihoods, vb_m_step,
)
from vbx_tpu_torch.ops.similarity import (  # noqa: F401
    cos_similarity, plda_scoring_in_lda_space,
)
from vbx_tpu_torch.ops.calibration import two_gmm_calib_lin  # noqa: F401
