"""Shared host utilities: ragged-batch bucketing, structured run logs and
the single-threaded BLAS guard (copies of the vbx_tpu.utils modules)."""

from vbx_tpu_torch.utils.bucketing import pad_to_buckets, round_up  # noqa: F401
