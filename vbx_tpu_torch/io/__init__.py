"""Host-side file-format codecs (Kaldi ark/segments/PLDA, HDF5 transform,
RTTM): copies of the vbx_tpu.io modules the diarization path reads and
writes. Pure Python/NumPy; outputs are byte-identical to vbx_tpu's."""

from vbx_tpu_torch.io.ark import (  # noqa: F401
    group_by_recording, iter_vec_ark, read_vec_ark, write_vec_ark,
)
from vbx_tpu_torch.io.plda import read_plda, rediagonalize_plda  # noqa: F401
from vbx_tpu_torch.io.rttm import (  # noqa: F401
    merge_adjacent_labels, read_rttm, write_rttm,
)
from vbx_tpu_torch.io.segments import (  # noqa: F401
    read_segments, read_xvector_timing_dict, write_segments,
)
from vbx_tpu_torch.io.transform import read_xvec_transform  # noqa: F401
