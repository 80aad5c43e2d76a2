"""Host-side file-format codecs (Kaldi vector and matrix arks, segments,
PLDA, HDF5 transform, RTTM, UEM, VAD labels, wav, ONNX): copies of the
vbx_tpu.io modules the diarization and extraction paths read and write.
Pure Python/NumPy; outputs are byte-identical to vbx_tpu's."""

from vbx_tpu_torch.io.ark import (  # noqa: F401
    group_by_recording, iter_vec_ark, read_txt_vectors, read_vec_ark,
    write_txt_vectors, write_vec_ark,
)
from vbx_tpu_torch.io.kaldi_matrix import (  # noqa: F401
    iter_mat_ark, read_mat_ark, read_mat_binary, read_sparse_mat,
    write_mat_ark,
)
from vbx_tpu_torch.io.onnx import read_onnx  # noqa: F401
from vbx_tpu_torch.io.plda import read_plda, rediagonalize_plda  # noqa: F401
from vbx_tpu_torch.io.rttm import (  # noqa: F401
    RttmSegment, merge_adjacent_labels, read_rttm, write_rttm,
)
from vbx_tpu_torch.io.segments import (  # noqa: F401
    read_segments, read_xvector_timing_dict, write_segments,
)
from vbx_tpu_torch.io.transform import read_xvec_transform  # noqa: F401
from vbx_tpu_torch.io.uem import read_uem, write_uem  # noqa: F401
from vbx_tpu_torch.io.vad import read_lab  # noqa: F401
