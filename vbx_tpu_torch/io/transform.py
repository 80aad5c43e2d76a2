"""x-vector transform loader (HDF5 with keys mean1, lda, mean2).

The transform maps raw 256-d embeddings to the 128-d PLDA space:
l2norm(lda^T @ l2norm(x - mean1)^T)^T - mean2 (reference: vbhmm.py:125-129).
Asset layout (VBx's models/ResNet101_16kHz/transform.h5, as vbx_tpu
reads it with h5py): mean1 in R^256, lda in R^256x128, mean2 in R^128.

The file is read with io.hdf5, the port's numpy HDF5 reader, on every
machine: the CUDA machines this port runs on need not have h5py, and one
reader everywhere means the CPU tests run the card's path. The tests hold
it to h5py on files h5py writes (tests/test_torch_io.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from vbx_tpu_torch.io.hdf5 import read_datasets


def read_xvec_transform(path: str
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    d = read_datasets(path)
    return tuple(np.array(d[k], dtype=np.float64)
                 for k in ("mean1", "lda", "mean2"))
