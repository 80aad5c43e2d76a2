"""Kaldi PLDA model reader (first-party).

Parses the Kaldi `<Plda>` object in binary or text form into
(mu, tr, psi): mean vector, whitening/diagonalizing transform, and the
diagonal of the across-class covariance in the transformed space.
Format semantics follow the reference reader (VBx/kaldi_utils.py:25-53) and
were verified against the shipped models/ResNet101_16kHz/plda asset
(mu in R^128, tr in R^128x128, psi in R^128).
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Tuple

import numpy as np


def _read_binary_vec(fd: BinaryIO) -> np.ndarray:
    typ = fd.read(3)
    if typ == b"FV ":
        dtype, isize = np.float32, 4
    elif typ == b"DV ":
        dtype, isize = np.float64, 8
    else:
        raise ValueError(f"bad vector header {typ!r}")
    if fd.read(1) != b"\x04":
        raise ValueError("expected int32 size marker")
    (dim,) = struct.unpack("<i", fd.read(4))
    return np.frombuffer(fd.read(dim * isize), dtype=dtype).copy()


def _read_binary_mat(fd: BinaryIO) -> np.ndarray:
    typ = fd.read(3)
    if typ == b"FM ":
        dtype, isize = np.float32, 4
    elif typ == b"DM ":
        dtype, isize = np.float64, 8
    else:
        raise ValueError(f"bad matrix header {typ!r} (compressed/sparse "
                         "matrices are not used by PLDA models)")
    if fd.read(1) != b"\x04":
        raise ValueError("expected int32 size marker")
    (rows,) = struct.unpack("<i", fd.read(4))
    if fd.read(1) != b"\x04":
        raise ValueError("expected int32 size marker")
    (cols,) = struct.unpack("<i", fd.read(4))
    buf = fd.read(rows * cols * isize)
    return np.frombuffer(buf, dtype=dtype).reshape(rows, cols).copy()


def _read_text_vec(line: str) -> np.ndarray:
    return np.array(line.strip(" \n[]").split(), dtype=float)


def read_plda(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load a Kaldi PLDA model file (binary or text) -> (mu, tr, psi)."""
    with open(path, "rb") as fd:
        head = fd.read(2)
        if head == b"\x00B":
            if fd.read(7) != b"<Plda> ":
                raise ValueError("missing <Plda> tag")
            mu = _read_binary_vec(fd)
            tr = _read_binary_mat(fd)
            psi = _read_binary_vec(fd)
            if fd.read(8) != b"</Plda> ":
                raise ValueError("missing </Plda> tag")
        else:
            rest = fd.read(5)
            if head + rest != b"<Plda> ":
                raise ValueError("missing <Plda> tag in text PLDA")
            mu = _read_text_vec(fd.readline().decode())
            if fd.read(2) != b" [":
                raise ValueError("expected matrix open bracket")
            rows = []
            while True:
                line = fd.readline().decode()
                closing = "]" in line
                vals = line.replace("]", " ").split()
                if vals:
                    rows.append(np.array(vals, dtype=float))
                if closing:
                    break
            tr = np.stack(rows)
            psi = _read_text_vec(fd.readline().decode())
            if fd.read(8) != b"</Plda> ":
                raise ValueError("missing </Plda> tag")
    return (np.asarray(mu, dtype=np.float64),
            np.asarray(tr, dtype=np.float64),
            np.asarray(psi, dtype=np.float64))


def rediagonalize_plda(
    mu: np.ndarray, tr: np.ndarray, psi: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Re-derive the diagonalizing transform from a Kaldi PLDA model.

    Solves the generalized symmetric eigenproblem B v = lambda W v with
    W = (tr^T tr)^-1 (within-class) and B = (tr^T diag(1/psi) tr)^-1
    (across-class), returning (mu, tr', psi') with eigenvalues in descending
    order — the one-time 128x128 host-side model prep the diarization CLI
    performs (reference: vbhmm.py:109-113).
    """
    import scipy.linalg

    from vbx_tpu_torch.utils.hostblas import single_thread_blas

    # 128x128 LAPACK under the default OpenBLAS pool is load-dependently
    # ~200x slower than single-threaded (utils/hostblas.py has the
    # measurement); this runs once per Diarizer construction, which the
    # corpus CLI pays per ark and serving pays per daemon.
    with single_thread_blas():
        W = np.linalg.inv(tr.T @ tr)
        B = np.linalg.inv((tr.T / psi) @ tr)
        acvar, wccn = scipy.linalg.eigh(B, W)
    psi_new = acvar[::-1]
    tr_new = wccn.T[::-1]
    return mu, tr_new, psi_new
