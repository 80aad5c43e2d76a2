"""Released-weights handling.

The reference distributes its NN checkpoints as split zip archives
reassembled at install or recipe time (reference: setup.py:21-39,
AMI_run.sh:20-23: `cat ResNet101_16kHz.zip.part-a* > zip; unzip`). This is
the first-party equivalent, so the released artifacts work here directly.
A copy of vbx_tpu.models.weights.
"""

from __future__ import annotations

import glob
import os
import zipfile
from typing import List, Optional


def reassemble_split_zip(parts_glob: str, out_dir: str,
                         keep_zip: bool = False) -> List[str]:
    """Concatenate `<name>.zip.part-a*` pieces and extract into out_dir.

    Returns the extracted file paths. Idempotent: if every member already
    exists in out_dir, nothing is rewritten (reference recipes' unzip-if-
    missing behavior, AMI_run.sh:20-23).
    """
    import shutil

    parts = sorted(glob.glob(parts_glob))
    if not parts:
        raise FileNotFoundError(f"no parts match {parts_glob}")
    zip_path = parts[0].rsplit(".part-", 1)[0]
    os.makedirs(out_dir, exist_ok=True)

    # true idempotence: a manifest written after the first extraction lists
    # the members, so re-runs skip the (multi-hundred-MB) reassembly I/O
    # entirely when every member already exists
    manifest = os.path.join(
        out_dir, f".{os.path.basename(zip_path)}.manifest")
    if os.path.exists(manifest):
        with open(manifest) as f:
            members = [line.rstrip("\n") for line in f if line.strip()]
        out_paths = [os.path.join(out_dir, m) for m in members]
        if members and all(os.path.exists(p) for p in out_paths):
            return out_paths

    created_zip = not os.path.exists(zip_path)
    if created_zip:
        tmp = zip_path + ".tmp"
        with open(tmp, "wb") as out:
            for p in parts:
                with open(p, "rb") as f:
                    shutil.copyfileobj(f, out)   # stream, no full-part RAM
        os.replace(tmp, zip_path)

    out_paths: List[str] = []
    with zipfile.ZipFile(zip_path) as zf:
        names = zf.namelist()
        for member in names:
            dst = os.path.join(out_dir, member)
            out_paths.append(dst)
            if not os.path.exists(dst):
                zf.extract(member, out_dir)
    tmp = manifest + ".tmp"
    with open(tmp, "w") as f:
        f.write("".join(f"{m}\n" for m in names))
    os.replace(tmp, manifest)
    if not keep_zip and created_zip:
        # only remove what this call assembled — never a pre-existing zip
        os.remove(zip_path)
    return out_paths


def find_checkpoint(model_dir: str) -> Optional[str]:
    """Locate a torch checkpoint (.pth/.pt) under a model directory."""
    for pat in ("*.pth", "*.pt"):
        hits = sorted(glob.glob(os.path.join(model_dir, "**", pat),
                                recursive=True))
        if hits:
            return hits[0]
    return None
