"""Drop-in alias for the reference diarization entry point.

The reference recipes invoke `python VBx/vbhmm.py ...` (AMI_run.sh:56,
vbhmm.py:54-179); this module lets those command lines port by swapping
only the program name: `python -m vbx_tpu_torch.cli.vbhmm <same flags>`.
The implementation is cli.diarize (bucketed batched VB-HMM on the card, or
on the host with `--device cpu`).
"""

from vbx_tpu_torch.cli.diarize import build_parser, main  # noqa: F401

if __name__ == "__main__":
    raise SystemExit(main())
