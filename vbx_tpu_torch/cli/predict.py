"""Drop-in alias for the reference extractor entry point.

The reference recipes invoke `python VBx/predict.py ...` (extract.sh:32,
predict.py:81-210); this module lets those command lines port by swapping
only the program name: `python -m vbx_tpu_torch.cli.predict <same flags>`.
The implementation is cli.extract.
"""

from vbx_tpu_torch.cli.extract import build_parser, main  # noqa: F401

if __name__ == "__main__":
    raise SystemExit(main())
