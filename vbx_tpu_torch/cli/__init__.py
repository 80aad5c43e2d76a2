"""Command-line entry points of the port (flag parity with vbx_tpu.cli)."""
