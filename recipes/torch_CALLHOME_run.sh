#!/bin/bash
# CALLHOME recipe (reference parity: CALLHOME_run.sh:1-64) on the
# PyTorch/CUDA port — 8 kHz model, threshold -0.015, smoothing 7.0, lda
# 128, Fa 0.4, Fb 17, loopP 0.40 (CALLHOME_run.sh:42-47); recipes/
# CALLHOME_run.sh's presets and paths through
# `python -m vbx_tpu_torch.cli.run_corpus`. Runs on the card (--device cpu
# among the FLAGS runs on the host).
#
# Usage: recipes/torch_CALLHOME_run.sh INSTRUCTION DATA_DIR EXP_DIR MODEL_DIR [LIST_FILE] [FLAGS...]
set -euo pipefail

INSTRUCTION=$1; DATA_DIR=$2; EXP_DIR=$3; MODEL_DIR=$4
LIST_FILE=${5:-$DATA_DIR/lists/all.txt}

REPO=$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)
PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}" \
python -m vbx_tpu_torch.cli.run_corpus "$INSTRUCTION" \
    --preset callhome \
    --list-file "$LIST_FILE" \
    --exp-dir "$EXP_DIR" \
    --wav-dir "$DATA_DIR/wav" \
    --lab-dir "$DATA_DIR/vad" \
    --weights "$MODEL_DIR/raw_195.pth" \
    --plda-file "$MODEL_DIR/plda" \
    --xvec-transform "$MODEL_DIR/transform.h5" \
    --ref-rttm-dir "$DATA_DIR/rttms" \
    "${@:6}"   # extra run_corpus flags pass through (--fb-impl, --mesh, --force, --device)
