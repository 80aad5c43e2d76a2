#!/bin/bash
# DIHARD II recipe (reference parity: DIHARD2_run.sh:1-63) on the
# PyTorch/CUDA port — 16 kHz model, threshold -0.015, smoothing 7.0, lda
# 128, Fa 0.2, Fb 6, loopP 0.35 (DIHARD2_run.sh:42-47); scored fair + full
# (no forgiving protocol, DIHARD2_run.sh:61-62); recipes/DIHARD2_run.sh's
# presets and paths through `python -m vbx_tpu_torch.cli.run_corpus`. Runs
# on the card (--device cpu among the FLAGS runs on the host).
#
# Usage: recipes/torch_DIHARD2_run.sh INSTRUCTION DATA_DIR EXP_DIR MODEL_DIR [LIST_FILE] [FLAGS...]
set -euo pipefail

INSTRUCTION=$1; DATA_DIR=$2; EXP_DIR=$3; MODEL_DIR=$4
LIST_FILE=${5:-$DATA_DIR/lists/dev.txt}

REPO=$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)
PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}" \
python -m vbx_tpu_torch.cli.run_corpus "$INSTRUCTION" \
    --preset dihard2 \
    --list-file "$LIST_FILE" \
    --exp-dir "$EXP_DIR" \
    --wav-dir "$DATA_DIR/wav" \
    --lab-dir "$DATA_DIR/vad" \
    --weights "$MODEL_DIR/raw_81.pth" \
    --plda-file "$MODEL_DIR/plda" \
    --xvec-transform "$MODEL_DIR/transform.h5" \
    --ref-rttm-dir "$DATA_DIR/rttms" \
    "${@:6}"   # extra run_corpus flags pass through (--fb-impl, --mesh, --force, --device)
