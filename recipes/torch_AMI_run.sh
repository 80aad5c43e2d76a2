#!/bin/bash
# AMI recipe (reference parity: AMI_run.sh:1-67) on the PyTorch/CUDA port:
# recipes/AMI_run.sh's presets and paths through
# `python -m vbx_tpu_torch.cli.run_corpus`.
#
# Usage: recipes/torch_AMI_run.sh INSTRUCTION VARIANT DATA_DIR EXP_DIR MODEL_DIR [LIST_FILE] [FLAGS...]
#   INSTRUCTION: xvectors | diarization | score
#   VARIANT:     mixheadset | beamformed
#
# Hyperparameters of record (AMI_run.sh:6,45-49): threshold -0.015,
# smoothing 7.0, lda 128, Fa 0.4, Fb 68 (Mix-Headset) / 64 (beamformed),
# loopP 0.65; 16 kHz model. Runs on the card (--device cpu among the
# FLAGS runs on the host). Multi-host: one process per host with
# COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID set
# (vbx_tpu_torch.parallel.distributed).
set -euo pipefail

INSTRUCTION=$1; VARIANT=$2; DATA_DIR=$3; EXP_DIR=$4; MODEL_DIR=$5
LIST_FILE=${6:-$DATA_DIR/lists/dev.txt}

case $VARIANT in
  mixheadset) PRESET=ami_mixheadset ;;
  beamformed) PRESET=ami_beamformed ;;
  *) echo "VARIANT must be mixheadset|beamformed" >&2; exit 1 ;;
esac

REPO=$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)
PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}" \
python -m vbx_tpu_torch.cli.run_corpus "$INSTRUCTION" \
    --preset "$PRESET" \
    --list-file "$LIST_FILE" \
    --exp-dir "$EXP_DIR" \
    --wav-dir "$DATA_DIR/wav" \
    --lab-dir "$DATA_DIR/vad" \
    --weights "$MODEL_DIR/raw_81.pth" \
    --plda-file "$MODEL_DIR/plda" \
    --xvec-transform "$MODEL_DIR/transform.h5" \
    --ref-rttm-dir "$DATA_DIR/rttms" \
    "${@:7}"   # extra run_corpus flags pass through (--fb-impl, --mesh, --force, --device)
