#!/bin/bash
# The 6-view probabilistic U-Net end to end on the card (counterpart of the
# JAX package's tools/run_6view_probunet.sh, the same knobs): train a
# full-width probunet with 6 isotropic oblique views (the shipped
# generalization of the reference's arbitrary-axis TODO, mri_dataset.py:71)
# on the hard synthetic family (intensity overlap and partial volume, the
# discriminating task of compare_with_reference), then report per-view and
# fused Dice and GED^2 on held-out volumes through the eval CLI.
#
#   DATA=/tmp/p6v_data CUBE=128 EPOCHS=40 pmpu_tpu_torch/tools/run_6view_probunet.sh
#
# Knobs: DATA, CUBE, EPOCHS, FILTERS, BATCH, LR; DEVICE (default cuda; cpu
# runs the kernels' plain versions) and PYTHON (default python3).
set -u -o pipefail
cd "$(dirname "$0")/../.."
PYTHON=${PYTHON:-python3}
DATA=${DATA:-/tmp/p6v_data}
CUBE=${CUBE:-128}
EPOCHS=${EPOCHS:-40}
FILTERS=${FILTERS:-64,128,256,512,1024}
BATCH=${BATCH:-16}
LR=${LR:-0.0005}
DEVICE=${DEVICE:-cuda}

"$PYTHON" - <<PYEOF
import numpy as np
from pmpu_tpu_torch.data import nifti
from pmpu_tpu_torch.tools.compare_with_reference import synth_volumes_hard
imgs, lbls = synth_volumes_hard(12, int("$CUBE"), 0)
for split, lo, hi in (("train", 0, 8), ("test", 8, 12)):
    for i in range(lo, hi):
        nifti.save(f"$DATA/{split}/images/v{i}.nii", imgs[i])
        nifti.save(f"$DATA/{split}/labels/v{i}.nii", lbls[i].astype(np.float32))
print("dataset ready:", "$DATA")
PYEOF

"$PYTHON" -m pmpu_tpu_torch.train -m probunet -d "$DATA/train" --num-views 6 --bf16 \
    -e "$EPOCHS" -b "$BATCH" -l "$LR" -p 6 --include-empty-slices \
    --num-filters "$FILTERS" --checkpoint-every 10 --checkpoint-dir "$DATA/ckpt" \
    --device "$DEVICE" 2>&1 | tail -5
train_rc=$?

"$PYTHON" -m pmpu_tpu_torch.eval -m probunet -f "$DATA/ckpt/probunet_model.pt" \
    -d "$DATA/test" --num-views 6 --bf16 --ged 16 --eval-samples 5 \
    --device "$DEVICE" 2>&1 | tail -12
eval_rc=$?
echo "DONE train rc=$train_rc eval rc=$eval_rc"
[ "$train_rc" -eq 0 ] && exit "$eval_rc"
exit "$train_rc"
