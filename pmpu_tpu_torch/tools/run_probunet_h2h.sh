#!/bin/bash
# The probunet hard-task head-to-head of the port against the reference
# algorithm (counterpart of the JAX package's tools/run_probunet_h2h.sh):
# arm A: the reference-default plateau scheduler (-p 6), 4 seed pairs from
#        shared initial weights, 12 held-out volumes, and the GED^2(16)
#        sample-diversity head-to-head
# arm B: fixed LR (-p 999), the same protocol (Dice only)
#
#   pmpu_tpu_torch/tools/run_probunet_h2h.sh               (on the card)
#   DEVICE=cpu pmpu_tpu_torch/tools/run_probunet_h2h.sh    (the root script's CPU protocol)
#
# Knobs: DEVICE (default cuda; cpu runs the kernels' plain versions), LOGS
# (default runs/h2h, the directory of the arms' two logs) and PYTHON
# (default python3).
set -u -o pipefail
cd "$(dirname "$0")/../.."
PYTHON=${PYTHON:-python3}
DEVICE=${DEVICE:-cuda}
LOGS=${LOGS:-runs/h2h}
mkdir -p "$LOGS"
COMMON="--train --model probunet --filters 8,16 --cube 24 -e 40 -b 4 -l 0.02
        --n-train 10 --n-test 12 --task hard --seeds 4 --shared-init --device $DEVICE"
echo "=== arm A (plateau -p 6, GED 16) start $(date) ==="
nice -n 10 "$PYTHON" -m pmpu_tpu_torch.tools.compare_with_reference \
    $COMMON -p 6 --ged 16 > "$LOGS/probunet_armA.log" 2>&1
a_rc=$?
echo "arm A rc=$a_rc $(date)"
echo "=== arm B (fixed LR -p 999) start $(date) ==="
nice -n 10 "$PYTHON" -m pmpu_tpu_torch.tools.compare_with_reference \
    $COMMON -p 999 > "$LOGS/probunet_armB.log" 2>&1
b_rc=$?
echo "arm B rc=$b_rc $(date)"
echo DONE
[ "$a_rc" -eq 0 ] && exit "$b_rc"
exit "$a_rc"
