#!/bin/bash
# Batch-run spoof-attack reconstructions on CUDA cards: one training
# process (python -m gslidar_tpu_torch.train) per attack id, on the card
# the first argument selects through CUDA_VISIBLE_DEVICES. The port of the
# repo root's run_selected_spoofs.sh: the same arguments, config dir and
# output paths, and a missing config is skipped. Run it from the repo
# root.
#
# Usage: gslidar_tpu_torch/scripts/run_selected_spoofs.sh <DEVICE_ID> <attack_ids,comma,separated>

DEVICE_ID=$1
ATTACK_IDS=$2
CONFIG_DIR="all_configs"
OUTPUT_BASE="eval_output/opv2v_reconstruction"

if [ -z "$DEVICE_ID" ] || [ -z "$ATTACK_IDS" ]; then
    echo "usage: gslidar_tpu_torch/scripts/run_selected_spoofs.sh <DEVICE_ID> <attack_ids (comma separated)>"
    echo "example: gslidar_tpu_torch/scripts/run_selected_spoofs.sh 0 23,56,78,99"
    exit 1
fi

IFS=',' read -ra IDS <<< "$ATTACK_IDS"

for ATTACK_ID in "${IDS[@]}"; do
    CONFIG_FILE="${CONFIG_DIR}/opv2v_spoof_attack_${ATTACK_ID}.yaml"
    OUTPUT_PATH="${OUTPUT_BASE}/spoof_${ATTACK_ID}"

    if [ ! -f "$CONFIG_FILE" ]; then
        echo "config not found: $CONFIG_FILE, skipping."
        continue
    fi

    echo "running attack_id=${ATTACK_ID} on device ${DEVICE_ID}..."
    CUDA_VISIBLE_DEVICES=$DEVICE_ID python -m gslidar_tpu_torch.train \
        --config "$CONFIG_FILE" model_path="$OUTPUT_PATH"
done

echo "all runs complete."
