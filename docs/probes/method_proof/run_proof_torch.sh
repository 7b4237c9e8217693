#!/bin/bash
# The method-level proof of run_proof.sh with the PyTorch port
# (autodiffusion_tpu_torch, `adt-torch`, on one NVIDIA GPU): train a small
# unconditional ADM UNet on a synthesized image family, take FID reference
# statistics, search a 4-step schedule, then re-evaluate the searched
# schedule against uniform DDIM-4 with fresh noise and through the
# deployment path (sample + evaluate).
#
#   1. data       make_dataset.py's image family (numpy) as the train .npy
#                 and the held-out reference .npz; synthesized Inception
#                 weights (the port's synthesize_pt_inception)
#   2. train      adt-torch train; checkpoints are .pt files
#   3. refstats   adt-torch ref-stats
#   4. search     adt-torch search, K = 4, DDIM-seeded population
#   5. eval       eval_schedules_torch.py -> WS/proof_torch.json
#
#   bash run_proof_torch.sh [all|data|train|refstats|search|eval]
# WS (the workspace) defaults to _work/method_proof_torch in the repository;
# STEPS (training steps) to 20000, as run_proof.sh.
set -euo pipefail
HERE="$(cd "$(dirname "$0")" && pwd)"
REPO="$(cd "$HERE/../../.." && pwd)"
WS="${WS:-$REPO/_work/method_proof_torch}"
STEPS="${STEPS:-20000}"
export PYTHONPATH="$REPO:${PYTHONPATH:-}"
adt_torch() { python -m autodiffusion_tpu_torch.cli.main "$@"; }

MODEL_FLAGS=(--image_size 32 --num_channels 64 --num_res_blocks 2
  --attention_resolutions "16,8" --class_cond False --learn_sigma True
  --noise_schedule cosine)

stage="${1:-all}"
mkdir -p "$WS"

if [[ "$stage" == all || "$stage" == data ]]; then
  python - "$HERE" "$WS" <<'PY'
import os, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from make_dataset import gen_images
from autodiffusion_tpu_torch.fid import synthesize_pt_inception
ws = sys.argv[2]
np.save(os.path.join(ws, "train_images.npy"), gen_images(20000, seed=1234))
np.savez(os.path.join(ws, "ref_images.npz"),
         arr_0=gen_images(10000, seed=987654))
torch.save(synthesize_pt_inception(0), os.path.join(ws, "pt_inception.pth"))
print("wrote train_images.npy, ref_images.npz, pt_inception.pth")
PY
fi

if [[ "$stage" == all || "$stage" == train ]]; then
  adt_torch train --data_dir "$WS/train_images.npy" --save_dir "$WS/train" \
    "${MODEL_FLAGS[@]}" --dropout 0.1 --batch_size 128 --lr 1e-4 \
    --ema_rate 0.999 --max_steps "$STEPS" --save_interval 5000 \
    --log_interval 200 --seed 7
fi

if [[ "$stage" == all || "$stage" == refstats ]]; then
  adt_torch ref-stats --images "$WS/ref_images.npz" \
    --out "$WS/ref_stats.npz" --inception_path "$WS/pt_inception.pth" \
    --batch_size 100
fi

EMA_CKPT="$WS/train/ema_0.999_$(printf %06d "$STEPS").pt"

if [[ "$stage" == all || "$stage" == search ]]; then
  adt_torch search --model_path "$EMA_CKPT" --ref_stats "$WS/ref_stats.npz" \
    --inception_path "$WS/pt_inception.pth" --save_dir "$WS/search" \
    "${MODEL_FLAGS[@]}" --use_bf16 True \
    --time_step 4 --num_samples 512 --batch_size 128 --candidate_chunk 2 \
    --population_num 16 --select_num 6 --mutation_num 8 --crossover_num 5 \
    --max_epochs 6 --use_ddim_init_x True --seed 0 \
    | tee "$WS/search_result.json"
fi

if [[ "$stage" == all || "$stage" == eval ]]; then
  python "$HERE/eval_schedules_torch.py" --workspace "$WS" --ema "$EMA_CKPT" \
    --repeats 5 --num_samples 512 --batch_size 128
fi
