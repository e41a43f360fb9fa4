#!/bin/bash
# The stall-share size on one CUDA card: docs/training.md's stage A at
# 64 px, batch 8, STEPS steps (default 1,000), the schedule's epoch EPOCH
# steps (default 67, STEPS / 15, so that it keeps its shape), from the
# port's init (models/videoseal.init_weights) at seeds 444, 0, 1 and 2,
# four runs at once, each deterministic as ../repeat/run.sh makes them.
# Run from the repository's root: bash card_stall.sh [STEPS [EPOCH]];
# writes chiprun_out/ab_card/s<STEPS>/{smi.txt,seed<S>.out,seed<S>.log.txt}.
set -x
STEPS=${1:-1000}
EPOCH=${2:-67}
O=chiprun_out/ab_card/s$STEPS
mkdir -p $O
T=$(mktemp -d)    # each run's output_dir
FL="--card videoseal_1.0 --nbits 32 --img_size 64 --synthetic 1 --batch_size 8 --num_augs 1 --lambda_d 0 --lambda_i 0 --perceptual_loss none --scaling_w 1.0 --optimizer AdamW,lr=5e-4 --scheduler CosineLRScheduler,lr_min=1e-6,t_initial=15,warmup_t=1 --iter_per_epoch $EPOCH --augmentation_config videoseal_tpu/configs/augs_identity.yaml --steps $STEPS --tensorboard 0"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > $O/smi.txt
for s in 444 0 1 2; do
    CUBLAS_WORKSPACE_CONFIG=:4096:8 timeout 1200 python -c "import sys, torch
torch.use_deterministic_algorithms(True, warn_only=True)
torch.backends.cudnn.benchmark = False
from videoseal_tpu_torch import train
train.main(sys.argv[1:])" $FL --seed $s --output_dir $T/seed$s > $O/seed$s.out 2>&1 &
done
wait
for s in 444 0 1 2; do
    cp $T/seed$s/log.txt $O/seed$s.log.txt
    tail -n 1 $O/seed$s.out
done
rm -rf "$T"
