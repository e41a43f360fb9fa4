#!/bin/bash
# Does run-to-run nondeterminism decide whether stage A learns? The recipe
# as docs/training.md writes it (the port's init, seed 444; uniform
# weights and biases before init_weights drew flax's initializers, commit
# 1bd623d and earlier), its first
# 2,000 steps, four runs at once on one CUDA card under the same
# conditions: twice as the trainer runs by default (default_a, default_b),
# and twice with torch.use_deterministic_algorithms(True) (warn only: an op
# without a deterministic kernel warns in det_*.out), cuDNN's benchmark off
# and cuBLAS's deterministic workspace (det_a, det_b). Run from the
# repository's root; writes chiprun_out/repeat/{smi.txt,<run>.out,<run>.log.txt}.
set -x
O=chiprun_out/repeat
mkdir -p $O
T=$(mktemp -d)    # each run's output_dir (checkpoints too big to bring back)
FL="--card videoseal_1.0 --nbits 32 --img_size 128 --synthetic 1 --batch_size 32 --num_augs 1 --lambda_d 0 --lambda_i 0 --perceptual_loss none --scaling_w 1.0 --optimizer AdamW,lr=5e-4 --scheduler CosineLRScheduler,lr_min=1e-6,t_initial=15,warmup_t=1 --augmentation_config videoseal_tpu/configs/augs_identity.yaml --steps 2000 --tensorboard 0"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > $O/smi.txt
date +%s > $O/start.txt
for r in default_a default_b; do
    timeout 1200 python -m videoseal_tpu_torch.train $FL --output_dir $T/$r > $O/$r.out 2>&1 &
done
for r in det_a det_b; do
    CUBLAS_WORKSPACE_CONFIG=:4096:8 timeout 1200 python -c "import sys, torch
torch.use_deterministic_algorithms(True, warn_only=True)
torch.backends.cudnn.benchmark = False
from videoseal_tpu_torch import train
train.main(sys.argv[1:])" $FL --output_dir $T/$r > $O/$r.out 2>&1 &
done
wait
for r in default_a default_b det_a det_b; do
    cp $T/$r/log.txt $O/$r.log.txt
    tail -n 1 $O/$r.out
done
rm -rf "$T"
