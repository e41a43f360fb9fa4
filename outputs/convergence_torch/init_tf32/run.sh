#!/bin/bash
# Why stage A stalled with the port's old random init: the recipe's first
# 2,500 steps, three runs at once on one CUDA card. (1) the old init
# (uniform weights and biases, U(-1/sqrt(fan_in), 1/sqrt(fan_in))) with
# TF32 off in cuDNN, from an archive of the parent commit; (2) and (3)
# flax's lecun_normal init with zero biases (../lecun_init.py), seeds 444
# (the recipe's) and 0. Run from the repository's root after
#   mkdir -p proof_out/parent && git archive 259549b | tar -x -C proof_out/parent
# (the old train.py reads the identity pool from JSON). Writes
# chiprun_out/exp/{tf32off,lecun444,lecun0}.{out,log.txt}.
set -x
mkdir -p chiprun_out/exp
echo '{"masks": {"kind": null}, "augs": {"identity": 1}, "augs_params": {}}' > proof_out/augs_identity.json
FL="--card videoseal_1.0 --nbits 32 --img_size 128 --synthetic 1 --batch_size 32 --num_augs 1 --lambda_d 0 --lambda_i 0 --perceptual_loss none --scaling_w 1.0 --optimizer AdamW,lr=5e-4 --scheduler CosineLRScheduler,lr_min=1e-6,t_initial=15,warmup_t=1 --steps 2500 --tensorboard 0"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > chiprun_out/exp/smi.txt
T=$(mktemp -d)    # each run's output_dir (checkpoints too big to bring back)
(cd proof_out/parent && python -c "import sys, torch; torch.backends.cudnn.allow_tf32 = False; from videoseal_tpu_torch import train; train.main(sys.argv[1:])" $FL --augmentation_config ../augs_identity.json --output_dir $T/tf32off > ../../chiprun_out/exp/tf32off.out 2>&1) &
python outputs/convergence_torch/lecun_init.py $FL --augmentation_config videoseal_tpu/configs/augs_identity.yaml --output_dir $T/lecun444 > chiprun_out/exp/lecun444.out 2>&1 &
python outputs/convergence_torch/lecun_init.py $FL --seed 0 --augmentation_config videoseal_tpu/configs/augs_identity.yaml --output_dir $T/lecun0 > chiprun_out/exp/lecun0.out 2>&1 &
wait
for r in tf32off lecun444 lecun0; do cp $T/$r/log.txt chiprun_out/exp/$r.log.txt; tail -n 1 chiprun_out/exp/$r.out; done
