#!/bin/bash
# The recipe's first 3,000 steps (docs/training.md's stage A) from four
# more starts, all at once on one CUDA card: the port's init (uniform
# weights and biases) at seeds 0 and 1, and flax's lecun_normal init
# (../lecun_init.py) at seeds 1 and 2. The uniform arms are the port's
# init before init_weights drew flax's initializers (commit 1bd623d and
# earlier); from a later checkout they draw flax's. Run from the repository's root;
# writes chiprun_out/seeds/{uniform0,uniform1,lecun1,lecun2}.log.txt.
set -x
mkdir -p chiprun_out/seeds
FL="--card videoseal_1.0 --nbits 32 --img_size 128 --synthetic 1 --batch_size 32 --num_augs 1 --lambda_d 0 --lambda_i 0 --perceptual_loss none --scaling_w 1.0 --optimizer AdamW,lr=5e-4 --scheduler CosineLRScheduler,lr_min=1e-6,t_initial=15,warmup_t=1 --augmentation_config videoseal_tpu/configs/augs_identity.yaml --steps 3000 --tensorboard 0"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > chiprun_out/seeds/smi.txt
T=$(mktemp -d)    # each run's output_dir (checkpoints too big to bring back)
for s in 0 1; do
    python -m videoseal_tpu_torch.train $FL --seed $s --output_dir $T/uniform$s > chiprun_out/seeds/uniform$s.out 2>&1 &
done
for s in 1 2; do
    python outputs/convergence_torch/lecun_init.py $FL --seed $s --output_dir $T/lecun$s > chiprun_out/seeds/lecun$s.out 2>&1 &
done
wait
for r in uniform0 uniform1 lecun1 lecun2; do cp $T/$r/log.txt chiprun_out/seeds/$r.log.txt; tail -n 1 chiprun_out/seeds/$r.out; done
