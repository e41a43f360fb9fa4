#!/bin/bash
# docs/training.md's stage A on one CUDA card with the port's init as
# models/videoseal.init_weights now draws it (flax's initializers):
# 1. its first 3,000 steps from seeds 444, 0, 1 and 2, four runs at once,
#    each deterministic as ../repeat/run.sh makes them;
# 2. the recipe's 15,000 steps at seed 444 as the trainer runs by default,
#    then, on its checkpoint, the planar lowres path's two detect inputs
#    against each other (evals/detect_input.py).
# Run from the repository's root; writes chiprun_out/flax_init/
# (smi.txt, seed<S>.{out,log.txt}, stageA/{log.txt,eval.jsonl,run.log,
# detect_input.jsonl}).
set -x
O=chiprun_out/flax_init
mkdir -p $O/stageA
T=$(mktemp -d)    # each run's output_dir (checkpoints too big to bring back)
FL="--card videoseal_1.0 --nbits 32 --img_size 128 --synthetic 1 --batch_size 32 --num_augs 1 --lambda_d 0 --lambda_i 0 --perceptual_loss none --scaling_w 1.0 --optimizer AdamW,lr=5e-4 --scheduler CosineLRScheduler,lr_min=1e-6,t_initial=15,warmup_t=1 --augmentation_config videoseal_tpu/configs/augs_identity.yaml"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > $O/smi.txt
for s in 444 0 1 2; do
    CUBLAS_WORKSPACE_CONFIG=:4096:8 timeout 1500 python -c "import sys, torch
torch.use_deterministic_algorithms(True, warn_only=True)
torch.backends.cudnn.benchmark = False
from videoseal_tpu_torch import train
train.main(sys.argv[1:])" $FL --steps 3000 --tensorboard 0 --seed $s --output_dir $T/seed$s > $O/seed$s.out 2>&1 &
done
wait
for s in 444 0 1 2; do
    cp $T/seed$s/log.txt $O/seed$s.log.txt
    tail -n 1 $O/seed$s.out
done
rm -rf $T/seed*
R=$T/stageA
{
    nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
    python -c "import sys, torch; print(sys.version.split()[0], torch.__version__, \
torch.version.cuda, 'TF32 cudnn', torch.backends.cudnn.allow_tf32, 'matmul', \
torch.backends.cuda.matmul.allow_tf32)"
} > $O/stageA/run.log
timeout 1800 python -m videoseal_tpu_torch.train $FL --steps 15000 --output_dir $R >> $O/stageA/run.log 2>&1
cp $R/log.txt $R/eval.jsonl $O/stageA/
timeout 300 python -m videoseal_tpu_torch.evals.detect_input --checkpoint $R/checkpoint.npz \
    > $O/stageA/detect_input.jsonl
tail -n 2 $O/stageA/log.txt
rm -rf "$T"
