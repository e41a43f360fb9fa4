#!/bin/bash
# docs/training.md's stage A recipe (identity warm start, decode loss only)
# with the PyTorch port's train.py on one CUDA card, then, on the trained
# checkpoint, the planar lowres path's two detect inputs against each other
# (evals/detect_input.py: 64 1080p frames from seed 0, 32 bits, 128 px).
# Run from the repository's root; writes outputs/convergence_torch/stageA/
# (log.txt, eval.jsonl, run.log, detect_input.jsonl; checkpoint.npz is
# gitignored).
set -e
R=outputs/convergence_torch/stageA
mkdir -p $R
{
    nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
    python -c "import sys, torch; print(sys.version.split()[0], torch.__version__, \
torch.version.cuda, 'TF32 cudnn', torch.backends.cudnn.allow_tf32, 'matmul', \
torch.backends.cuda.matmul.allow_tf32)"
} > $R/run.log
python -m videoseal_tpu_torch.train --card videoseal_1.0 --nbits 32 \
    --img_size 128 --synthetic 1 --steps 15000 --batch_size 32 \
    --num_augs 1 --lambda_d 0 --lambda_i 0 --perceptual_loss none \
    --scaling_w 1.0 --optimizer "AdamW,lr=5e-4" \
    --scheduler "CosineLRScheduler,lr_min=1e-6,t_initial=15,warmup_t=1" \
    --augmentation_config videoseal_tpu/configs/augs_identity.yaml \
    --output_dir $R >> $R/run.log 2>&1
python -m videoseal_tpu_torch.evals.detect_input --checkpoint $R/checkpoint.npz \
    > $R/detect_input.jsonl
