#!/bin/bash
# ROADMAP §3.45: does the JAX package's accelerator precision decide whether
# docs/training.md's stage A learns? The recipe's flags (as
# ../flax_init/run.sh has them) for STEPS steps (default 7,500: the schedule
# is per 1,000-step epoch, so these are the 15,000-step recipe's first half),
# from flax's init (models/videoseal.init_weights) at each seed of SEEDS
# (default 444 0 1 2), each run deterministic as ../repeat/run.sh makes them,
# all runs at once on one CUDA card, in the arms ARM names:
#   f32   the trainer as it runs by default (float32, cuDNN's TF32 on,
#         matmul TF32 off);
#   bf16  under bf16_ops.py: every float32 convolution and dense product
#         with bfloat16 operands, float32 accumulation and output, as the
#         JAX package's float32 step ran on its TPU;
#   both  the two arms' runs together.
# A run whose last logged bit_acc is >= 0.95 then has the planar lowres
# path's two detect inputs held against each other on its checkpoint
# (evals/detect_input.py, ROADMAP §3.4); checkpoints stay in a temporary
# directory (too big to bring back).
# Run from the repository's root:
#   bash outputs/convergence_torch/precision/run.sh ARM [STEPS [SEEDS]]
# writes chiprun_out/precision/{smi.txt,run.log,<arm>_seed<S>[_<STEPS>].{out,log.txt},
# <run>.detect_input.jsonl}. LIMIT (default 3300) caps each run's seconds.
# RUNS_DIR, if set, is the directory the runs' output_dirs go in, kept
# (checkpoints included) for what runs next (../stageB/run.sh).
set -x
ARM=${1:?ARM: f32, bf16 or both}
STEPS=${2:-7500}
SEEDS=${3:-444 0 1 2}
LIMIT=${LIMIT:-3300}
O=chiprun_out/precision
mkdir -p $O
T=${RUNS_DIR:-$(mktemp -d)}    # each run's output_dir
FL="--card videoseal_1.0 --nbits 32 --img_size 128 --synthetic 1 --batch_size 32 --num_augs 1 --lambda_d 0 --lambda_i 0 --perceptual_loss none --scaling_w 1.0 --optimizer AdamW,lr=5e-4 --scheduler CosineLRScheduler,lr_min=1e-6,t_initial=15,warmup_t=1 --augmentation_config videoseal_tpu/configs/augs_identity.yaml"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > $O/smi.txt
python -c "import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda, \
'TF32 cudnn', torch.backends.cudnn.allow_tf32, 'matmul', torch.backends.cuda.matmul.allow_tf32)" \
    >> $O/run.log
case $ARM in both) ARMS="f32 bf16" ;; *) ARMS=$ARM ;; esac
SUFFIX=""
[ "$STEPS" != 7500 ] && SUFFIX=_$STEPS
RUNS=""
echo "start $ARMS $STEPS $SEEDS $(date +%s)" >> $O/run.log
for a in $ARMS; do
    for s in $SEEDS; do
        r=${a}_seed$s$SUFFIX
        RUNS="$RUNS $r"
        CUBLAS_WORKSPACE_CONFIG=:4096:8 timeout $LIMIT python -c "import sys, torch
torch.use_deterministic_algorithms(True, warn_only=True)
torch.backends.cudnn.benchmark = False
if sys.argv[1] == 'bf16':
    sys.path.insert(0, 'outputs/convergence_torch/precision')
    import bf16_ops
    bf16_ops.install()
from videoseal_tpu_torch import train
train.main(sys.argv[2:])" $a $FL --steps $STEPS --tensorboard 0 --seed $s --output_dir $T/$r \
            > $O/$r.out 2>&1 &
    done
done
wait
echo "end $(date +%s)" >> $O/run.log
for r in $RUNS; do
    cp $T/$r/log.txt $O/$r.log.txt
    tail -n 1 $O/$r.out
    echo "$r warnings: $(grep -c Warning $O/$r.out)" >> $O/run.log
    if python -c "import json, sys; sys.exit(json.loads(open('$O/$r.log.txt').readlines()[-1])['bit_acc'] < 0.95)"; then
        timeout 300 python -m videoseal_tpu_torch.evals.detect_input \
            --checkpoint $T/$r/checkpoint.npz > $O/$r.detect_input.jsonl
    fi
done
[ -n "$RUNS_DIR" ] || rm -rf "$T"
