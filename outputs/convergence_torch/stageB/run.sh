#!/bin/bash
# docs/training.md's stage B (docs/training.md:84-100) on one CUDA card, from
# the float32 seed-444 stage A of ../precision/:
#  a. stage A remade: ../precision/run.sh f32 STEPS_A 444 (default 15,000
#     steps); its log must equal ../precision/f32_seed444_15000.log.txt (a
#     shorter run its first lines: the schedule is the flags', not --steps');
#  b. stage B resumed from that checkpoint with the recipe's flags as
#     docs/training.md:87-95 gives them (no --reset_disc: the discriminator is
#     on from step 0, --disc_start 11000 being compared with the restored
#     step), STEPS_B steps (default 12,000) at each stage-B seed of SEEDS
#     (default 444, the trainer's default, and 0), all at once, each run
#     deterministic as ../precision/run.sh makes them;
#  c. each stage-B checkpoint's robustness sweep, the TPU's call
#     (tools.eval_checkpoint --nbits 32 --img_size 128 --scaling_w 0.4
#     --samples 4), the same sweep at --scaling_w 1.0, then its two planar
#     detect inputs (evals.detect_input);
#  d. the logs, metrics.csv and .jsonl files to chiprun_out/stageB; the
#     checkpoints (~0.46 GB each) deleted.
# Run from the repository's root:
#   bash outputs/convergence_torch/stageB/run.sh
# writes chiprun_out/stageB/{smi.txt,run_<SEEDS>.log,stageA_f32_seed444_<STEPS_A>.log.txt,
# seed<S>.{out,log.txt,eval.jsonl,metrics{,_sw1}.csv,eval_checkpoint{,_sw1}.out,
# detect_input.jsonl}}.
# LIMIT_A and LIMIT_B (default 3300 each) cap each stage's seconds; DEADLINE
# (epoch seconds) sets LIMIT_B to end stage B 150 s before it. One
# 3,600-s call holds stage A (1,650-1,750 s) and one 12,000-step stage-B run
# (~1,500 s alone, ~2,100 s each with two at once on the card), just: run
# SEEDS=444 and SEEDS=0 in two calls. A stage B stopped by LIMIT_B keeps its
# log and its checkpoint of step 10,000, which c reads.
set -x
STEPS_A=${STEPS_A:-15000}
STEPS_B=${STEPS_B:-12000}
SEEDS=${SEEDS:-444 0}
HERE=outputs/convergence_torch
O=chiprun_out/stageB
mkdir -p $O
L=$O/run_${SEEDS// /_}.log    # this call's record (a call a seed: see above)
T=$(mktemp -d)    # stage A's and each stage-B run's output_dir
trap 'rm -rf "$T"' EXIT
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > $O/smi.txt
cat $O/smi.txt >> $L
FL="--card videoseal_1.0 --nbits 32 --img_size 128 --synthetic 1 --batch_size 32 --num_augs 2 --lambda_d 0.1 --lambda_i 0.1 --perceptual_loss yuv --disc_start 11000 --scaling_w 1.0 --scaling_w_schedule Cosine,scaling_min=0.4,start_epoch=25,epochs=50 --optimizer AdamW,lr=2e-4 --scheduler CosineLRScheduler,lr_min=1e-6,t_initial=100,warmup_t=2"

# a. stage A
A=f32_seed444
[ "$STEPS_A" != 7500 ] && A=${A}_$STEPS_A
echo "stage A start $STEPS_A $(date +%s)" >> $L
RUNS_DIR=$T LIMIT=${LIMIT_A:-3300} bash $HERE/precision/run.sh f32 $STEPS_A 444
echo "stage A end $(date +%s)" >> $L
cp chiprun_out/precision/$A.log.txt $O/stageA_$A.log.txt
tail -n 1 chiprun_out/precision/$A.out >> $L
REF=$HERE/precision/f32_seed444_15000.log.txt
if head -n "$(wc -l < $O/stageA_$A.log.txt)" $REF | cmp -s - $O/stageA_$A.log.txt; then
    echo "stage A log: equal to the first $(wc -l < $O/stageA_$A.log.txt) lines of $REF" >> $L
else
    echo "stage A log: DIFFERS from $REF" >> $L
    exit 1
fi
CKPT=$T/$A/checkpoint.npz
[ -f $CKPT ] || { echo "stage A: no checkpoint" >> $L; exit 1; }

# b. stage B, the seeds at once (DEADLINE, epoch seconds, leaves c 150 s)
[ -n "$DEADLINE" ] && LIMIT_B=$((DEADLINE - $(date +%s) - 150))
echo "stage B start $STEPS_B $SEEDS $(date +%s)" >> $L
for s in $SEEDS; do
    CUBLAS_WORKSPACE_CONFIG=:4096:8 timeout ${LIMIT_B:-3300} python -c "import json, sys, torch
torch.use_deterministic_algorithms(True, warn_only=True)
torch.backends.cudnn.benchmark = False
import numpy as np
from videoseal_tpu_torch import train
from videoseal_tpu_torch.parallel import trainer
lrs, make = [], trainer.create_train_state
def recording(*a, **k):   # the lr of each update of the generator
    s = make(*a, **k)
    s.opt_g.register_step_pre_hook(lambda o, *_: lrs.append(o.param_groups[0]['lr']))
    return s
trainer.create_train_state = recording
_, _, ms = train.main(sys.argv[1:])
print(json.dumps({'step_ms_first_100_median': float(np.median(ms[:100])),
                  'step_ms_first_100_mean': float(np.mean(ms[:100])),
                  'step_ms_median': float(np.median(ms)), 'step_ms_first_3': ms[:3],
                  'steps': len(ms), 'lr_first_3': lrs[:3], 'lr_last': lrs[-1]}))" $FL \
        --steps $STEPS_B --tensorboard 0 --seed $s \
        --resume $CKPT --output_dir $T/seed$s > $O/seed$s.out 2>&1 &
done
wait
echo "stage B end $(date +%s)" >> $L
rm -f $CKPT

# c, d. each run's sweep and detect inputs; the checkpoints deleted
for s in $SEEDS; do
    cp $T/seed$s/log.txt $O/seed$s.log.txt
    cp $T/seed$s/eval.jsonl $O/seed$s.eval.jsonl
    echo "seed$s: $(grep -m1 resumed $O/seed$s.out)" >> $L
    echo "seed$s: $(grep '^done' $O/seed$s.out)" >> $L
    echo "seed$s: $(tail -n 1 $O/seed$s.out)" >> $L
    echo "seed$s warnings: $(grep -c Warning $O/seed$s.out)" >> $L
    if [ -f $T/seed$s/checkpoint.npz ]; then
        timeout 900 python -m videoseal_tpu_torch.tools.eval_checkpoint \
            --checkpoint $T/seed$s/checkpoint.npz --nbits 32 --img_size 128 --scaling_w 0.4 \
            --samples 4 --out_csv $O/seed$s.metrics.csv > $O/seed$s.eval_checkpoint.out 2>&1
        echo "seed$s eval_checkpoint rc $?" >> $L
        # the same sweep at the strength stage B trained at: r2's sweep at 0.4
        # reads its identity psnr (44.6-45.9 dB) where the card's at 0.4 reads
        # 52.7-54.6, so this puts the two watermarks at comparable strength
        timeout 900 python -m videoseal_tpu_torch.tools.eval_checkpoint \
            --checkpoint $T/seed$s/checkpoint.npz --nbits 32 --img_size 128 --scaling_w 1.0 \
            --samples 4 --out_csv $O/seed$s.metrics_sw1.csv > $O/seed$s.eval_checkpoint_sw1.out 2>&1
        echo "seed$s eval_checkpoint at scaling_w 1.0 rc $?" >> $L
        timeout 300 python -m videoseal_tpu_torch.evals.detect_input \
            --checkpoint $T/seed$s/checkpoint.npz > $O/seed$s.detect_input.jsonl
        echo "seed$s detect_input rc $?" >> $L
    fi
    rm -rf $T/seed$s
done
echo "end $(date +%s)" >> $L
