#!/bin/bash
# Hybrid-precision TRAINING quality A/B on the port (port of
# tools/hybrid_train_quality_ab.sh; no JAX needed).
#
# Does training the generator WITH hybrid precision (f32 master params, the
# f32 AR-feedback head and tail, bf16 interior compute in the forward and
# the backward) converge to a model of the same quality as f32 training?
#
# Protocol (the chaos-aware methodology of the decode A/Bs: GAN training is
# chaotic, so a 1-ulp control arm gives the f32 run's OWN noise cone):
#   1. Train a short f32 "stem" (identical init/data for every arm) and
#      snapshot it.
#   2. Resume three arms from the SAME stem checkpoint for the remaining
#      steps on identical batch sequences (same --seed):
#        f32      — the baseline,
#        hybrid   — generator compute_dtype=bfloat16 + hybrid_precision,
#        f32-1ulp — f32 config, generator params perturbed by 1 ulp
#                   (perturb_ckpt.py; the training noise cone).
#   3. Decode all three trained models with the SAME f32 decode config
#      (isolates training precision from decode precision) and report
#      MCD between every pair and vs ground truth, plus each arm's
#      eval/mel_loss trajectory.
# Acceptance (BASELINE.md's 0.1 dB budget + the noise-cone logic):
#   |MCD_gt(hybrid) - MCD_gt(f32)| <= 0.1 dB, with MCD(hybrid, f32) ~ the
#   cone MCD(f32-1ulp, f32) and the eval-mel gap ~ the control's gap.
#
# Usage: hybrid_train_quality_ab.sh [workdir] [total_steps] [stem_steps]
# Environment: DEVICE (default cuda).
set -euo pipefail

WORK=${1:-${TMPDIR:-/tmp}/hytrainab}
STEPS=${2:-4000}
STEM=${3:-200}
DEVICE=${DEVICE:-cuda}
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO:${PYTHONPATH:-}"
CONF_SRC="$REPO/egs/ema/voc1/conf/e2w_hifigan_car.yaml"
BIN="python3 -m articulatory_tpu_torch.bin"
TOOLS="python3 -m articulatory_tpu_torch.tools"

mkdir -p "$WORK"
if [ ! -d "$WORK/corpus" ]; then
    $TOOLS.make_synth_corpus --root "$WORK/corpus" \
        --n-utts 80 --dev-utts 8
fi

python3 - "$CONF_SRC" "$WORK" "$STEPS" "$STEM" << 'EOF'
import sys, yaml
cfg = yaml.safe_load(open(sys.argv[1]))
work, steps, stem = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
cfg["save_interval_steps"] = max(500, steps // 2)
cfg["eval_interval_steps"] = 500
cfg["log_interval_steps"] = 200
cfg["use_device_cache"] = True  # the corpus fits the card; batches gathered there
cfg["format"] = "npy"  # no h5py needed

stem_cfg = dict(cfg, train_max_steps=stem, save_interval_steps=stem,
                eval_interval_steps=stem)
yaml.dump(stem_cfg, open(f"{work}/stem.yaml", "w"))

full = dict(cfg, train_max_steps=steps)
yaml.dump(full, open(f"{work}/train.yaml", "w"))
hy = dict(full)
hy["generator_params"] = dict(cfg["generator_params"],
                              compute_dtype="bfloat16",
                              hybrid_precision=True)
yaml.dump(hy, open(f"{work}/hybrid.yaml", "w"))
EOF

cd "$WORK"
if [ ! -f dump/tr_set/stats.npy ]; then
    for name in tr_set dev_set; do
        mkdir -p "dump/$name/raw"
        $BIN.preprocess --wav-scp "corpus/data/$name/wav.scp" \
            --dumpdir "dump/$name/raw" --config train.yaml --verbose 0
    done
    $BIN.compute_statistics --rootdir dump/tr_set/raw --config train.yaml \
        --dumpdir dump/tr_set
    for name in tr_set dev_set; do
        $BIN.normalize --rootdir "dump/$name/raw" --dumpdir "dump/$name/norm" \
            --stats dump/tr_set/stats.npy --config train.yaml
    done
fi

STEM_CKPT="exp/stem/checkpoint-${STEM}steps.ckpt"
if [ ! -f "$STEM_CKPT" ]; then
    $BIN.train --device "$DEVICE" \
        --train-dumpdir dump/tr_set/norm --dev-dumpdir dump/dev_set/norm \
        --outdir exp/stem --config stem.yaml --data-root corpus/data \
        2> stem.log || { tail -20 stem.log; exit 1; }
fi

# 1-ulp-perturbed copy of the stem (generator params only — the same
# perturbation the decode A/Bs use)
[ -f exp/stem/ulp_stem.ckpt ] || \
    $TOOLS.perturb_ckpt "$STEM_CKPT" exp/stem/ulp_stem.ckpt

train_arm () {  # name config resume_ckpt
    local name=$1 conf=$2 resume=$3
    [ -f "exp/$name/checkpoint-${STEPS}steps.ckpt" ] && return 0
    $BIN.train --device "$DEVICE" \
        --train-dumpdir dump/tr_set/norm --dev-dumpdir dump/dev_set/norm \
        --outdir "exp/$name" --config "$conf" --data-root corpus/data \
        --resume "$resume" 2> "train_$name.log" \
        || { tail -20 "train_$name.log"; exit 1; }
}
train_arm f32    train.yaml  "$STEM_CKPT"
train_arm hybrid hybrid.yaml "$STEM_CKPT"
train_arm ulp    train.yaml  exp/stem/ulp_stem.ckpt

echo "== eval/mel_loss trajectories (steps: value f32 / hybrid / f32-1ulp) =="
python3 - << 'EOF'
import re
def traj(path):
    pat = re.compile(r"\(Steps: (\d+)\) eval/mel_loss = ([0-9]+\.[0-9]+)")
    return {int(m.group(1)): float(m.group(2))
            for m in map(pat.search, open(path)) if m}
t = {n: traj(f"train_{n}.log") for n in ("f32", "hybrid", "ulp")}
steps = sorted(set(t["f32"]) & set(t["hybrid"]) & set(t["ulp"]))
rel = lambda a, b: abs(a - b) / max(abs(b), 1e-12)
for s in steps:
    print(f"  {s:6d}: {t['f32'][s]:.4f} / {t['hybrid'][s]:.4f} / "
          f"{t['ulp'][s]:.4f}")
if steps:
    h = max(rel(t['hybrid'][s], t['f32'][s]) for s in steps)
    u = max(rel(t['ulp'][s], t['f32'][s]) for s in steps)
    print(f"  max rel eval-mel gap vs f32: hybrid {h:.2%}, "
          f"1-ulp control {u:.2%}")
EOF

# Decode every arm's trained model with the SAME f32 config: differences
# now come from the trained WEIGHTS, not from decode-time precision.
for arm in f32 hybrid ulp; do
    $BIN.decode --device "$DEVICE" \
        --feats-scp corpus/data/dev_set/feats.scp \
        --checkpoint "exp/$arm/checkpoint-${STEPS}steps.ckpt" \
        --config train.yaml --outdir "out_$arm" 2> "decode_$arm.log" \
        || { cat "decode_$arm.log"; exit 1; }
done

echo "== MCD(hybrid-trained, f32-trained) — numeric cost of hybrid training =="
$BIN.compute_mcd --gen-dir out_hybrid --ref-dir out_f32
echo "== MCD(1ulp-trained, f32-trained) — the f32 TRAINING noise cone =="
$BIN.compute_mcd --gen-dir out_ulp --ref-dir out_f32
echo "== MCD(f32-trained, ground truth) =="
$BIN.compute_mcd --gen-dir out_f32 --ref-dir corpus/wavs --dtw
echo "== MCD(hybrid-trained, ground truth) =="
$BIN.compute_mcd --gen-dir out_hybrid --ref-dir corpus/wavs --dtw
echo "== MCD(1ulp-trained, ground truth) =="
$BIN.compute_mcd --gen-dir out_ulp --ref-dir corpus/wavs --dtw
