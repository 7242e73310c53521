#!/bin/bash
# bf16 WEIGHT-STORAGE decode quality A/B on the port (port of
# tools/bf16_weights_quality_ab.sh; no JAX needed).
#
# The chaos-aware protocol of the int8/bf16/hybrid decode A/Bs: decode ONE
# trained f32 checkpoint three ways —
#   f32      — baseline decode,
#   bf16w    — --bf16-weights (bfloat16-stored folded weights, compute
#              dtypes unchanged; LoadedModel.to_bf16_weights),
#   f32-1ulp — f32 decode of a 1-ulp-perturbed copy of the same checkpoint
#              (the f32 decode's OWN chaos cone),
# then report MCD(bf16w, f32) vs the cone and each arm's ground-truth MCD.
# Acceptance: |MCD_gt(bf16w) - MCD_gt(f32)| <= 0.1 dB with MCD(bf16w, f32)
# ~ the cone; outside -> quantified negative, bf16w stays opt-in.
#
# Usage: bf16_weights_quality_ab.sh [workdir] [ckpt]
#   Reuses hybrid_train_quality_ab.sh's layout; if the workdir has no
#   trained f32 checkpoint, builds corpus -> dump -> 200-step stem ->
#   4000-step f32 arm first.
# Environment: DEVICE (default cuda).
set -euo pipefail

WORK=${1:-${TMPDIR:-/tmp}/hytrainab}
CKPT=${2:-exp/f32/checkpoint-4000steps.ckpt}
STEPS=4000
STEM=200
DEVICE=${DEVICE:-cuda}
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO:${PYTHONPATH:-}"
BIN="python3 -m articulatory_tpu_torch.bin"
TOOLS="python3 -m articulatory_tpu_torch.tools"

if [ ! -f "$WORK/$CKPT" ]; then
    echo "== no trained checkpoint at $WORK/$CKPT — building the f32 arm =="
    CONF_SRC="$REPO/egs/ema/voc1/conf/e2w_hifigan_car.yaml"
    mkdir -p "$WORK"
    [ -d "$WORK/corpus" ] || $TOOLS.make_synth_corpus \
        --root "$WORK/corpus" --n-utts 80 --dev-utts 8
    python3 - "$CONF_SRC" "$WORK" "$STEPS" "$STEM" << 'EOF'
import sys, yaml
cfg = yaml.safe_load(open(sys.argv[1]))
work, steps, stem = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
cfg["save_interval_steps"] = max(500, steps // 2)
cfg["eval_interval_steps"] = 500
cfg["log_interval_steps"] = 200
cfg["use_device_cache"] = True
cfg["format"] = "npy"
yaml.dump(dict(cfg, train_max_steps=stem, save_interval_steps=stem,
               eval_interval_steps=stem), open(f"{work}/stem.yaml", "w"))
yaml.dump(dict(cfg, train_max_steps=steps), open(f"{work}/train.yaml", "w"))
EOF
    cd "$WORK"
    if [ ! -f dump/tr_set/stats.npy ]; then
        for name in tr_set dev_set; do
            mkdir -p "dump/$name/raw"
            $BIN.preprocess --wav-scp "corpus/data/$name/wav.scp" \
                --dumpdir "dump/$name/raw" --config train.yaml --verbose 0
        done
        $BIN.compute_statistics --rootdir dump/tr_set/raw \
            --config train.yaml --dumpdir dump/tr_set
        for name in tr_set dev_set; do
            $BIN.normalize --rootdir "dump/$name/raw" \
                --dumpdir "dump/$name/norm" --stats dump/tr_set/stats.npy \
                --config train.yaml
        done
    fi
    [ -f "exp/stem/checkpoint-${STEM}steps.ckpt" ] || \
        $BIN.train --device "$DEVICE" \
            --train-dumpdir dump/tr_set/norm --dev-dumpdir dump/dev_set/norm \
            --outdir exp/stem --config stem.yaml --data-root corpus/data \
            2> stem.log || { tail -20 stem.log; exit 1; }
    $BIN.train --device "$DEVICE" \
        --train-dumpdir dump/tr_set/norm --dev-dumpdir dump/dev_set/norm \
        --outdir exp/f32 --config train.yaml --data-root corpus/data \
        --resume "exp/stem/checkpoint-${STEM}steps.ckpt" 2> train_f32.log \
        || { tail -20 train_f32.log; exit 1; }
fi

cd "$WORK"

decode () {  # outdir extra_flags...
    local out=$1; shift
    [ -d "$out" ] && [ -n "$(ls "$out" 2>/dev/null)" ] && return 0
    $BIN.decode --device "$DEVICE" \
        --feats-scp corpus/data/dev_set/feats.scp --checkpoint "$CKPT" \
        --config train.yaml --outdir "$out" "$@" 2> "decode_${out}.log" \
        || { cat "decode_${out}.log"; exit 1; }
    echo "== $out RTF:"; grep "Average RTF" "decode_${out}.log" || true
}

decode out_f32
decode out_bf16w --bf16-weights

[ -f ulp_decode_control.ckpt ] || \
    $TOOLS.perturb_ckpt "$CKPT" ulp_decode_control.ckpt
CKPT_SAVE=$CKPT; CKPT=ulp_decode_control.ckpt
decode out_f32ulp_decode
CKPT=$CKPT_SAVE

echo "== MCD(bf16w, f32) — numeric cost of bf16-stored weights =="
$BIN.compute_mcd --gen-dir out_bf16w --ref-dir out_f32
echo "== MCD(f32-1ulp, f32) — the f32 decode's own noise cone =="
$BIN.compute_mcd --gen-dir out_f32ulp_decode --ref-dir out_f32
echo "== MCD(f32, ground truth) =="
$BIN.compute_mcd --gen-dir out_f32 --ref-dir corpus/wavs --dtw
echo "== MCD(bf16w, ground truth) =="
$BIN.compute_mcd --gen-dir out_bf16w --ref-dir corpus/wavs --dtw
echo "== MCD(f32-1ulp, ground truth) =="
$BIN.compute_mcd --gen-dir out_f32ulp_decode --ref-dir corpus/wavs --dtw
