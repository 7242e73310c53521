#!/bin/bash
# int8-weight DECODE quality A/B on the port (port of
# tools/int8_quality_ab.sh; no JAX needed).
#
# The chaos-aware protocol of the bf16/hybrid decode A/Bs
# (bf16_quality_ab.sh): decode ONE trained f32 checkpoint three ways —
#   f32      — baseline decode,
#   int8     — --int8-weights (per-out-channel symmetric over folded kernels),
#   f32-1ulp — f32 decode of a 1-ulp-perturbed copy of the same checkpoint
#              (the f32 decode's OWN chaos cone),
# then report MCD(int8, f32) vs the cone and each arm's ground-truth MCD.
# Acceptance: |MCD_gt(int8) - MCD_gt(f32)| <= 0.1 dB with MCD(int8, f32)
# ~ the cone; outside -> quantified negative, int8 stays opt-in.
#
# Usage: int8_quality_ab.sh [workdir] [ckpt]
#   workdir must contain corpus/ + dump/ + train.yaml in the
#   hybrid_train_quality_ab.sh layout (default: $TMPDIR/hytrainab, reusing
#   its 4000-step f32 checkpoint); out_f32 is reused if already decoded.
# Environment: DEVICE (default cuda).
set -euo pipefail

WORK=${1:-${TMPDIR:-/tmp}/hytrainab}
CKPT=${2:-exp/f32/checkpoint-4000steps.ckpt}
DEVICE=${DEVICE:-cuda}
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO:${PYTHONPATH:-}"
BIN="python3 -m articulatory_tpu_torch.bin"
TOOLS="python3 -m articulatory_tpu_torch.tools"
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
decode out_int8 --int8-weights

[ -f ulp_decode_control.ckpt ] || \
    $TOOLS.perturb_ckpt "$CKPT" ulp_decode_control.ckpt
CKPT_SAVE=$CKPT; CKPT=ulp_decode_control.ckpt
decode out_f32ulp_decode
CKPT=$CKPT_SAVE

echo "== MCD(int8, f32) — numeric cost of int8 weights =="
$BIN.compute_mcd --gen-dir out_int8 --ref-dir out_f32
echo "== MCD(f32-1ulp, f32) — the f32 decode's own noise cone =="
$BIN.compute_mcd --gen-dir out_f32ulp_decode --ref-dir out_f32
echo "== MCD(f32, ground truth) =="
$BIN.compute_mcd --gen-dir out_f32 --ref-dir corpus/wavs --dtw
echo "== MCD(int8, ground truth) =="
$BIN.compute_mcd --gen-dir out_int8 --ref-dir corpus/wavs --dtw
echo "== MCD(f32-1ulp, ground truth) =="
$BIN.compute_mcd --gen-dir out_f32ulp_decode --ref-dir corpus/wavs --dtw
