#!/bin/bash
# Hybrid-precision quality A/B for the MRI2W shape (240x upsample, 20 kHz)
# on the port (port of tools/mri_hybrid_quality_ab.sh; no JAX needed).
#
# Companion to bf16_quality_ab.sh (E2W): decodes the MRI checkpoint trained
# by mri_convergence_demo.sh three times — f32 (the demo's own decode),
# hybrid precision, and an f32 decode from a 1-ulp-perturbed checkpoint
# (the noise-cone control) — and reports MCD between every pair and against
# ground truth. Acceptance (docs/DESIGN.md §7): hybrid is indistinguishable
# from f32 iff its divergence from f32 is ~the 1-ulp cone AND its
# ground-truth MCD is within the 0.1 dB budget of f32's.
#
# Usage: mri_hybrid_quality_ab.sh [demo_workdir]
# Requires a completed mri_convergence_demo.sh run in the workdir.
# Environment: DEVICE (default cuda).
set -euo pipefail

WORK=${1:-${TMPDIR:-/tmp}/mridemo}
DEVICE=${DEVICE:-cuda}
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO:${PYTHONPATH:-}"
BIN="python3 -m articulatory_tpu_torch.bin"
TOOLS="python3 -m articulatory_tpu_torch.tools"

cd "$WORK"
CKPT=exp/mri/best_mel_ckpt.pkl
[ -f "$CKPT" ] || CKPT=$(ls exp/mri/checkpoint-*steps.ckpt | sort -V | tail -1)
echo "== checkpoint: $CKPT"

python3 - exp/mri/config.yml hybrid.yaml << 'EOF'
import sys, yaml
cfg = yaml.safe_load(open(sys.argv[1]))
cfg["generator_params"] = dict(cfg["generator_params"],
                               compute_dtype="bfloat16",
                               hybrid_precision=True)
yaml.dump(cfg, open(sys.argv[2], "w"))
EOF

if [ ! -d out_dev ]; then  # the demo decodes f32 as out_dev; redo if absent
    $BIN.decode --device "$DEVICE" \
        --feats-scp corpus/data/dev_set/feats.scp --checkpoint "$CKPT" \
        --config exp/mri/config.yml --outdir out_dev 2> decode_f32.log \
        || { cat decode_f32.log; exit 1; }
fi

$BIN.decode --device "$DEVICE" \
    --feats-scp corpus/data/dev_set/feats.scp --checkpoint "$CKPT" \
    --config hybrid.yaml --outdir out_hybrid 2> decode_hybrid.log \
    || { cat decode_hybrid.log; exit 1; }
echo "== hybrid decode RTF:"; tail -2 decode_hybrid.log

# 1-ulp noise-cone control (chunked-AR decode is chaotic; see DESIGN.md §7)
$TOOLS.perturb_ckpt "$CKPT" ulp_control.ckpt
$BIN.decode --device "$DEVICE" \
    --feats-scp corpus/data/dev_set/feats.scp --checkpoint ulp_control.ckpt \
    --config exp/mri/config.yml --outdir out_f32ulp 2> decode_f32ulp.log \
    || { cat decode_f32ulp.log; exit 1; }

echo "== MCD(hybrid, f32) — numeric cost of hybrid =="
$BIN.compute_mcd --gen-dir out_hybrid --ref-dir out_dev
echo "== MCD(f32-1ulp, f32) — the f32 decode's own noise cone =="
$BIN.compute_mcd --gen-dir out_f32ulp --ref-dir out_dev
echo "== MCD(f32, ground truth) =="
$BIN.compute_mcd --gen-dir out_dev --ref-dir corpus/wavs --dtw
echo "== MCD(hybrid, ground truth) =="
$BIN.compute_mcd --gen-dir out_hybrid --ref-dir corpus/wavs --dtw
echo "== MCD(f32-1ulp, ground truth) =="
$BIN.compute_mcd --gen-dir out_f32ulp --ref-dir corpus/wavs --dtw
