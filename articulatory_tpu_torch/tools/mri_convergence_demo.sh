#!/bin/bash
# MRI2W convergence demo on the port (port of tools/mri_convergence_demo.sh;
# no JAX needed): the 240x-upsample recipe.
#
# Trains egs/mri/voc1/conf/mri2w_hifigan_car.yaml (20 kHz, hop 240,
# 358-channel generator input, upsample 8*5*3*2, dataset_mode
# `tracks_npy_minc_punc2wav_adobe_0p9_punc`) as it is but for the step
# budget, on a synthetic 230-dim MRI-like corpus (make_synth_corpus.py
# --profile mri: features derived from the audio, so the mapping is
# learnable), then CAR-decodes the held-out dev set and reports MCD against
# ground truth: the 240x transposed-conv path trains and converges end to
# end through the CLIs.
#
# Usage: mri_convergence_demo.sh [workdir] [train_steps] [n_utts]
# Environment: DEVICE (default cuda).
set -euo pipefail

WORK=${1:-${TMPDIR:-/tmp}/mridemo}
STEPS=${2:-20000}
NUTTS=${3:-160}
DEVICE=${DEVICE:-cuda}
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO:${PYTHONPATH:-}"
CONF_SRC="$REPO/egs/mri/voc1/conf/mri2w_hifigan_car.yaml"
BIN="python3 -m articulatory_tpu_torch.bin"
TOOLS="python3 -m articulatory_tpu_torch.tools"

mkdir -p "$WORK"
if [ ! -d "$WORK/corpus" ]; then
    $TOOLS.make_synth_corpus --root "$WORK/corpus" \
        --profile mri --n-utts "$NUTTS" --dev-utts $((NUTTS / 10)) \
        --min-seconds 2.0 --max-seconds 5.0
fi

python3 - "$CONF_SRC" "$WORK/train.yaml" "$STEPS" << 'EOF'
import sys, yaml
cfg = yaml.safe_load(open(sys.argv[1]))
steps = int(sys.argv[3])
cfg["train_max_steps"] = steps
cfg["save_interval_steps"] = max(1000, steps // 4)
cfg["eval_interval_steps"] = 1000
cfg["log_interval_steps"] = 200
# scale the LR-halving milestones into the demo's step budget
for k in ("generator_scheduler_params", "discriminator_scheduler_params"):
    cfg[k]["milestones"] = [int(steps * f) for f in (0.5, 0.75)]
cfg["use_device_cache"] = True  # the corpus fits the card
cfg["format"] = "npy"  # no h5py needed
yaml.dump(cfg, open(sys.argv[2], "w"))
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

RESUME=""
last=$(ls exp/mri/checkpoint-*steps.ckpt 2>/dev/null | sort -V | tail -1 || true)
[ -n "$last" ] && RESUME="--resume $last"
$BIN.train --device "$DEVICE" \
    --train-dumpdir dump/tr_set/norm --dev-dumpdir dump/dev_set/norm \
    --outdir exp/mri --config train.yaml --data-root corpus/data $RESUME

CKPT=exp/mri/best_mel_ckpt.pkl
[ -f "$CKPT" ] || CKPT=$(ls exp/mri/checkpoint-*steps.ckpt | sort -V | tail -1)
$BIN.decode --device "$DEVICE" \
    --feats-scp corpus/data/dev_set/feats.scp --checkpoint "$CKPT" \
    --config exp/mri/config.yml --outdir out_dev 2> decode.log \
    || { cat decode.log; exit 1; }
echo "== decode RTF:"; tail -2 decode.log
echo "== MCD(decode, ground truth) on held-out dev =="
$BIN.compute_mcd --gen-dir out_dev --ref-dir corpus/wavs --dtw
