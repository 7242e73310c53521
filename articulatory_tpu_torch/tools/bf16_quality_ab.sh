#!/bin/bash
# bf16 generator-compute quality A/B on the port (port of
# tools/bf16_quality_ab.sh; no JAX needed).
#
# Trains the flagship E2W HiFi-CAR config for a few thousand steps on a
# synthetic corpus (make_synth_corpus.py beside this file), then decodes the
# held-out dev set from the SAME checkpoint in f32, bf16 and hybrid
# generator compute, and an f32 decode of a 1-ulp-perturbed copy of the
# checkpoint (perturb_ckpt.py), and reports:
#   (a) MCD(bf16 decode, f32 decode)   -> the numeric cost of bf16
#   (b) MCD(f32 decode, ground truth)  -> absolute quality anchor
#   (c) MCD(bf16 decode, ground truth)
#   (d) MCD(hybrid, f32) and MCD(hybrid, ground truth)
#   (e) MCD(f32-1ulp, f32): the f32 decode's own noise cone, and
#       MCD(f32-1ulp, ground truth)
# plus each decode's RTF. The 0.1 dB budget (BASELINE.md: "MCD within 0.1 dB
# of the PyTorch reference") is the bar for making bf16 a decode default.
#
# Usage: bf16_quality_ab.sh [workdir] [train_steps]
# Environment: DEVICE (default cuda; cpu for a host run), and for a short
# run N_UTTS / DEV_UTTS (corpus, default 80 / 8), MIN_SECONDS / MAX_SECONDS
# (default 2 / 6) and BATCH_SIZE (default the config's 64).
set -euo pipefail

WORK=${1:-${TMPDIR:-/tmp}/bf16ab}
STEPS=${2:-4000}
DEVICE=${DEVICE:-cuda}
REPO=$(cd "$(dirname "$0")/../.." && pwd)
export PYTHONPATH="$REPO:${PYTHONPATH:-}"
CONF_SRC="$REPO/egs/ema/voc1/conf/e2w_hifigan_car.yaml"
BIN="python3 -m articulatory_tpu_torch.bin"
TOOLS="python3 -m articulatory_tpu_torch.tools"

mkdir -p "$WORK"
if [ ! -d "$WORK/corpus" ]; then
    $TOOLS.make_synth_corpus --root "$WORK/corpus" \
        --n-utts "${N_UTTS:-80}" --dev-utts "${DEV_UTTS:-8}" \
        --min-seconds "${MIN_SECONDS:-2.0}" --max-seconds "${MAX_SECONDS:-6.0}"
fi

python3 - "$CONF_SRC" "$WORK/train.yaml" "$STEPS" "${BATCH_SIZE:-}" << 'EOF'
import sys, yaml
cfg = yaml.safe_load(open(sys.argv[1]))
cfg["train_max_steps"] = int(sys.argv[3])
cfg["save_interval_steps"] = max(500, int(sys.argv[3]) // 2)
cfg["eval_interval_steps"] = 1000
cfg["log_interval_steps"] = 200
cfg["use_device_cache"] = True  # the corpus fits the card; batches gathered there
cfg["format"] = "npy"  # no h5py needed
if sys.argv[4]:
    cfg["batch_size"] = int(sys.argv[4])
yaml.dump(cfg, open(sys.argv[2], "w"))
bf = dict(cfg)
bf["generator_params"] = dict(cfg["generator_params"], compute_dtype="bfloat16")
yaml.dump(bf, open(sys.argv[2].replace("train.yaml", "bf16.yaml"), "w"))
hy = dict(cfg)
hy["generator_params"] = dict(cfg["generator_params"],
                              compute_dtype="bfloat16", hybrid_precision=True)
yaml.dump(hy, open(sys.argv[2].replace("train.yaml", "hybrid.yaml"), "w"))
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

CKPT="exp/ab/checkpoint-${STEPS}steps.ckpt"
if [ ! -f "$CKPT" ]; then
    $BIN.train --device "$DEVICE" \
        --train-dumpdir dump/tr_set/norm --dev-dumpdir dump/dev_set/norm \
        --outdir exp/ab --config train.yaml --data-root corpus/data
fi

for variant in f32 bf16 hybrid; do
    conf=train.yaml
    [ "$variant" = bf16 ] && conf=bf16.yaml
    [ "$variant" = hybrid ] && conf=hybrid.yaml
    $BIN.decode --device "$DEVICE" \
        --feats-scp corpus/data/dev_set/feats.scp --checkpoint "$CKPT" \
        --config "$conf" --outdir "out_$variant" \
        2> "decode_$variant.log" || { cat "decode_$variant.log"; exit 1; }
    echo "== decode_$variant RTF:"; tail -2 "decode_$variant.log"
done

echo "== MCD(bf16, f32) — numeric cost of bf16 =="
$BIN.compute_mcd --gen-dir out_bf16 --ref-dir out_f32
echo "== MCD(f32, ground truth) =="
$BIN.compute_mcd --gen-dir out_f32 --ref-dir corpus/wavs --dtw
echo "== MCD(bf16, ground truth) =="
$BIN.compute_mcd --gen-dir out_bf16 --ref-dir corpus/wavs --dtw
echo "== MCD(hybrid, f32) — numeric cost of hybrid bf16 =="
$BIN.compute_mcd --gen-dir out_hybrid --ref-dir out_f32
echo "== MCD(hybrid, ground truth) =="
$BIN.compute_mcd --gen-dir out_hybrid --ref-dir corpus/wavs --dtw

# Self-drift control: the chunked-AR decode is chaotic (past the Lyapunov
# horizon any perturbation decorrelates waveforms), so MCD(variant, f32)
# alone can't separate "worse quality" from "different trajectory of the
# same quality". Decode the SAME f32 config from a 1-ulp-perturbed
# checkpoint: that MCD is the f32 decode's OWN noise cone. A precision
# variant whose (a) divergence is ~the cone and (b) ground-truth MCD is
# within the 0.1 dB budget of f32's is numerically indistinguishable from
# an f32 decode; one outside the cone genuinely degrades.
# perturb the SAME checkpoint the f32/bf16/hybrid arms decode
$TOOLS.perturb_ckpt "$CKPT" exp/ab/ulp_control.ckpt
$BIN.decode --device "$DEVICE" \
    --feats-scp corpus/data/dev_set/feats.scp \
    --checkpoint exp/ab/ulp_control.ckpt \
    --config train.yaml --outdir out_f32ulp 2> decode_f32ulp.log \
    || { cat decode_f32ulp.log; exit 1; }
echo "== MCD(f32-1ulp, f32) — the f32 decode's own noise cone =="
$BIN.compute_mcd --gen-dir out_f32ulp --ref-dir out_f32
echo "== MCD(f32-1ulp, ground truth) =="
$BIN.compute_mcd --gen-dir out_f32ulp --ref-dir corpus/wavs --dtw
