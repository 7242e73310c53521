#!/usr/bin/env bash
# Stages 1-3 of the recipes' run.sh (egs/ema/voc1/run.sh, egs/mri/voc1/run.sh:
# 1 feature extraction, 2 training, 3 decoding) on the PyTorch port alone:
# every stage calls articulatory_tpu_torch.bin.* and launches its jobs
# through articulatory_tpu_torch.utils.run_jobs, so neither JAX nor h5py is
# needed (set "format: npy" in the config where h5py is missing).
#
# Run it from a recipe directory, whose path.sh, conf/, data/ and
# utils/{parse_options.sh,split_scp.py} it uses; of cmd.sh it reads only
# cmd_backend and cmd_config (the job backend: local, stdout, slurm, sge,
# ssh). The EMA and MRI recipes differ here only in the defaults below,
# chosen by the recipe directory's parent (egs/mri -> MRI). Stage 0 (data
# preparation of the downloaded MNGU0 / NAPA corpora) stays with the
# recipe's own run.sh --stop_stage 0.
#
#   cd egs/ema/voc1 && bash ../../../articulatory_tpu_torch/recipe/run.sh \
#       --conf conf/e2w_hifigan_car.yaml [--device cuda] [--stage 1] \
#       [--stop_stage 3] [--n_jobs 8] [--expdir exp/x] [--checkpoint ckpt]

set -euo pipefail

. ./path.sh

cmd_backend=local
cmd_config=
if [ -f ./cmd.sh ]; then
    eval "$(grep -E '^(cmd_backend|cmd_config)=' ./cmd.sh)"
fi

stage=1
stop_stage=3
n_jobs=8
if [ "$(basename "$(dirname "${PWD}")")" = mri ]; then
    conf=conf/mri2w_hifigan_car.yaml
    train_set=napa_train
    dev_set=napa_val
    eval_set=napa_test
else
    conf=conf/e2w_hifigan.yaml
    train_set=mngu0_train_fnema
    dev_set=mngu0_val_fnema
    eval_set=mngu0_test_fnema
fi
expdir=""
resume=""
pretrain=""
checkpoint=""
device=cuda

. ./utils/parse_options.sh

tag=$(basename "${conf}" .yaml)
if [ -z "${expdir}" ]; then
    expdir=exp/${train_set}_${tag}
fi
train_cmd="python3 -m articulatory_tpu_torch.utils.run_jobs --backend ${cmd_backend} ${cmd_config:+--config ${cmd_config}}"

if [ "${stage}" -le 0 ]; then
    echo "Stage 0 (data preparation) is not run here: it needs the" \
        "downloaded corpora; run the recipe's run.sh --stop_stage 0"
fi

if [ "${stage}" -le 1 ] && [ "${stop_stage}" -ge 1 ]; then
    echo "Stage 1: Feature extraction (at ${SECONDS} s)"
    for name in "${train_set}" "${dev_set}" "${eval_set}"; do
        dumpdir=dump/${name}/raw
        mkdir -p "${dumpdir}" log
        shards=""
        for j in $(seq 1 "${n_jobs}"); do shards="${shards} ${dumpdir}/wav.${j}.scp"; done
        # shellcheck disable=SC2086
        python3 utils/split_scp.py "data/${name}/wav.scp" ${shards}
        ${train_cmd} JOB=1:"${n_jobs}" "log/preprocess.${name}.JOB.log" \
            python3 -m articulatory_tpu_torch.bin.preprocess \
                --wav-scp "${dumpdir}/wav.JOB.scp" \
                --dumpdir "${dumpdir}" --config "${conf}" --verbose 0
    done
    python3 -m articulatory_tpu_torch.bin.compute_statistics \
        --rootdir "dump/${train_set}/raw" --config "${conf}" \
        --dumpdir "dump/${train_set}"
    # stats.h5 or stats.npy, by the config's format
    stats=dump/${train_set}/stats.h5
    [ -f "${stats}" ] || stats=dump/${train_set}/stats.npy
    for name in "${train_set}" "${dev_set}" "${eval_set}"; do
        python3 -m articulatory_tpu_torch.bin.normalize \
            --rootdir "dump/${name}/raw" --dumpdir "dump/${name}/norm" \
            --stats "${stats}" --config "${conf}"
    done
fi

if [ "${stage}" -le 2 ] && [ "${stop_stage}" -ge 2 ]; then
    echo "Stage 2: Training (${expdir}) (at ${SECONDS} s)"
    mkdir -p "${expdir}"
    python3 -m articulatory_tpu_torch.bin.train \
        --train-dumpdir "dump/${train_set}/norm" \
        --dev-dumpdir "dump/${dev_set}/norm" \
        --outdir "${expdir}" --config "${conf}" --device "${device}" \
        ${pretrain:+--pretrain "${pretrain}"} \
        ${resume:+--resume "${resume}"}
fi

if [ "${stage}" -le 3 ] && [ "${stop_stage}" -ge 3 ]; then
    echo "Stage 3: Decoding (at ${SECONDS} s)"
    [ -z "${checkpoint}" ] && checkpoint=${expdir}/best_mel_ckpt.pkl
    outdir=${expdir}/wav/$(basename "${checkpoint}" .pkl)
    for name in "${dev_set}" "${eval_set}"; do
        python3 -m articulatory_tpu_torch.bin.decode \
            --feats-scp "data/${name}/feats.scp" \
            --checkpoint "${checkpoint}" --device "${device}" \
            --outdir "${outdir}/${name}"
    done
fi

echo "Finished (at ${SECONDS} s)."
