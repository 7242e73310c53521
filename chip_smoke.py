#!/usr/bin/env python3
"""Smoke test of articulatory_tpu_torch on one NVIDIA GPU.

Drives the port's paths at the full width of
``egs/ema/voc1/conf/e2w_hifigan_car.yaml`` (141 input channels incl. 128 AR
features, channels 512, upsample (5, 4, 2, 2), MRF kernels (3, 7, 11) x
dilations (1, 3, 5), AR 512), in phase 7 of
``egs/mri/voc1/conf/mri2w_hifigan_car.yaml``, in phases 8-11 of the
inversion BiGRU of ``benchmarks/inversion_bench.py`` and the stream server,
in phases 12-13 of the generator zoo on
``egs/ema/voc1/conf/e2w_hifigan.yaml``, in phases 14-18 of its
conditioned, chained and multimodal forms, in phases 21-24 of the
remaining entry points, weight storage, causal convs and SSL inversion,
in phases 25-28 of its data-, tensor-, pipeline- and
sequence-parallel paths, in phases 29-32 of its export, checkpoint
conversion, pretrained registry and quality A/B tools, and in phase 33 of
its co-training parity harness, through their entry points:

- E2W HiFi-CAR chunked-autoregressive synthesis with 100-frame chunks
  (``load_model`` -> ``ar_loop_batched``, eager and through the captured
  chunk loop, ``ar_loop_scan``, and the ``bin/decode.py`` loop), weights
  random from ``--seed`` in the JAX package's layout, carried across by
  ``jax_params_to_state_dict``;
- the GAN training step (``bin/train.py::train``) with the config's MSMPD
  discriminator (3 scales, downsample (4, 4, 4, 4, 1); periods 2-11),
  losses, Adam optimisers and batch (64 x 2000 samples), on a synthetic npy
  corpus drawn from ``--seed``.

Phases, each raising on failure:

1. device: the card, its power limit, torch and CUDA versions;
2. build: every ``csrc/*.cu`` with nvcc (one process per source);
3. kernel: ``resblock_pair`` against ``resblock_pair_plain`` (cuDNN convs,
   TF32 off) at all 36 main-path (C, K, d) shapes, with the main path's
   batch (UTTS) and each stage's T per chunk, plus a ragged T,
   in f32 (max error <= 1e-4 of max |y|, and <= F64_TOL = 1e-5 against
   the plain pair in float64 on the card, printed beside cuDNN f32's own
   error against it) and bf16 (<= 2e-2 of max |y|), with both timed by
   CUDA events over a CUDA-graph replay (device time, no host time; the f32
   kernel's time includes its weight split, ``split_tf32``, held bit for
   bit against ``split_tf32_plain`` and timed alone beside it) and summed
   per stage; and the host's
   time per launch, under ``inference_mode`` and with inputs that require
   grad (through the ``autograd.Function``);
4. slice: ``ar_loop_batched`` over UTTS utterances of SECONDS s
   in f32 and hybrid bf16, with the kernel's launch count held to
   36 x chunks per run, the weight split run 45 times in the warm-up (each
   f32 pair's first chunk) and none in the run (cached on the frozen
   kernels), finite outputs of the right length, each of three
   chunks held against the plain pair under the shared carry (f32 max abs
   error <= 1e-6, hybrid <= 5e-3, on tanh outputs), one chunk forward
   timed with the kernel, with plain pairs and with no pairs in turns
   (median and range of ROUNDS), one ``torch.profiler`` window over
   PROFILE_CHUNKS hybrid chunk forwards (the device's busy share and its
   top ops by time); then [graph] the captured chunk loop
   (``ar_loop_batched(scan=True)``, a CUDA graph) beside the eager loop in
   f32 and hybrid: capture launches, samples/s of both in turns, chunks
   0, 1 and the last against the eager forward under the graph run's carry
   (CHUNK_TOL), a profiler window over PROFILE_CHUNKS replays counting 36
   ``resblock_pair_wgmma`` kernels a replay and no weight split, and the
   single-stream RTF of ``ar_loop_scan`` against ``ar_loop`` on one
   utterance; [weights] int8 and bf16 weight storage through the graph
   loop (36 weight splits in its warm-up, none after; chunks against plain
   pairs on the same stored weights; samples/s); and ``bin/decode.py`` on
   a 2-utterance .npy dump: eager, ``--ar-scan`` with batch 1 and 4, and
   ``--int8-weights``;
5. head kernel: ``scale_disc_head`` against ``scale_disc_head_plain`` at
   the training path's three scales (B 64, T 2512/1257/629, stride 4) and
   the Pallas kernel's shape (B 32, T 8512, stride 2), each also at T + 3,
   in f32 (<= 1e-4 of max |h|, and <= F64_TOL against the plain head in
   float64 on the card, cuDNN f32's own error beside it) and bf16 (<= 2e-2),
   timed in turns by CUDA-graph replay (the kernel's time includes its
   weight split, ``split_weights``, held bit for bit against
   ``split_weights_plain`` and timed alone beside it), with the 3xTF32 and
   the FMA bound; the host's time per head launch; and ``resblock_pair``
   at the training path's 36 shapes (B 64, 25 frames); [pair-backward]:
   the f32 pair's backward kernels at the same shapes against their bound
   and the backward by recomputation ([mri-pair-backward] at MRI's);
   [banded-attention]: the banded attention's kernels at the inversion
   cell's layer (B 32, 8 heads, L 2000, d 96, m 100, dropout 0.2) against
   the plain version in float64 on the card (o, dq, dk, dv, dE within
   BANDED_TOL), timed beside their bound and the plain version;
6. train: ``train(config)`` for TRAIN_STEPS steps on TRAIN_UTTS
   utterances of TRAIN_SECONDS s (13 features at 200 Hz), holding (a)
   every loss finite, (b) every generator and discriminator parameter
   moved from its initial value, (c) the launches per dtype that
   ``expected_launches`` derives from the config (in f32 72
   ``resblock_pair``, 72 weight-split, 12 ``scale_disc_head`` and 12 head
   weight-split launches per step), (d) on one batch the
   generator's and discriminator's gradients with both kernels against
   both plain versions (relative L2 per model <= GRAD_TOL[0], per tensor
   <= GRAD_TOL[1]), (e) a decode of one chunk from the written checkpoint
   through ``inference.load_model``; then times full steps (median of
   STEP_ROUNDS) and the generator fwd+bwd, regeneration and discriminator
   fwd+bwd apart; then [hybrid-train] (phase 20) on the same corpus;
7. mri: the repo's second recipe, ``egs/mri/voc1/conf/mri2w_hifigan_car.yaml``
   (format npy), at full width (230 features + 128 AR, channels 512,
   upsample (8, 5, 3, 2), 125-frame chunks, AR 512): ``resblock_pair`` at
   its 36 shapes (B 16, T 1000-30000) and ``scale_disc_head`` at its
   training scales (B 16, T 30512/15257/7629, stride 4), both as in phases
   3 and 5; its decode of MRI_UTTS x MRI_SECONDS s in f32 and hybrid, eager
   (launch counts, chunks against plain pairs) and captured (as [graph]);
   ``bin/decode.py --ar-scan`` on a dump in its dataset mode; and
   ``train(config)`` for MRI_TRAIN_STEPS steps at its B 16 x 30,000 on a
   synthetic corpus, checks (a)-(c) and (e) of phase 6 and the step time.

8. w2a: the full-utterance BiGRU (2 x BiGRU 256, FC 128, BatchNorm, FC
   12) at B 16 x 2000 frames (10 s at 200 Hz), 13-d and 1024-d inputs:
   samples/s of input audio (median of ROUNDS), and f32 against the same
   module in float64 on the card (<= W2A_F64_TOL of max |y|);
9. w2a-ar: its AR form (ar_input 512 over 12 channels: a 42-frame carry;
   13 + 64 inputs; 200-row chunks): one 10 s stream through
   ``ar_loop_scan`` (graph) against ``ar_loop`` (eager) in turns (RTF,
   outputs bit-equal), a W2A_TAIL-row ragged tail (the exact tail forward)
   bit-equal to ``ar_loop``, W2A_LANES lanes through ``ar_loop_batched``
   eager and ``scan=True`` in turns (samples/s; graph chunks bit-equal to
   eager forwards from the graph run's carry), and a profiler window over
   replays (the device's busy share);
10. w2a-cli: ``bin/decode.py`` in w2a mode on a wav.scp (a raw-wave AR
   BiGRU; eager, ``--ar-scan``, ``--decode-batch-size 4 --ar-scan``) and
   ``bin/predict_ema.py`` on a wav directory (with and without ``--ar-scan
   --batch 4``), each writing its .npy files;
11. stream: ``StreamingServer`` with STREAM_LANES lanes at the EMA width, in
   f32 and hybrid, through the churn of ``benchmarks/streaming_bench.py``
   (57 rounds: 10 at 1 stream, a ramp to 16, 10 at 16, a drain to 4, 10 at
   4; odd clients stall every seventh round): p50/p99 ms a round per phase,
   every round bit-equal to the eager masked step, every client bit-equal
   to its stream served alone in its lane, 36 pair kernels a round counted
   by the profiler and its busy share beside a replay's device time over
   the round's p50, one stream's ms a chunk synced, pipelined and by
   ``synthesize_all`` (bit-equal); then the AR BiGRU on the same churn,
   each client against its solo serve;
12. mb-kernel / mb-head: ``resblock_pair`` at the multi-band HiFi-GAN's 27
   shapes (B 32, 100 frames: C 256/128/64 at T 500/1000/2000) and
   ``scale_disc_head`` at its MSD's three scales (B 32, T 8000/4001/2001,
   stride 4), both as in phases 3 and 5;
13. zoo-<family>: each family of the generator zoo at full width (the
   configurations of ``zoo_configs``: e2w_hifigan.yaml's features, losses,
   optimizers and B 32 x 8000 samples with the family's generator and
   discriminator; the w2a Transformer and BiGRU on 13-d features in 400-row
   windows): ``train(config)`` for ZOO_WARMUP_STEPS steps (launch counts:
   54 pairs and 12 heads a multi-band step), one untimed and
   ZOO_TIMED_STEPS timed steps
   (finite losses, every parameter moved; the multi-band HiFi-GAN's
   gradients with both kernels against both plain versions, as in phase
   6), ``bin/decode.py`` on the written
   checkpoint over ZOO_DECODE_UTTS x ZOO_DECODE_SECONDS s (27 pairs a
   multi-band forward; finite outputs of the right length; samples/s,
   RTF), the f32 generator against float64 on the card (ZOO_F64_TOL) and a
   profiler window over ZOO_PROFILE_FORWARDS forwards;
14. cond-train: the EMA HiFi-CAR with speaker ids (COND_SPEAKERS), phoneme
   inputs and the phoneme head (COND_PHONEMES, COND_LAMBDA_PH) through
   ``train(config)`` on the phase 6 corpus with utt2spk and ph.scp:
   checks (a)-(d) of phase 6 (72 pairs and 12 heads a step; the
   conditioning's gradients printed apart), ``train/ph_loss`` finite and
   above 0; then one PCD step (random pitch and periodicity, a 3-channel
   MSMPD on plain convs: 72 pairs, no head);
15. cond-decode: a phoneme-head checkpoint decoded as in phase 4 (f32 and
   hybrid; eager launch counts, chunks against plain pairs, the graph run
   bit-equal to the eager one), phase 4's [graph] checks on it, and
   ``bin/decode.py`` eager and ``--ar-scan`` at batch UTTS writing the
   same wav files;
16. cascade: the w2a cycle of ``tests/test_cascade.py`` at full width, the
   [zoo-bigru] BiGRU into a frozen HiFi-GAN (CASCADE_GP2) loaded by
   ``--pretrain2`` from a checkpoint the phase writes: 18 pairs a step, no
   head, generator2 bit for bit as loaded, the generator's gradients with
   the pair kernel against the plain pair, the step median;
17. ph2a: the [zoo-transformer] Transformer on phoneme ids, 2 steps through
   ``train(config)`` and ``bin/decode.py`` on integer ids;
18. mult: ``ar_loop(modality=...)`` with an in-list callable around the
   full-width f32 HiFi-CAR on MRI-rate frames (36 pairs a chunk), chunks
   against the same callable on the CPU from the card's carry;
19. recipe: ``egs/ema/voc1/run.sh``'s stages on the port alone
   (``phase_recipe``) over a synthetic corpus in its layout: stages 1-3
   through ``articulatory_tpu_torch/recipe/run.sh`` from a recipe
   directory (``bin/preprocess.py`` in two jobs a set through
   ``utils/run_jobs.py``, ``compute_statistics``, ``normalize``, a short
   ``bin/train.py`` run, ``bin/decode.py`` of the dev and eval sets,
   ``bin/compute_mcd.py``: finite), then stage 2 in this process
   (e2w_hifigan_car.yaml as it stands, format npy, from the corpus cache
   on the card, with a profiled step: 72 pair, 36 pair backward and 12
   head kernels counted, the device time split into pair kernels, pair
   backward kernels, head kernels, convolutions and the rest, the busy
   share; the step from the cache, the host loader and the native loader
   in turns; the device time under the heads' recompute backward in the
   profiled step (no pair is recomputed); SizeAwareSampler with
   remove_short_samples), preemption (SIGTERM to ``bin/train.py``, exit 0,
   the checkpoint at its step, ``--resume``);
20. hybrid-train (run right after phase 6): the JAX package's default
   training precision, the generator with ``compute_dtype: bfloat16`` and
   ``hybrid_precision`` (stages 0-2 on the bf16 pair, the last on the f32
   one), through ``train()`` for 3 steps with phase 6's checks (a)-(e)
   (54 bf16 and 18 f32 pairs, 18 weight splits and 12 heads a step; in
   (d) a model's pooled gap within twice the plain bf16 gradient's own
   distance from the f32 one, at least GRAD_TOL[0]); then on one batch
   the f32, hybrid and hybrid + bf16-discriminator steps (12 bf16 heads a
   step) timed in turns (median of STEP_ROUNDS each, with their parts),
   one profiled hybrid step split as phase 19's, one ``use_remat`` step (a
   third generator forward) and one m2w step (80 mels), each with its
   launches counted;
21. entry: at the EMA width, in f32 and hybrid, ``bin/predict_wav.py`` on
   a JAX msgpack checkpoint (36 pairs a chunk; its wavs equal to
   ``bin/decode.py``'s eager ones), ``bin/model_stats.py`` over 100-800
   frames (latency, RTF), and ``bin/convert_checkpoint.py --to-torch``,
   whose pickle decodes bit-equal to the msgpack;
22. storage-zoo: int8 and bf16 weights of every family of phase 13 and of
   the AR BiGRU through the graph loop, each against its float32 twin
   (STORAGE_TOL of max |y|), samples/s in turns (27 pairs a multi-band
   forward);
23. causal-melgan, causal-pwg: phase 13 on causal MelGAN and Parallel
   WaveGAN (step median, decode samples/s, f32 against float64);
24. ssl: the ``_h2`` inversion: 1024-wide hidden states interpolated on
   the card into the AR BiGRU, eager and graph, against the CPU; a HuBERT
   of hubert-large-ll60k's config with random weights on the card against
   the CPU, and ``bin/predict_ema.py`` on an ``_h2`` experiment;
25. dp: ``python -m articulatory_tpu_torch.distributed.launch
   --nproc_per_node 2`` on this script's rank worker (``--rank-worker``),
   which runs ``bin/train.py``'s ``main``: two ranks sharing the card
   (gloo), f32, B 32 x 2000 a rank (the global batch is phase 6's B 64),
   3 steps on phase 6's corpus with an evaluation; both ranks' parameters
   bit-equal after every step, 72 pair and 12 head launches a step on
   each rank, the step-1 all-reduced gradients against one process's on
   the concatenated batch (GRAD_TOL[0] pooled per model); the step median
   per rank, the loader's host time between steps, the backend and the
   time inside the collectives; then [dp-native], the same with
   ``use_native_loader: true``: each rank's batches equal to its shard of
   ``NativeDataLoader(shard_id=r, num_shards=2)`` built here, no loader
   warning, and its step median beside the host loader's;
26. tp: the same with ``tensor_parallel: 2`` (one TP group sharing B 16),
   2 steps: the gathered generator bit-equal on both ranks, each rank's
   pairs those of its MRF blocks, the gathered gradients against one
   process's, the checkpoint full; each rank's parameter count;
27. pp: ``PipelinedGenerator`` of the EMA HiFi-CAR over 2 and 3 stage
   groups on cuda:0 (a stream each), B 16 chunks of 100 frames with the
   512-sample carry, 2 and 4 microbatches, f32 and hybrid: bit-equal to
   the monolith on the same microbatches, within KERNEL_TOL of the
   whole-batch forward, 36 pairs a microbatch, its time against the
   monolith's;
28. sp: the EMA widths without AR, one 60 s utterance (12,000 frames) in
   4 time tiles (``LoadedModel.enable_sequence_parallel``) against the
   unsharded forward (SP_TOL of max |y|), the peak memory of both, and
   ``bin/decode.py --sequence-parallel 4`` against the unsharded decode;
   then [past-seq]: ``PastSeqEncoder`` at its defaults on a B 16 x P 512
   past, the card's eval forward against the CPU's in float64
   (PAST_SEQ_F64_TOL of max |y|), its float32 against the CPU's float64
   beside the CPU's float32, its ms, and its training dropout from a card
   generator.

29. export: the EMA HiFi-CAR at full width, f32 and hybrid, B 16 chunks of
   100 frames with the 512-sample carry, through ``export.to_torch_export``
   and ``serialize``: 36 pair op nodes in the graph; a fresh process of
   this script (``--export-worker``) that imports the port alone
   deserializes and runs it bit-equal to the eager chunk forward with 36
   hand pair launches; here the loaded program is within CHUNK_TOL of the
   forward on plain pairs, and its ms a forward against eager's, in turns,
   at most EXPORT_SLOWER times eager's; the frozen kernels are the
   program's constants (no weight-norm parameter in its state);
30. convert: a reference-format pickle of the same weights through
   ``bin/convert_checkpoint.py``'s default direction to a JAX msgpack,
   which ``load_model`` decodes bit-equal to the pickle;
31. pretrained: ``utils/pretrained.py::download_pretrained_model`` from a
   local HTTP server behind a confirm-token interstitial, the checkpoint
   extracted into a temporary cache and decoded bit-equal to phase 30's;
32. quality: ``articulatory_tpu_torch/tools/bf16_quality_ab.sh`` end to
   end at a tiny size (QUALITY_ENV, QUALITY_STEPS steps): every stage and
   MCD of the A/B on the card without JAX (the MCDs printed);
33. cotrain: ``articulatory_tpu_torch/tools/cotrain_parity.py --against``
   the committed f32-wide co-training artifact (``phase_cotrain``): the
   e2w_hifigan_car generator at full width and its discriminator trained
   300 steps from the artifact's seed (inputs' digests equal to the
   artifact's), with the hand kernels and then with their plain versions,
   in turns in a process of their own (``--cotrain-worker``) beside phase
   32, each within the artifact's bounds against the JAX trajectory and
   decodes, and launching exactly the kernels of ``expected_launches``.

Prints the card's ``nvidia-smi`` name and power limit, one JSON line
``{"kernels": [...]}``, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Per-shape numbers go to ``chiprun_out/chip_smoke.json``. Exits non-zero,
printing no result, without a CUDA device or outside a checkout of the repo.

    python3 chip_smoke.py [--seed 0]
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

from articulatory_tpu_torch.utils.numpy_init import (  # noqa: E402
    numpy_generator_params,
)

# egs/ema/voc1/conf/e2w_hifigan_car.yaml (generator_params, signal keys);
# batch_max_steps 8000 gives bench.py's 100-frame chunks
GENERATOR_PARAMS = {
    "in_channels": 141, "out_channels": 1, "channels": 512, "kernel_size": 7,
    "upsample_scales": [5, 4, 2, 2], "upsample_kernel_sizes": [10, 8, 4, 4],
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilations": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    "use_additional_convs": True, "bias": True,
    "nonlinear_activation": "LeakyReLU",
    "nonlinear_activation_params": {"negative_slope": 0.1},
    "use_weight_norm": True, "use_ar": True, "ar_input": 512,
    "ar_hidden": 256, "ar_output": 128, "final_scale": 80, "extra_art": False,
}
CONFIG = {"sampling_rate": 16000, "hop_size": 80, "dataset_mode": "a2w",
          "format": "npy", "batch_max_steps": 8000, "time_packing": "auto",
          "generator_type": "HiFiGANGenerator",
          "generator_params": GENERATOR_PARAMS}
N_FEATS = 141 - 128
CHUNK_FRAMES = 100
UTTS, SECONDS = 16, 10  # the decode's batch, and each utterance's length
ROUNDS = 5  # chunk-forward timings taken in turns, for median and range
PROFILE_CHUNKS = 5  # hybrid chunk forwards in the profiler window
PROFILE_LEAD_S = 0.05  # idle host time that opens a profiler window
# eager and graph decodes timed in turns (after one untimed call of each)
TURNS = ("eager", "graph", "graph", "eager") * 2
# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): fp32 outside the
# tensor cores, bf16 tensor cores, HBM3 bandwidth; and TF32 tensor cores,
# which the f32 pair runs at three products a multiply-add (3xTF32)
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
PEAK_TF32, TF32_PRODUCTS = 495e12, 3
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the f32 pair and head against their plain versions in float64 on the
# card, of max |y| (|h|): 3xTF32 keeps f32's accuracy there; one tf32
# product reads about 1e-4
F64_TOL = 1e-5
# chunk against plain pairs, max abs on tanh outputs: about 40x and 25x the
# readings on an H100 (2.4e-8 f32, 2.0e-4 hybrid)
CHUNK_TOL = {"f32": 1e-6, "hybrid_bf16": 5e-3}

# egs/ema/voc1/conf/e2w_hifigan_car.yaml, the rest of the training config
# (format npy: the card's machine has no h5py; no evaluation or interval
# checkpoint inside the run, so its launches are the steps' own)
TRAIN_CONFIG = dict(
    CONFIG, format="npy", batch_size=64, batch_max_steps=2000,
    num_workers=2, allow_cache=True,
    discriminator_type="HiFiGANMultiScaleMultiPeriodDiscriminator",
    discriminator_params={
        "scales": 3, "scale_downsample_pooling": "AvgPool1d",
        "scale_downsample_pooling_params": {"kernel_size": 4, "stride": 2,
                                            "padding": 2},
        "scale_discriminator_params": {
            "in_channels": 1, "out_channels": 1,
            "kernel_sizes": [15, 41, 5, 3], "channels": 128,
            "max_downsample_channels": 1024, "max_groups": 16, "bias": True,
            "downsample_scales": [4, 4, 4, 4, 1],
            "nonlinear_activation": "LeakyReLU",
            "nonlinear_activation_params": {"negative_slope": 0.1}},
        "follow_official_norm": True, "periods": [2, 3, 5, 7, 11],
        "period_discriminator_params": {
            "in_channels": 1, "out_channels": 1, "kernel_sizes": [5, 3],
            "channels": 32, "downsample_scales": [3, 3, 3, 3, 1],
            "max_downsample_channels": 1024, "bias": True,
            "nonlinear_activation": "LeakyReLU",
            "nonlinear_activation_params": {"negative_slope": 0.1},
            "use_weight_norm": True, "use_spectral_norm": False}},
    use_stft_loss=False, use_mel_loss=True,
    mel_loss_params={"fs": 16000, "fft_size": 1024, "hop_size": 256,
                     "win_length": None, "window": "hann", "num_mels": 80,
                     "fmin": 0, "fmax": 11025, "log_base": None},
    generator_adv_loss_params={"average_by_discriminators": False},
    discriminator_adv_loss_params={"average_by_discriminators": False},
    use_feat_match_loss=True,
    feat_match_loss_params={"average_by_discriminators": False,
                            "average_by_layers": False,
                            "include_final_outputs": False},
    lambda_aux=45.0, lambda_adv=1.0, lambda_feat_match=2.0,
    **{f"{m}_{key}": value for m in ("generator", "discriminator")
       for key, value in (
           ("optimizer_type", "Adam"),
           ("optimizer_params", {"lr": 1e-4, "betas": [0.5, 0.9],
                                 "weight_decay": 0.0}),
           ("scheduler_type", "MultiStepLR"),
           ("scheduler_params", {"gamma": 0.5,
                                 "milestones": [40000, 80000, 120000,
                                                160000]}),
           ("grad_norm", -1))},
    generator_train_start_steps=1, discriminator_train_start_steps=0,
    train_max_steps=6, save_interval_steps=200000,
    eval_interval_steps=200000, log_interval_steps=100)
TRAIN_STEPS = TRAIN_CONFIG["train_max_steps"]
TRAIN_UTTS, TRAIN_SECONDS = 64, 3  # one batch of 64 an epoch
STEP_ROUNDS = 5
# kernel vs plain gradients, relative L2: pooled over each model's tensors,
# and per tensor (a tensor whose gradient cancels to a small fraction of
# its terms, as a scale discriminator's first layer, reads larger)
GRAD_TOL = (1e-3, 5e-2)
# (B, T, stride): the training path's three MSD scales, and the Pallas
# kernel's own shape
HEAD_SHAPES = [(64, 2512, 4), (64, 1257, 4), (64, 629, 4), (32, 8512, 2)]

# egs/mri/voc1/conf/mri2w_hifigan_car.yaml: 230 features (+128 AR) at
# 20 kHz / hop 240, channels 512, upsample (8, 5, 3, 2); 125-frame chunks
MRI_RECIPE = os.path.join(ROOT, "egs", "mri", "voc1", "conf",
                          "mri2w_hifigan_car.yaml")
MRI_UTTS, MRI_SECONDS = 16, 10
# its training run: the recipe's B 16 x 30,000 samples on 16 utterances of
# 3 s, MRI_TRAIN_STEPS steps; the head's three scales there (B, T, stride)
MRI_TRAIN_UTTS, MRI_TRAIN_SECONDS, MRI_TRAIN_STEPS = 16, 3, 3
MRI_HEAD_SHAPES = [(16, 30512, 4), (16, 15257, 4), (16, 7629, 4)]

# inversion (w2a): the reference recipe's BiGRU as benchmarks/
# inversion_bench.py builds it (2 x BiGRU 256, FC 128, BatchNorm, FC 12),
# B 16 x 10 s of 200 Hz features (MFCC hop 80 at 16 kHz), 13-d MFCCs and
# the 1024-d SSL width; its AR form (ar_input 512: a carry of 42 frames of
# 12, ar_hidden 64, ar_output 64) in 200-row chunks, one stream and 64 lanes
W2A_GP = {"hidden_size": 256, "out_channels": 12}
W2A_AR_GP = dict(W2A_GP, use_ar=True, ar_input=512, ar_hidden=64,
                 ar_output=64)
W2A_CONFIG = {"dataset_mode": "w2a", "batch_max_steps": 200, "hop_size": 80,
              "sampling_rate": 16000, "format": "npy",
              "generator_type": "BiGRU"}
W2A_FEATS = (13, 1024)
W2A_BATCH, W2A_SECONDS, W2A_LANES = 16, 10, 64
W2A_TAIL = 137  # rows past 10 s: the exact ragged tail of ar_loop_scan
W2A_F64_TOL = 1e-4  # f32 against float64, of max |y|
# streaming: the EMA HiFi-CAR above on STREAM_LANES lanes, the churn of
# benchmarks/streaming_bench.py (10 rounds at 1 stream, a ramp to 16 with a
# join a round, 10 rounds at 16, a drain to 4 with a leave a round, 10
# rounds at 4), and the AR BiGRU on the same schedule
STREAM_LANES = 16
# calls a backward shape is timed over, after one warm-up call
PAIR_BACKWARD_CALLS = 5


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, n: int) -> float:
    """Mean device time of ``fn`` over n calls after one warm-up call, by
    CUDA events."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fn()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_time_ms(fn, n: int) -> float:
    """Mean device time of ``fn`` over n calls captured in one CUDA graph
    and replayed, by CUDA events: the host's time per call (Python, the
    wrapper, the launch) is out of it. One warm-up call and one warm-up
    replay first."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def pair_times_ms(b, t, c, k, dtype) -> tuple[float, float, float]:
    """Least time for one pair by operations and by bytes (x in, y out,
    both kernels and biases once, over HBM bandwidth); the bound is the
    larger. Operations: bf16 flops over the bf16 tensor-core peak; f32
    three tf32 products a multiply-add over the TF32 peak. Third, the
    operations at the fp32 FMA rate (the f32 bound of PRs 1-3)."""
    flops = 4.0 * b * t * c * c * k
    size = torch.finfo(dtype).bits // 8
    nbytes = (2.0 * b * t * c + 2.0 * k * c * c + 2.0 * c) * size
    fma_ms = flops / PEAK_FLOPS[torch.float32] * 1e3
    ops_ms = (TF32_PRODUCTS * flops / PEAK_TF32 * 1e3
              if dtype == torch.float32 else flops / PEAK_FLOPS[dtype] * 1e3)
    return ops_ms, nbytes / PEAK_BYTES * 1e3, fma_ms


def pair_backward_bound_ms(b, t, c, k) -> float:
    """Least time for one f32 pair's gradients: the two data and two weight
    gradient convolutions (8 b t c^2 k flops, three tf32 products a
    multiply-add over the TF32 peak) or their bytes (x and gy in, dx out,
    both kernels in and their gradients and the biases' out), whichever is
    larger."""
    ops_ms = TF32_PRODUCTS * 8.0 * b * t * c * c * k / PEAK_TF32 * 1e3
    nbytes = (3.0 * b * t * c + 4.0 * k * c * c + 2.0 * c) * 4
    return max(ops_ms, nbytes / PEAK_BYTES * 1e3)


def phase_pair_backward(tag: str, seed: int, batch: int, frames: int,
                        gp: dict = GENERATOR_PARAMS) -> dict:
    """[<tag>] the f32 pair's backward kernels (``resblock_pair_backward``,
    every gradient) at each (stage, K, d) of ``gp`` at ``batch`` x
    ``frames``: device ms by CUDA events over PAIR_BACKWARD_CALLS calls,
    beside the bound and the backward by recomputation (the plain pair
    through cuDNN under autograd, then its gradient) timed the same way."""
    from articulatory_tpu_torch.ops._recompute import recompute_grads
    from articulatory_tpu_torch.ops.resblock_pair import (
        resblock_pair_backward,
        resblock_pair_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    scales, rows = gp["upsample_scales"], []
    for stage in range(len(scales)):
        c = gp["channels"] // 2 ** (stage + 1)
        t = frames * int(np.prod(scales[: stage + 1]))
        for k in gp["resblock_kernel_sizes"]:
            for d in gp["resblock_dilations"][0]:
                scale = (1.0 / (c * k)) ** 0.5
                x, gy = (torch.randn(batch, t, c, device="cuda", generator=gen)
                         for _ in range(2))
                w1, w2 = (torch.randn(k, c, c, device="cuda", generator=gen)
                          * scale for _ in range(2))
                b1, b2 = (0.1 * torch.randn(c, device="cuda", generator=gen)
                          for _ in range(2))
                saved = (x, w1, b1, w2, b2)
                kernel_ms = time_ms(lambda: resblock_pair_backward(
                    *saved, gy, dilation=d), PAIR_BACKWARD_CALLS)
                plain_ms = time_ms(lambda: recompute_grads(
                    resblock_pair_plain, saved, (True,) * 5, gy, dilation=d,
                    negative_slope=0.1), PAIR_BACKWARD_CALLS)
                rows.append({"stage": stage, "B": batch, "T": t, "C": c,
                             "K": k, "d": d, "kernel_ms": kernel_ms,
                             "plain_ms": plain_ms,
                             "bound_ms": pair_backward_bound_ms(batch, t, c,
                                                                k)})
    sums = {key: sum(r[key] for r in rows)
            for key in ("kernel_ms", "plain_ms", "bound_ms")}
    for stage in sorted({r["stage"] for r in rows}):
        part = [r for r in rows if r["stage"] == stage]
        log(f"[{tag}]   stage {stage} (C {part[0]['C']}, T {part[0]['T']}): "
            f"kernel {sum(r['kernel_ms'] for r in part):.3f} ms, bound "
            f"{sum(r['bound_ms'] for r in part):.3f}, plain "
            f"{sum(r['plain_ms'] for r in part):.3f}")
    log(f"[{tag}] f32 pair backward, {len(rows)} shapes at B={batch}: kernel "
        f"{sums['kernel_ms']:.3f} ms, bound {sums['bound_ms']:.3f} ms (3xTF32, "
        f"operations; {100 * sums['bound_ms'] / sums['kernel_ms']:.1f} %), "
        f"plain recompute {sums['plain_ms']:.3f} ms")
    return {"shapes": rows, "totals": sums}


# the banded relative-position attention (ops/banded_attention.py) at the
# inversion cell's layer: B 32, 8 heads, L 2000 (10 s at 200 Hz), d 96,
# m 100, dropout 0.2 on the probabilities
BANDED_SHAPE, BANDED_P = (32, 8, 2000, 96, 100), 0.2
BANDED_TOL = 1e-5  # f32 kernels against float64, of each output's max
BANDED_CALLS = 10


def banded_bound_ms(b, h, length, d, m) -> float:
    """Least time of one banded attention's forward and backward: 18 b h d
    operations an in-band (query, key) pair (q k^T, q E^T and P V forward,
    their six gradient products backward), three tf32 products each over
    the TF32 peak; or the bytes (q, k, v, o in and their gradients out,
    the table and its gradient, the uint8 mask), whichever is larger."""
    pairs = sum(min(i + m - 1, length - 1) - max(i - m + 1, 0) + 1
                for i in range(length))
    ops_ms = TF32_PRODUCTS * 18.0 * b * h * pairs * d / PEAK_TF32 * 1e3
    nbytes = (8.0 * b * h * length * d * 4 + 2.0 * h * (2 * m - 1) * d * 4
              + b * h * length * (2 * m - 1))
    return max(ops_ms, nbytes / PEAK_BYTES * 1e3)


def phase_banded_attention(seed: int) -> dict:
    """[banded-attention] the banded attention's kernels at BANDED_SHAPE on
    the card: o and the gradients of q, k, v and the table against the
    plain version in float64 on the same card inputs and keep mask (each
    within BANDED_TOL of its largest magnitude), one forward and one
    backward launch counted, the same bits from a second call; then device
    ms by CUDA events over BANDED_CALLS calls of the forward and of forward
    and backward, beside the bound and the plain version in float32 (no
    PyTorch call computes this attention: SDPA takes no relative table)."""
    from articulatory_tpu_torch.ops.banded_attention import (
        banded_attention,
        banded_attention_backward,
        banded_attention_plain,
    )

    b, h, length, d, m = BANDED_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, length, d, device="cuda", generator=gen)
                   for _ in range(4))
    table = torch.randn(h, 2 * m - 1, d, device="cuda",
                        generator=gen) * d ** -0.5
    keep = torch.rand(b, h, length, 2 * m - 1, device="cuda",
                      generator=gen) >= BANDED_P

    def leaves(dtype):
        return [t.to(dtype).requires_grad_(True) for t in (q, k, v, table)]

    def grads(fn, args):
        o = fn(*args, keep, BANDED_P)
        return [o.detach(), *torch.autograd.grad(o, args, do.to(o.dtype))]

    before = banded_attention.launches, banded_attention_backward.launches
    got = grads(banded_attention, leaves(torch.float32))
    launches = (banded_attention.launches - before[0],
                banded_attention_backward.launches - before[1])
    again = grads(banded_attention, leaves(torch.float32))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    want = grads(banded_attention_plain, leaves(torch.float64))
    names = ("o", "dq", "dk", "dv", "dE")
    errs = {n: float((g.double() - w).abs().max() / w.abs().max())
            for n, g, w in zip(names, got, want)}
    del got, want
    if launches != (1, 1) or not same or max(errs.values()) > BANDED_TOL:
        raise AssertionError(f"[banded-attention] launches {launches} (want "
                             f"(1, 1)), bit-equal repeat {same}, errors "
                             f"against float64 {errs} (limit {BANDED_TOL})")
    args = leaves(torch.float32)
    with torch.no_grad():
        fwd_ms = time_ms(lambda: banded_attention(*args, keep, BANDED_P),
                         BANDED_CALLS)
    total_ms = time_ms(lambda: grads(banded_attention, args), BANDED_CALLS)
    plain_ms = time_ms(lambda: grads(banded_attention_plain, args), 3)
    bound = banded_bound_ms(b, h, length, d, m)
    # device ms of each kernel in one forward and backward
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        grads(banded_attention, args)
        torch.cuda.synchronize()
    kernels: dict = {}
    for e in prof.key_averages():
        name = re.search(r"banded_attn_\w+", e.key)
        if name:
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            kernels[name.group(0)] = kernels.get(name.group(0), 0.0) + us / 1e3
    log(f"[banded-attention] B {b}, H {h}, L {length}, d {d}, m {m}, dropout "
        f"{BANDED_P}, f32 (3xTF32): forward and backward {total_ms:.3f} ms "
        f"(forward {fwd_ms:.3f}), bound {bound:.3f} ms "
        f"({100 * bound / total_ms:.1f} %), plain {plain_ms:.3f} ms; against "
        f"float64 " + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
        + f" of max (limit {BANDED_TOL}); launches {launches}, a repeat "
        f"bit-equal; profiled ms a kernel: "
        + ", ".join(f"{n} {ms:.3f}" for n, ms in kernels.items()))
    return {"kernel_ms": total_ms, "forward_ms": fwd_ms, "bound_ms": bound,
            "plain_ms": plain_ms, "f64_rel_err": errs,
            "profiled_ms": kernels}


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    log(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    return smi, torch.cuda.get_device_name(0)


def phase_build(build) -> float:
    start = time.perf_counter()
    libs = build.build_all()
    seconds = time.perf_counter() - start
    log(f"[build] {sorted(libs)} in {seconds:.1f} s")
    for name in libs:
        advisories = {}  # ptxas's (Cxxxx) notes, counted by code
        for line in build.build_log(name).splitlines():
            line = line.strip()
            if line.startswith("ptxas info    : Used") or "spill" in line:
                log(f"[build]   {name}: {line}")
            elif "ptxas info    : (C" in line:
                code = line.split("(", 1)[1].split(")", 1)[0]
                advisories[code] = advisories.get(code, 0) + 1
        if advisories:
            log(f"[build]   {name}: ptxas advisories {advisories}")
    return seconds


def host_us_per_launch(kernel, requires_grad: bool, n: int = 2000) -> float:
    """Host time of one wrapper call that launches the kernel, at a shape
    so small that the card keeps up with the host: wall time of n calls over
    n. Under ``inference_mode`` with inputs made there (the decode's bare
    launch, its f32 weight split cached), or with inputs that require grad
    (through the ``autograd.Function``, the split made in every call)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    mode = (contextlib.nullcontext() if requires_grad
            else torch.inference_mode())
    with mode:
        x, w1, w2 = (torch.randn(shape, device="cuda", generator=gen
                                 ).requires_grad_(requires_grad)
                     for shape in ((1, 8, 32), (3, 32, 32), (3, 32, 32)))
        for _ in range(10):
            kernel(x, w1, None, w2, None, dilation=1)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(n):
            kernel(x, w1, None, w2, None, dilation=1)
        torch.cuda.synchronize()
    return (time.perf_counter() - start) / n * 1e6


def phase_kernel(resblock_pair, resblock_pair_plain, splits, seed: int,
                 batch: int, frames: int, gp: dict = GENERATOR_PARAMS
                 ) -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    scales = gp["upsample_scales"]
    rows = []
    for stage in range(len(scales)):
        c = gp["channels"] // 2 ** (stage + 1)
        t = frames * int(np.prod(scales[: stage + 1]))
        for k in gp["resblock_kernel_sizes"]:
            for d in gp["resblock_dilations"][0]:
                for dtype in (torch.float32, torch.bfloat16):
                    rows.append(_kernel_case(resblock_pair, resblock_pair_plain,
                                             splits, gen, batch, stage, t, c,
                                             k, d, dtype))
    return rows


def _kernel_case(kernel, plain, splits, gen, batch, stage, t, c, k, d,
                 dtype) -> dict:
    """One shape: the kernel against the plain pair at T and T + 37 (and
    in f32 both against the plain pair in float64, and the weight split
    kernel bit for bit against its plain version), then both timed. The
    f32 kernel's time includes its weight split (the inputs are no
    inference tensors, so nothing is cached: training's path); split_ms is
    the split alone, so kernel_ms - split_ms is the decode's cached path."""
    split, split_plain = splits
    def inputs(length):
        scale = (1.0 / (c * k)) ** 0.5
        x = torch.randn(batch, length, c, device="cuda", generator=gen)
        w1 = torch.randn(k, c, c, device="cuda", generator=gen) * scale
        w2 = torch.randn(k, c, c, device="cuda", generator=gen) * scale
        b1 = torch.randn(c, device="cuda", generator=gen) * 0.1
        b2 = torch.randn(c, device="cuda", generator=gen) * 0.1
        return [a.to(dtype) for a in (x, w1, b1, w2, b2)]

    rel_err = abs_err = f64_err = plain_f64_err = 0.0
    for length in (t, t + 37):  # the main path's T, and a ragged one
        args = inputs(length)
        y = kernel(*args, dilation=d)
        ref = plain(*args, dilation=d)
        torch.cuda.synchronize()
        if y.shape != ref.shape or not torch.isfinite(y).all():
            raise AssertionError(f"resblock_pair C{c} K{k} d{d} T{length} "
                                 f"{dtype}: bad output")
        diff = (y.float() - ref.float()).abs().max().item()
        abs_err = max(abs_err, diff)
        rel_err = max(rel_err, diff / ref.float().abs().max().item())
        if dtype == torch.float32:
            ref64 = plain(*(a.double() for a in args), dilation=d)
            scale = ref64.abs().max().item()
            f64_err = max(f64_err,
                          (y.double() - ref64).abs().max().item() / scale)
            plain_f64_err = max(plain_f64_err, (ref.double() - ref64).abs(
                ).max().item() / scale)
    if rel_err > KERNEL_TOL[dtype]:
        raise AssertionError(f"resblock_pair C{c} K{k} d{d} {dtype}: error "
                             f"{rel_err:.3e} of max |y| > {KERNEL_TOL[dtype]}")
    if f64_err > F64_TOL:
        raise AssertionError(f"resblock_pair C{c} K{k} d{d} {dtype}: error "
                             f"{f64_err:.3e} of max |y| against the float64 "
                             f"pair > {F64_TOL}")
    args = inputs(t)
    if dtype == torch.float32:
        for got, w in zip(split(args[1], args[3]), (args[1], args[3])):
            if not torch.equal(got, split_plain(w)):
                raise AssertionError(f"split_tf32 C{c} K{k}: differs from "
                                     f"split_tf32_plain")
    n = 10
    # in turns: plain, kernel, kernel, plain
    p1 = device_time_ms(lambda: plain(*args, dilation=d), n)
    k1 = device_time_ms(lambda: kernel(*args, dilation=d), n)
    k2 = device_time_ms(lambda: kernel(*args, dilation=d), n)
    p2 = device_time_ms(lambda: plain(*args, dilation=d), n)
    split_ms = (device_time_ms(lambda: split(args[1], args[3]), n)
                if dtype == torch.float32 else 0.0)
    ops_ms, bytes_ms, fma_ms = pair_times_ms(batch, t, c, k, dtype)
    return {"stage": stage, "B": batch, "T": t, "C": c, "K": k,
            "dilation": d, "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": abs_err, "max_rel_err": rel_err,
            "f64_rel_err": f64_err, "plain_f64_rel_err": plain_f64_err,
            "kernel_ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "split_ms": split_ms, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "fma_bound_ms": max(fma_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def kernel_sums(rows: list[dict]) -> dict:
    """Per dtype: kernel, plain and bound ms summed over the rows, and the
    largest errors."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        sel = [r for r in rows if r["dtype"] == dtype]
        out[dtype] = {key: sum(r[key] for r in sel) for key in
                      ("kernel_ms", "plain_ms", "split_ms", "bound_ms",
                       "fma_bound_ms", "ops_ms", "bytes_ms")}
        for key in ("max_abs_err", "max_rel_err", "f64_rel_err",
                    "plain_f64_rel_err"):
            out[dtype][key] = max(r[key] for r in sel)
    return out


def stage_sums(rows: list[dict]) -> dict:
    """Per dtype, per stage: kernel, plain and bound ms summed over the
    stage's 9 (K, d) shapes, and the kernel's share of the bound."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        out[dtype] = []
        for stage in sorted({r["stage"] for r in rows}):
            sel = [r for r in rows if r["dtype"] == dtype and r["stage"] == stage]
            sums = {key: sum(r[key] for r in sel) for key in
                    ("kernel_ms", "plain_ms", "split_ms", "bound_ms",
                     "fma_bound_ms")}
            out[dtype].append(dict(
                stage=stage, C=sel[0]["C"], T=sel[0]["T"], **sums,
                f64_rel_err=max(r["f64_rel_err"] for r in sel),
                plain_f64_rel_err=max(r["plain_f64_rel_err"] for r in sel),
                bound_share=sums["bound_ms"] / sums["kernel_ms"],
                bound_by=("operations" if sum(r["ops_ms"] for r in sel)
                          >= sum(r["bytes_ms"] for r in sel) else "bytes")))
    return out


def log_stage_sums(sums: dict, batch: int) -> None:
    for dtype, stages in sums.items():
        for st in stages:
            f32 = (f" (split {st['split_ms']:.4f} ms), FMA bound "
                   f"{st['fma_bound_ms']:.4f} ms; error against float64 "
                   f"{st['f64_rel_err']:.3e} (cuDNN f32 "
                   f"{st['plain_f64_rel_err']:.3e})"
                   if dtype == "float32" else "")
            log(f"[kernel]   {dtype} stage {st['stage']} (C {st['C']}, T "
                f"{st['T']}, B {batch}): kernel {st['kernel_ms']:.4f} ms, "
                f"plain {st['plain_ms']:.4f} ms, bound {st['bound_ms']:.4f} ms "
                f"({st['bound_by']}), {100 * st['bound_share']:.1f} % of "
                f"the bound{f32}")


def sum_line(dtype: str, sums: dict) -> str:
    """One dtype's sums over 36 shapes, as the [kernel] lines print them."""
    line = (f"kernel {sums['kernel_ms']:.3f} ms, plain {sums['plain_ms']:.3f} "
            f"ms, bound {sums['bound_ms']:.3f} ms, max rel err "
            f"{sums['max_rel_err']:.2e}")
    if dtype == "float32":
        line += (f"; weight split {sums['split_ms']:.3f} ms of it; FMA bound "
                 f"{sums['fma_bound_ms']:.3f} ms; max error against the "
                 f"float64 pair {sums['f64_rel_err']:.3e} of max |y| (limit "
                 f"{F64_TOL}), cuDNN f32's {sums['plain_f64_rel_err']:.3e}")
    return line


def head_times_ms(b, t, stride, dtype) -> tuple[float, float, float]:
    """Least time for one head call by operations (2*B*T*128*15 +
    2*B*T1*128*32*41 flops over the tensor cores' peak: bf16's, or in f32
    three tf32 products a multiply-add over the TF32 peak) and by bytes (x
    in, h0 and h1 out, weights and biases once, over HBM bandwidth); the
    bound is the larger. Third, the operations at the fp32 FMA rate (the
    f32 bound of PRs 2-4)."""
    t1 = (t - 1) // stride + 1
    flops = 2.0 * b * t * 128 * 15 + 2.0 * b * t1 * 128 * 32 * 41
    size = torch.finfo(dtype).bits // 8
    nbytes = (b * t + b * t * 128 + b * t1 * 128 + 15 * 128 + 41 * 32 * 128
              + 2 * 128) * size
    fma_ms = flops / PEAK_FLOPS[torch.float32] * 1e3
    ops_ms = (TF32_PRODUCTS * flops / PEAK_TF32 * 1e3
              if dtype == torch.float32 else flops / PEAK_FLOPS[dtype] * 1e3)
    return ops_ms, nbytes / PEAK_BYTES * 1e3, fma_ms


def phase_head_kernel(head, head_plain, splits, seed: int,
                      shapes=HEAD_SHAPES) -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [_head_case(head, head_plain, splits, gen, b, t, stride, dtype)
            for b, t, stride in shapes
            for dtype in (torch.float32, torch.bfloat16)]


def _head_case(kernel, plain, splits, gen, b, t, stride, dtype) -> dict:
    """One shape: the head against the plain head at T and T + 3 (in f32
    also against the plain head in float64), the weight split kernel bit
    for bit against its plain version, then the head, the plain head and
    the split timed. The head's time includes its weight split, as on the
    training path; split_ms is the split alone."""
    split, split_plain = splits

    def inputs(length):
        x = torch.randn(b, length, 1, device="cuda", generator=gen) * 0.3
        w0 = torch.randn(15, 1, 128, device="cuda", generator=gen) / 15 ** 0.5
        b0 = torch.randn(128, device="cuda", generator=gen) * 0.1
        wg = torch.randn(41, 32, 128, device="cuda", generator=gen) / (
            41 * 32) ** 0.5
        b1 = torch.randn(128, device="cuda", generator=gen) * 0.1
        return [a.to(dtype) for a in (x, w0, b0, wg, b1)]

    rel_err = abs_err = f64_err = plain_f64_err = 0.0
    for length in (t, t + 3):  # the path's T, and a ragged one
        args = inputs(length)
        outs = kernel(*args, stride=stride)
        refs = plain(*args, stride=stride)
        refs64 = (plain(*(a.double() for a in args), stride=stride)
                  if dtype == torch.float32 else refs)
        torch.cuda.synchronize()
        for out, ref, ref64 in zip(outs, refs, refs64):
            if out.shape != ref.shape or not torch.isfinite(out).all():
                raise AssertionError(f"scale_disc_head B{b} T{length} "
                                     f"s{stride} {dtype}: bad output")
            diff = (out.float() - ref.float()).abs().max().item()
            abs_err = max(abs_err, diff)
            rel_err = max(rel_err, diff / ref.float().abs().max().item())
            if dtype == torch.float32:
                scale = ref64.abs().max().item()
                f64_err = max(f64_err, (out.double() - ref64).abs().max(
                    ).item() / scale)
                plain_f64_err = max(plain_f64_err, (ref.double() - ref64).abs(
                    ).max().item() / scale)
    if rel_err > KERNEL_TOL[dtype]:
        raise AssertionError(f"scale_disc_head B{b} T{t} s{stride} {dtype}: "
                             f"error {rel_err:.3e} of max |h| > "
                             f"{KERNEL_TOL[dtype]}")
    if f64_err > F64_TOL:
        raise AssertionError(f"scale_disc_head B{b} T{t} s{stride} {dtype}: "
                             f"error {f64_err:.3e} of max |h| against the "
                             f"float64 head > {F64_TOL}")
    args = inputs(t)
    if not torch.equal(split(args[3]), split_plain(args[3])):
        raise AssertionError(f"split_weights {dtype}: differs from "
                             f"split_weights_plain")
    n = 10
    # in turns: plain, kernel, kernel, plain
    p1 = device_time_ms(lambda: plain(*args, stride=stride), n)
    k1 = device_time_ms(lambda: kernel(*args, stride=stride), n)
    k2 = device_time_ms(lambda: kernel(*args, stride=stride), n)
    p2 = device_time_ms(lambda: plain(*args, stride=stride), n)
    split_ms = device_time_ms(lambda: split(args[3]), n)
    ops_ms, bytes_ms, fma_ms = head_times_ms(b, t, stride, dtype)
    return {"B": b, "T": t, "stride": stride,
            "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": abs_err, "max_rel_err": rel_err,
            "f64_rel_err": f64_err, "plain_f64_rel_err": plain_f64_err,
            "kernel_ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "split_ms": split_ms, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "fma_bound_ms": max(fma_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def head_host_us_per_launch(head, requires_grad: bool, n: int = 2000) -> float:
    """Host time of one head call (the weight split's launch and the
    head's), at a shape so small that the card keeps up with the host: wall
    time of n calls over n, with inputs that do or do not require grad."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, w0, wg = (torch.randn(shape, device="cuda", generator=gen
                             ).requires_grad_(requires_grad)
                 for shape in ((1, 8, 1), (15, 1, 128), (41, 32, 128)))
    for _ in range(10):
        head(x, w0, None, wg, None, stride=4)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(n):
        head(x, w0, None, wg, None, stride=4)
    torch.cuda.synchronize()
    return (time.perf_counter() - start) / n * 1e6


@contextlib.contextmanager
def swapped(module, name: str, fn):
    """Run ``module.name`` as ``fn`` (a kernel's plain version) inside."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def phase_slice(port, seed: int, device_name: str, tmp: str) -> dict:
    inference, residual, resblock_pair, plain, split, weights, decode = (
        port[k] for k in ("inference", "residual", "resblock_pair", "plain",
                          "split", "weights", "decode"))
    gp = GENERATOR_PARAMS
    ckpt = os.path.join(tmp, "generator.pth")
    torch.save({"model": {"generator": weights.jax_params_to_state_dict(
        numpy_generator_params(gp, seed), gp)}}, ckpt)
    hop, chunk_len = CONFIG["hop_size"], CONFIG["batch_max_steps"]
    n_frames = int(SECONDS * CONFIG["sampling_rate"] / hop)
    n_chunks = -(-n_frames // CHUNK_FRAMES)
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((n_frames, N_FEATS)).astype(np.float32)
          for _ in range(UTTS)]
    modes = {"f32": CONFIG, "hybrid_bf16": dict(CONFIG, generator_params=dict(
        gp, compute_dtype="bfloat16", hybrid_precision=True))}
    models = {}
    split.launches = 0
    for mode, config in modes.items():
        models[mode] = inference.load_model(ckpt, config, device="cuda")
        models[mode].remove_weight_norm()
        inference.ar_loop_batched(models[mode], [x[:CHUNK_FRAMES] for x in xs],
                                  config)  # warm-up: cuDNN plans, allocator
    # the first chunk splits every f32 pair's weights once: 36 pairs in f32,
    # stage 3's 9 in hybrid; the split is cached on the frozen kernels
    warmup_splits = split.launches
    if warmup_splits != 36 + 9:
        raise AssertionError(f"decode warm-up: the f32 weight split ran "
                             f"{warmup_splits} times, expected {36 + 9}")

    results, wavs = {}, {}
    resblock_pair.launches = split.launches = 0
    for i, (mode, config) in enumerate(modes.items()):
        torch.cuda.synchronize()
        start = time.perf_counter()
        outs = inference.ar_loop_batched(models[mode], xs, config)
        seconds = time.perf_counter() - start
        launches = resblock_pair.launches
        expected = 36 * n_chunks * (i + 1)
        if launches != expected:
            raise AssertionError(f"{mode}: resblock_pair launched {launches} "
                                 f"times, expected {expected}")
        for out in outs:
            if out.shape != (n_frames * hop,) or not np.isfinite(out).all():
                raise AssertionError(f"{mode}: output {out.shape} not finite "
                                     f"or not ({n_frames * hop},)")
        wavs[mode] = outs
        results[mode] = {"seconds": seconds,
                         "samples_per_s": UTTS * n_frames * hop / seconds,
                         "chunks": n_chunks, "launches": launches - (
                             36 * n_chunks * i)}
    launches_total, split_launches = resblock_pair.launches, split.launches
    # the f32 pairs' weight splits were made in the warm-up, on the cached
    # (inference-tensor) kernels, and reused
    if split_launches:
        raise AssertionError(f"decode: the f32 weight split ran "
                             f"{split_launches} times, expected 0 (cached)")
    for mode, config in modes.items():
        results[mode].update(_chunk_checks(models[mode], xs, wavs[mode],
                                           residual, plain, mode, n_chunks,
                                           chunk_len))
        r = results[mode]
        spans = ", ".join(
            f"{name} {r[key]:.3f} ms [{r[key + '_range'][0]:.3f}, "
            f"{r[key + '_range'][1]:.3f}]" for name, key in (
                ("kernel", "chunk_ms"), ("plain pairs", "chunk_plain_ms"),
                ("no pairs", "chunk_without_pairs_ms")))
        log(f"[slice] {mode}: {UTTS} utts x {SECONDS} s, {n_chunks} chunks "
            f"in {r['seconds']:.3f} s = {r['samples_per_s']:.1f} samples/s on "
            f"{device_name}; resblock_pair launches {r['launches']}; chunk "
            f"max abs err vs plain {r['chunk_max_abs_err']:.3e} (tol "
            f"{CHUNK_TOL[mode]}); chunk forward, median [range] of {ROUNDS}: "
            f"{spans}")

    feats = torch.from_numpy(np.stack([x[:CHUNK_FRAMES] for x in xs])).cuda()
    prev = torch.from_numpy(np.stack(wavs["hybrid_bf16"]))[
        :, chunk_len - GENERATOR_PARAMS["ar_input"]:chunk_len, None].cuda()
    prof = profile_window(models["hybrid_bf16"], feats, prev)
    results["hybrid_bf16"]["profile"] = prof
    if prof["busy_share"] is None:
        log("[slice] profiler: no device activity recorded (not measured)")
    else:
        log(f"[slice] profiler, {PROFILE_CHUNKS} hybrid chunk forwards: "
            f"device busy {prof['busy_ms']:.3f} of {prof['span_ms']:.3f} ms "
            f"= {100 * prof['busy_share']:.1f} %; top device ops: "
            + "; ".join(f"{o['name'][:60]} x{o['calls']} {o['ms']:.3f} ms"
                        for o in prof["top_ops"]))

    results["graph"] = phase_graph(port, models, modes, xs, "graph",
                                   CHUNK_FRAMES, gp["ar_input"], device_name)
    results["weights"] = phase_weights(port, ckpt, xs, device_name)

    dump = os.path.join(tmp, "dump")
    os.makedirs(dump)
    for n in range(2):
        np.save(os.path.join(dump, f"utt{n}-feats.npy"), xs[n][:300])
    runs = {"out": {}, "out_scan_b1": {"ar_scan": True},
            "out_scan_b4": {"ar_scan": True, "decode_batch_size": 4},
            "out_int8": {"int8_weights": True}}
    for name, kwargs in runs.items():
        outdir = os.path.join(tmp, name)
        decode.decode(CONFIG, ckpt, outdir, dumpdir=dump, device="cuda",
                      **kwargs)
        for n in range(2):
            if not os.path.exists(os.path.join(outdir, f"utt{n}_gen.wav")):
                raise AssertionError(f"decode {kwargs} wrote no "
                                     f"utt{n}_gen.wav")
        log(f"[slice] decode {kwargs or 'eager'}: wrote utt0_gen.wav, "
            f"utt1_gen.wav")
    results["launches_total"] = launches_total
    results["split_launches"] = split_launches
    results["split_launches_warmup"] = warmup_splits
    return results


def run_turns(fns: dict, order) -> dict:
    """Wall time of each ``fns[key]()`` (ending in a host sync) taken in
    the given order of keys, after one untimed call of each: key -> list of
    seconds, and the last result."""
    for fn in fns.values():
        fn()
    times, results = {key: [] for key in fns}, {}
    for key in order:
        torch.cuda.synchronize()
        start = time.perf_counter()
        results[key] = fns[key]()
        torch.cuda.synchronize()
        times[key].append(time.perf_counter() - start)
    return times, results


def phase_graph(port, models, modes, xs, tag, chunk_frames, ar_input,
                device_name) -> dict:
    """The captured chunk loop (``ar_loop_batched(scan=True)``) beside the
    eager loop on the same frozen models: capture counts (the warm-up steps
    and the capture launch every pair; no weight split: the models' eager
    warm-up cached them), both timed in turns (eager, graph, graph, eager),
    outputs of the right length and finite, chunks 0, 1 and the last of the
    graph run against the eager forward from the graph run's own carry
    (within CHUNK_TOL; the whole outputs' max difference printed), one
    ``torch.profiler`` window over PROFILE_CHUNKS replays (pair kernels
    counted: 36 a replay; weight splits: 0; the device's busy share), and
    the single-stream real-time factor of ``ar_loop_scan`` against eager
    ``ar_loop`` on one utterance."""
    inference, residual, resblock_pair, split = (
        port["inference"], port["residual"], port["resblock_pair"],
        port["split"])
    results = {}
    for mode, config in modes.items():
        model = models[mode]
        hop, chunk_len = config["hop_size"], config["batch_max_steps"]
        n_frames = len(xs[0])
        n_chunks = -(-n_frames // chunk_frames)
        resblock_pair.launches = split.launches = 0
        inference.ar_loop_batched(model, xs, config, scan=True)  # capture
        capture = {"resblock_pair": resblock_pair.launches,
                   "split_tf32": split.launches}
        steps = port["warmup_steps"] + 1
        if capture != {"resblock_pair": 36 * steps, "split_tf32": 0}:
            raise AssertionError(f"[{tag}] {mode}: capture launched "
                                 f"{capture}, expected 36 x {steps} pairs "
                                 f"and no split")
        # run_turns calls each once untimed first: the capture emptied the
        # allocator's cache, which the eager loop refills
        times, outs = run_turns({
            "eager": lambda: inference.ar_loop_batched(model, xs, config),
            "graph": lambda: inference.ar_loop_batched(model, xs, config,
                                                       scan=True)},
            TURNS)
        if resblock_pair.launches != (capture["resblock_pair"]
                                      + (TURNS.count("eager") + 1) * 36
                                      * n_chunks):
            raise AssertionError(f"[{tag}] {mode}: the graph runs launched "
                                 f"pairs from Python")
        for out in outs["graph"]:
            if out.shape != (n_frames * hop,) or not np.isfinite(out).all():
                raise AssertionError(f"[{tag}] {mode}: graph output "
                                     f"{out.shape} not finite or not "
                                     f"({n_frames * hop},)")
        whole = max(float(np.abs(g - e).max())
                    for g, e in zip(outs["graph"], outs["eager"]))
        checks = _chunk_checks(model, xs, outs["graph"], residual, None, mode,
                               n_chunks, chunk_len, chunk_frames, ar_input,
                               pair=residual.resblock_pair, timings=False)
        graph = model.chunk_graph(len(xs), xs[0].shape[1],
                                  inference.chunking(config))
        feats = np.zeros((PROFILE_CHUNKS, len(xs), chunk_frames,
                          xs[0].shape[1]), np.float32)
        for i, x in enumerate(xs):
            lane = np.zeros((PROFILE_CHUNKS * chunk_frames, x.shape[1]),
                            np.float32)
            part = x[:len(lane)]
            lane[:len(part)] = part
            feats[:, i] = lane.reshape(PROFILE_CHUNKS, chunk_frames, -1)
        chunks = torch.from_numpy(feats).cuda()
        prof = profile_device(lambda: graph.run(chunks))
        counts = prof["kernel_counts"]
        if counts != {"resblock_pair_wgmma": 36 * PROFILE_CHUNKS,
                      "split_tf32_kernel": 0}:
            raise AssertionError(f"[{tag}] {mode}: the profiler counted "
                                 f"{counts} over {PROFILE_CHUNKS} replays, "
                                 f"expected {36 * PROFILE_CHUNKS} pairs and "
                                 f"no split")
        samples = len(xs) * n_frames * hop
        rate = {k: samples / float(np.median(v)) for k, v in times.items()}
        # the single stream: one utterance, graph (B 1) against eager
        one = xs[0]
        inference.ar_loop_scan(model, one, config)  # capture at B 1
        one_times, one_outs = run_turns({
            "eager": lambda: inference.ar_loop(model, one, config),
            "graph": lambda: inference.ar_loop_scan(model, one, config)},
            TURNS)
        audio_s = n_frames * hop / config["sampling_rate"]
        rtf = {k: float(np.median(v)) / audio_s for k, v in one_times.items()}
        # over whole chunks: a ragged last chunk is zero-padded in the graph
        # (the tiled AR features see the pad), short in ar_loop
        whole_len = n_frames // chunk_frames * chunk_len
        one_diff = float(np.abs(one_outs["graph"][:whole_len]
                                - one_outs["eager"][:whole_len]).max())
        if (one_outs["graph"].shape != (n_frames * hop,)
                or not np.isfinite(one_outs["graph"]).all()
                or one_diff > CHUNK_TOL[mode]):
            raise AssertionError(f"[{tag}] {mode}: ar_loop_scan gave "
                                 f"{one_outs['graph'].shape}, not finite or "
                                 f"{one_diff:.3e} from ar_loop > "
                                 f"{CHUNK_TOL[mode]}")
        results[mode] = {
            "capture_launches": capture, "seconds": times,
            "samples_per_s": rate, "whole_max_abs_diff": whole,
            "graph_vs_eager_chunk_max_abs_err": checks["chunk_max_abs_err"],
            "profile": prof, "single_stream_rtf": rtf,
            "single_stream_seconds": one_times,
            "single_stream_max_abs_diff": one_diff}
        busy = ("not measured" if prof["busy_share"] is None else
                f"{100 * prof['busy_share']:.1f} %")
        log(f"[{tag}] {mode}: {len(xs)} utts x {n_frames} frames, "
            f"{n_chunks} chunks: eager {rate['eager']:.1f}, graph "
            f"{rate['graph']:.1f} samples/s (medians of {len(TURNS) // 2}, in "
            f"turns) on "
            f"{device_name}; graph vs eager: chunk max abs err "
            f"{checks['chunk_max_abs_err']:.3e} (tol {CHUNK_TOL[mode]}), "
            f"whole output {whole:.3e}; profiler over {PROFILE_CHUNKS} "
            f"replays: {counts}, device busy {busy}; single stream "
            f"({audio_s:.1f} s): RTF eager {rtf['eager']:.6f}, graph "
            f"{rtf['graph']:.6f}, max abs diff over whole chunks "
            f"{one_diff:.3e}")
    return results


def phase_weights(port, ckpt, xs, device_name) -> dict:
    """int8 and bf16 weight storage (``quantize_int8``, ``to_bf16_weights``)
    through the captured chunk loop at full width, f32: the f32 pairs' weight
    splits made once each in the graph's warm-up (36) and never after,
    outputs of the right length and finite, chunks 0, 1 and the last against
    plain pairs on the same stored weights under the run's carry, and the
    throughput."""
    inference, residual, plain, split = (port["inference"], port["residual"],
                                         port["plain"], port["split"])
    hop, chunk_len = CONFIG["hop_size"], CONFIG["batch_max_steps"]
    n_frames = len(xs[0])
    n_chunks = -(-n_frames // CHUNK_FRAMES)
    results = {}
    for kind, store in (("int8", "quantize_int8"), ("bf16", "to_bf16_weights")):
        model = inference.load_model(ckpt, CONFIG, device="cuda")
        model.remove_weight_norm()
        getattr(model, store)()
        split.launches = 0
        inference.ar_loop_batched(model, xs, CONFIG, scan=True)  # capture
        warmup_splits = split.launches
        split.launches = 0
        times, outs = run_turns({"graph": lambda: inference.ar_loop_batched(
            model, xs, CONFIG, scan=True)}, ("graph", "graph"))
        if (warmup_splits, split.launches) != (36, 0):
            raise AssertionError(f"[weights] {kind}: weight splits "
                                 f"{warmup_splits} in the warm-up and "
                                 f"{split.launches} after, expected 36 and 0")
        for out in outs["graph"]:
            if out.shape != (n_frames * hop,) or not np.isfinite(out).all():
                raise AssertionError(f"[weights] {kind}: output {out.shape} "
                                     f"not finite or not ({n_frames * hop},)")
        checks = _chunk_checks(model, xs, outs["graph"], residual, plain,
                               "f32", n_chunks, chunk_len, timings=False)
        rate = len(xs) * n_frames * hop / float(np.median(times["graph"]))
        results[kind] = {"samples_per_s": rate, "seconds": times["graph"],
                         "split_launches_warmup": warmup_splits,
                         "split_launches": split.launches, **checks}
        log(f"[weights] {kind} weights, f32, graph loop: {len(xs)} utts x "
            f"{n_frames} frames at {rate:.1f} samples/s on {device_name}; "
            f"weight splits {warmup_splits} in the warm-up, "
            f"{split.launches} after; chunk max abs err vs plain pairs "
            f"{checks['chunk_max_abs_err']:.3e} (tol {CHUNK_TOL['f32']})")
    return results


def mri_config() -> dict:
    """``egs/mri/voc1/conf/mri2w_hifigan_car.yaml`` as it stands, but
    ``format: npy`` (the card's machine has no h5py)."""
    import yaml
    with open(MRI_RECIPE) as f:
        return dict(yaml.safe_load(f), format="npy")


def phase_mri(port, seed: int, device_name: str, tmp: str) -> dict:
    """The MRI recipe's decode at full width: MRI_UTTS x MRI_SECONDS s in f32
    and hybrid bf16, eager (launch counts, chunks against plain pairs,
    chunk forward timings) and through the captured loop (``phase_graph``),
    then a ``bin/decode.py --ar-scan`` decode of a 2-utterance dump in the
    recipe's dataset mode."""
    inference, residual, resblock_pair, plain, split, weights, decode = (
        port[k] for k in ("inference", "residual", "resblock_pair", "plain",
                          "split", "weights", "decode"))
    config = mri_config()
    gp = config["generator_params"]
    hop, chunk_len = config["hop_size"], config["batch_max_steps"]
    chunk_frames = chunk_len // hop
    n_feats = gp["in_channels"] - gp["ar_output"]
    ckpt = os.path.join(tmp, "mri_generator.pth")
    torch.save({"model": {"generator": weights.jax_params_to_state_dict(
        numpy_generator_params(gp, seed), gp)}}, ckpt)
    n_frames = int(MRI_SECONDS * config["sampling_rate"] / hop)
    n_chunks = -(-n_frames // chunk_frames)
    rng = np.random.default_rng(seed + 1)
    xs = [rng.standard_normal((n_frames, n_feats)).astype(np.float32)
          for _ in range(MRI_UTTS)]
    modes = {"f32": config, "hybrid_bf16": dict(config, generator_params=dict(
        gp, compute_dtype="bfloat16", hybrid_precision=True))}
    models = {}
    split.launches = 0
    for mode, cfg in modes.items():
        models[mode] = inference.load_model(ckpt, cfg, device="cuda")
        models[mode].remove_weight_norm()
        inference.ar_loop_batched(models[mode], [x[:chunk_frames] for x in xs],
                                  cfg)  # warm-up: the weight splits
    if split.launches != 36 + 9:
        raise AssertionError(f"[mri] warm-up: the f32 weight split ran "
                             f"{split.launches} times, expected {36 + 9}")
    results = {"chunks": n_chunks, "frames": n_frames, "launches_total": 0,
               "split_launches": 0}
    for mode, cfg in modes.items():
        resblock_pair.launches = split.launches = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        outs = inference.ar_loop_batched(models[mode], xs, cfg)
        seconds = time.perf_counter() - start
        results["launches_total"] += resblock_pair.launches
        results["split_launches"] += split.launches
        if (resblock_pair.launches, split.launches) != (36 * n_chunks, 0):
            raise AssertionError(f"[mri] {mode}: resblock_pair launched "
                                 f"{resblock_pair.launches} times, expected "
                                 f"{36 * n_chunks}; the weight split "
                                 f"{split.launches}, expected 0 (cached)")
        for out in outs:
            if out.shape != (n_frames * hop,) or not np.isfinite(out).all():
                raise AssertionError(f"[mri] {mode}: output {out.shape} not "
                                     f"finite or not ({n_frames * hop},)")
        r = {"seconds": seconds, "launches": 36 * n_chunks,
             "samples_per_s": MRI_UTTS * n_frames * hop / seconds,
             **_chunk_checks(models[mode], xs, outs, residual, plain, mode,
                             n_chunks, chunk_len, chunk_frames,
                             gp["ar_input"])}
        results[mode] = r
        log(f"[mri] {mode}: {MRI_UTTS} utts x {MRI_SECONDS} s ({n_frames} "
            f"frames of {n_feats}), {n_chunks} chunks of {chunk_frames} in "
            f"{seconds:.3f} s = {r['samples_per_s']:.1f} samples/s on "
            f"{device_name}; resblock_pair launches {r['launches']}; chunk "
            f"max abs err vs plain {r['chunk_max_abs_err']:.3e} (tol "
            f"{CHUNK_TOL[mode]}); chunk forward median: kernel "
            f"{r['chunk_ms']:.3f} ms, plain pairs {r['chunk_plain_ms']:.3f}, "
            f"no pairs {r['chunk_without_pairs_ms']:.3f}")
    results["graph"] = phase_graph(port, models, modes, xs, "mri-graph",
                                   chunk_frames, gp["ar_input"], device_name)
    dump, outdir = os.path.join(tmp, "mri_dump"), os.path.join(tmp, "mri_out")
    os.makedirs(dump)
    for n in range(2):
        np.save(os.path.join(dump, f"mri{n}-feats.npy"), xs[n][:300])
    decode.decode(config, ckpt, outdir, dumpdir=dump, ar_scan=True,
                  device="cuda")
    for n in range(2):
        if not os.path.exists(os.path.join(outdir, f"mri{n}_gen.wav")):
            raise AssertionError(f"[mri] decode wrote no mri{n}_gen.wav")
    log(f"[mri] decode --ar-scan in dataset_mode {config['dataset_mode']}: "
        f"wrote mri0_gen.wav, mri1_gen.wav")
    return results


def _chunk_checks(model, xs, outs, residual, plain, mode, n_chunks,
                  chunk_len, chunk_frames=CHUNK_FRAMES,
                  ar_input=GENERATOR_PARAMS["ar_input"], pair=None,
                  timings=True) -> dict:
    """Chunks 0, 1 and the last of the batched run, each against a forward
    with the plain pair (or ``pair``) from the run's own carry; and with
    ``timings`` one chunk forward's time with the kernel, with plain pairs
    and with every pair an identity (the time of the rest), taken in turns
    ROUNDS times: median and range. A ragged last chunk is zero-padded, as
    the batched run computed it."""
    feats = np.stack(xs)
    feats = torch.from_numpy(np.pad(feats, ((0, 0), (
        0, n_chunks * chunk_frames - feats.shape[1]), (0, 0)))).cuda()
    wav = torch.from_numpy(np.stack(outs))[:, :, None].cuda()
    worst = 0.0
    for ci in sorted({0, 1, n_chunks - 1}):
        cin = feats[:, ci * chunk_frames:(ci + 1) * chunk_frames]
        prev = (torch.zeros(len(xs), ar_input, 1, device="cuda") if ci == 0
                else wav[:, ci * chunk_len - ar_input: ci * chunk_len])
        with swapped(residual, "resblock_pair", pair or plain):
            ref = model(cin, ar=prev)
        got = wav[:, ci * chunk_len:(ci + 1) * chunk_len]
        err = (got - ref[:, :got.shape[1]]).abs().max().item()
        if not torch.isfinite(ref).all() or err > CHUNK_TOL[mode]:
            raise AssertionError(f"{mode} chunk {ci}: max abs error {err:.3e} "
                                 f"against the {'kernel' if pair else 'plain'}"
                                 f" pair > {CHUNK_TOL[mode]}")
        worst = max(worst, err)
    out = {"chunk_max_abs_err": worst}
    if not timings:
        return out
    cin = feats[:, :chunk_frames]
    prev = wav[:, chunk_len - ar_input:chunk_len]
    pairs = {"chunk_ms": residual.resblock_pair, "chunk_plain_ms": plain,
             "chunk_without_pairs_ms": lambda x, *args, **kwargs: x}
    times = {key: [] for key in pairs}
    for _ in range(ROUNDS):
        for key, pair_fn in pairs.items():
            with swapped(residual, "resblock_pair", pair_fn):
                times[key].append(time_ms(lambda: model(cin, ar=prev), 5))
    for key, values in times.items():
        out[key] = float(np.median(values))
        out[key + "_range"] = [min(values), max(values)]
    return out


def profile_window(model, cin, prev) -> dict:
    """One ``torch.profiler`` window over PROFILE_CHUNKS chunk forwards (see
    ``profile_device``)."""
    out = profile_device(lambda: [model(cin, ar=prev)
                                  for _ in range(PROFILE_CHUNKS)])
    return dict(out, chunks=PROFILE_CHUNKS)


def profile_device(fn, kernels=("resblock_pair_wgmma", "split_tf32_kernel")
                   ) -> dict:
    """One ``torch.profiler`` window over ``fn()``, after one call of it
    outside the window: the device's busy share (the union of its activity
    intervals over the span from the first start to the last end), its top
    ops by self device time, the count of device kernels whose names hold
    each of ``kernels``, and of all device ops. None where the profiler saw
    no device activity. The window opens with PROFILE_LEAD_S of idle host
    time: the profiler drops the device's records that it dates before the
    window's start, and now and then dates them some ms early (before the
    host launched them), so a window without the lead lost its leading
    kernels at random."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_LEAD_S)
        fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    counts = {k: sum(k in e.name for e in events) for k in kernels}
    if not events:
        return {"busy_share": None, "span_ms": None, "top_ops": [],
                "kernel_counts": counts, "device_ops": 0}
    busy, span = busy_span_us(events)
    return {"busy_share": busy / span, "span_ms": span / 1e3,
            "busy_ms": busy / 1e3, "kernel_counts": counts,
            "device_ops": len(events), "top_ops": top_ops(prof, 8)}


def device_events(prof) -> list:
    """A profiler window's device activity: kernels and copies, not the
    device-side copies of ``record_function`` ranges, which span the
    kernels launched inside them."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def busy_span_us(events) -> tuple[float, float]:
    """The union of device events' intervals, and the span from the first
    start to the last end (us)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy, lo = busy + hi - lo, start
        hi = max(hi, end)
    busy += hi - lo
    return busy, max(end for _, end in spans) - spans[0][0]


def top_ops(prof, n: int) -> list[dict]:
    """A profiler's n ops of most self device time (ranges of
    ``record_function`` left out)."""
    ops = sorted((e for e in prof.key_averages()
                  if e.self_device_time_total > 0
                  and not e.is_user_annotation),
                 key=lambda e: e.self_device_time_total, reverse=True)
    return [{"name": e.key[:120], "calls": e.count,
             "ms": e.self_device_time_total / 1e3} for e in ops[:n]]


def _write_corpus(root: str, seed: int, config: dict = TRAIN_CONFIG,
                  utts: int = TRAIN_UTTS, seconds: float = TRAIN_SECONDS,
                  n_feats: int = N_FEATS) -> None:
    """``dump/<set>/norm/<utt>-{wave,feats}.npy`` and ``data/<set>/feats.scp``
    under root: ``utts`` training and 8 dev utterances of ``seconds`` s,
    random waveforms and ``n_feats`` features at the config's frame rate,
    from ``seed``."""
    rng = np.random.default_rng(seed)
    hop = config["hop_size"]
    frames = int(seconds * config["sampling_rate"] // hop)
    for stage, n in (("tr", utts), ("dev", 8)):
        dump = os.path.join(root, "dump", stage, "norm")
        data = os.path.join(root, "data", stage)
        os.makedirs(dump)
        os.makedirs(data)
        lines = []
        for i in range(n):
            wave = 0.3 * rng.standard_normal(frames * hop)
            art = rng.standard_normal((frames, n_feats)).astype(np.float32)
            np.save(os.path.join(dump, f"u{i}-wave.npy"), wave.astype(np.float32))
            np.save(os.path.join(dump, f"u{i}-feats.npy"), art)
            np.save(os.path.join(data, f"u{i}.npy"), art)
            lines.append(f"u{i} {os.path.join(data, f'u{i}.npy')}\n")
        with open(os.path.join(data, "feats.scp"), "w") as f:
            f.writelines(lines)


def _grads(loss, params) -> list[torch.Tensor]:
    return list(torch.autograd.grad(loss, params))


def _bf16(params: dict) -> bool:
    return str(params.get("compute_dtype")) in ("bfloat16", "torch.bfloat16")


def expected_launches(config: dict, steps: int, remat_steps: int = 0
                      ) -> dict:
    """The kernels' launches in ``steps`` training steps of ``config``, per
    dtype (``str(torch dtype)``): every step runs the generator twice (the
    loss pass and the regeneration; a third time, its recompute, in
    ``remat_steps`` of them), each forward every stage's pairs (a pair per
    resblock kernel and dilation) in the stage's dtype (bf16 under
    ``compute_dtype: bfloat16``, but the last stage with
    ``hybrid_precision``), each f32 pair splitting its weights once; and
    the MSMPD's scale heads, a head a scale in each of the generator
    loss's fake pass, its feature-matching real pass and the
    discriminator's two passes, in the discriminator's dtype, each
    splitting its weights once. A Transformer generator runs neither: a
    banded attention a layer in each of its two forwards, and its backward
    once a step."""
    if config.get("generator_type") == "Transformer":
        layers = config["generator_params"].get("elayers", 6)
        return {"banded_attention": {str(torch.float32): 2 * steps * layers},
                "banded_attention_backward": steps * layers}
    gp, dp = config["generator_params"], config["discriminator_params"]
    pairs = sum(len(d) for d in gp["resblock_dilations"])
    stages = len(gp["upsample_scales"])
    forwards = 2 * steps + remat_steps
    pair_by = {}
    for i in range(stages):
        dtype = str(torch.bfloat16 if _bf16(gp) and not (
            gp.get("hybrid_precision") and i == stages - 1)
            else torch.float32)
        pair_by[dtype] = pair_by.get(dtype, 0) + pairs * forwards
    passes = 3 + bool(config.get("use_feat_match_loss", False))
    heads = dp.get("scales", 3) * passes * steps
    head_dtype = str(torch.bfloat16 if _bf16(dp) else torch.float32)
    return {"resblock_pair": pair_by,
            "scale_disc_head": {head_dtype: heads},
            "split_tf32": pair_by.get(str(torch.float32), 0),
            "split_weights": heads}


def reset_counts(port: dict) -> None:
    """Every kernel's launch counts to 0."""
    for key in ("resblock_pair", "scale_disc_head", "split_tf32",
                "split_weights"):
        port[key].launches = 0
    for key in ("resblock_pair", "scale_disc_head"):
        port[key].launches_by_dtype.clear()


def read_counts(port: dict) -> dict:
    """The kernels' launch counts in ``expected_launches``'s form."""
    return {"resblock_pair": dict(port["resblock_pair"].launches_by_dtype),
            "scale_disc_head": dict(
                port["scale_disc_head"].launches_by_dtype),
            "split_tf32": port["split_tf32"].launches,
            "split_weights": port["split_weights"].launches}


@contextlib.contextmanager
def computing_in(model, dtype):
    """Run every module of ``model`` with a ``compute_dtype`` in ``dtype``
    (None: the parameters' f32) inside."""
    saved = [(m, m.compute_dtype) for m in model.modules()
             if hasattr(m, "compute_dtype")]
    for m, _ in saved:
        m.compute_dtype = dtype
    try:
        yield
    finally:
        for m, value in saved:
            m.compute_dtype = value


def _grad_gaps(got, want) -> tuple[float, float]:
    """(pooled, worst per tensor) relative L2 gap of two gradient lists."""
    gaps = [(g - w).norm().item() for g, w in zip(got, want)]
    norms = [w.norm().item() for w in want]
    per = max(gap / norm for gap, norm in zip(gaps, norms) if norm > 0)
    return float(np.linalg.norm(gaps) / np.linalg.norm(norms)), per


def phase_train(port: dict, seed: int, tmp: str, config: dict = TRAIN_CONFIG,
                grads: bool = True, tag: str = "train",
                exp: str = "exp") -> dict:
    """``train(config)`` for its ``train_max_steps`` on the synthetic corpus
    the caller wrote under ``tmp`` (``_write_corpus``), the checks (a)-(e)
    of the module's docstring ((d), the gradients, with ``grads``, each
    generator tensor's gap kept apart; (e), the decode, not for a speaker-
    or phoneme-input model, which neither package decodes), and the step's
    time; logged under ``[tag]``, the run's files in ``tmp/<exp>``."""
    train_cli, gan, inference = port["train"], port["gan"], port["inference"]
    pair, head = port["resblock_pair"], port["scale_disc_head"]
    split, head_split = port["split_tf32"], port["split_weights"]
    steps = config["train_max_steps"]
    outdir = os.path.join(tmp, exp)
    reset_counts(port)
    start = time.perf_counter()
    trainer = train_cli.train(
        config, train_dumpdir=os.path.join(tmp, "dump/tr/norm"),
        dev_dumpdir=os.path.join(tmp, "dump/dev/norm"), outdir=outdir,
        data_root=os.path.join(tmp, "data"), seed=seed, device="cuda")
    torch.cuda.synchronize()
    run_seconds = time.perf_counter() - start
    launches = {"resblock_pair": pair.launches,
                "scale_disc_head": head.launches,
                "split_tf32": split.launches,
                "split_weights": head_split.launches}
    # (c) every step ran both generator forwards and all four discriminator
    # passes through the kernels, each in its dtype; the weights are
    # refolded every forward, so every f32 pair split its weights, and
    # every head its weights
    by_dtype = read_counts(port)
    expected = expected_launches(config, steps)
    if by_dtype != expected:
        raise AssertionError(f"{tag}: launches {by_dtype}, expected "
                             f"{expected}")
    # (a) the metrics summed over the run's steps
    losses = {k: float(v) / steps
              for k, v in trainer.total_train_loss.items()}
    if not losses or not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"{tag}: losses not finite: {losses}")
    # (b) the models built from the same seeds are the initial weights
    state = trainer.state
    for model, name, model_seed in (
            (state.generator, "generator", seed),
            (state.discriminator, "discriminator", seed + 1)):
        initial = port["build_model"](config[f"{name}_type"],
                                      config[f"{name}_params"],
                                      seed=model_seed).state_dict()
        still = [k for k, p in model.named_parameters()
                 if torch.equal(p.detach().cpu(), initial[k])]
        if still:
            raise AssertionError(f"{tag}: {name} parameters never moved: "
                                 f"{still[:5]}")
    log(f"[{tag}] {steps} steps at B {config['batch_size']} x "
        f"{config['batch_max_steps']} in {run_seconds:.3f} s (build and "
        f"warm-up included); launches {by_dtype}; mean losses "
        + ", ".join(f"{k.split('/')[-1]} {v:.4f}" for k, v in losses.items()))

    # (d) one batch's gradients, kernels against plain versions (with grads)
    criterion = gan.GANCriterion(trainer.config)
    batch = port["to_device"](next(iter(trainer.data_loader["train"])),
                              trainer.device)
    gen_params = list(state.generator.parameters())
    disc_params = list(state.discriminator.parameters())
    with torch.no_grad():
        fake = gan.generate(state.generator, batch)

    def both_grads():
        gen_loss, _ = gan.generator_loss(state, criterion, config, batch)
        dis_loss, _ = gan.discriminator_loss(state, criterion, config, batch,
                                             fake)
        return _grads(gen_loss, gen_params), _grads(dis_loss, disc_params)

    grad_gaps = {}
    if grads:
        kernel_grads = both_grads()
        with swapped(port["residual"], "resblock_pair",
                     port["resblock_pair_plain"]), \
                swapped(port["hifigan"], "scale_disc_head",
                        port["scale_disc_head_plain"]):
            plain_grads = both_grads()
        # in bf16 the kernels and cuDNN round at other points: a model's
        # pooled gap may reach twice the plain bf16 gradient's own distance
        # from the f32 one (through the kernels in f32)
        limits = {"generator": GRAD_TOL, "discriminator": GRAD_TOL}
        if _bf16(config["generator_params"]) or _bf16(
                config["discriminator_params"]):
            with computing_in(state.generator, None), \
                    computing_in(state.discriminator, None):
                f32_grads = both_grads()
            for name, plain, f32 in zip(("generator", "discriminator"),
                                        plain_grads, f32_grads):
                own = _grad_gaps(plain, f32)[0]
                limits[name] = (max(GRAD_TOL[0], 2 * own), None)
                grad_gaps[f"{name}_plain_bf16_vs_f32"] = own
        for name, got, want in zip(("generator", "discriminator"),
                                   kernel_grads, plain_grads):
            pooled, per = _grad_gaps(got, want)
            grad_gaps[name] = {"pooled_rel_l2": pooled,
                               "worst_tensor_rel_l2": per,
                               "limits": limits[name]}
            pooled_limit, per_limit = limits[name]
            if pooled > pooled_limit or (per_limit is not None
                                         and per > per_limit):
                raise AssertionError(
                    f"{tag}: {name} gradients with the kernels differ from "
                    f"plain by {pooled:.3e} pooled, {per:.3e} worst tensor "
                    f"> {limits[name]}")
        log(f"[{tag}] kernel vs plain gradients, relative L2 pooled / worst "
            f"tensor: " + ", ".join(
                f"{k} {grad_gaps[k]['pooled_rel_l2']:.3e} / "
                f"{grad_gaps[k]['worst_tensor_rel_l2']:.3e} (limits "
                f"{grad_gaps[k]['limits']})"
                for k in ("generator", "discriminator"))
            + "".join(f"; plain bf16 vs f32 {k}: "
                      f"{grad_gaps[f'{k}_plain_bf16_vs_f32']:.3e}"
                      for k in ("generator", "discriminator")
                      if f"{k}_plain_bf16_vs_f32" in grad_gaps))
        names = [k for k, _ in state.generator.named_parameters()]
        grad_gaps["generator_tensors"] = {
            key: _grad_gaps([got], [want])[0] for key, got, want in zip(
                names, kernel_grads[0], plain_grads[0])}

    # step time, and its parts apart
    lr = config["generator_optimizer_params"]["lr"]
    step_s = []
    for _ in range(STEP_ROUNDS):
        torch.cuda.synchronize()
        start = time.perf_counter()
        trainer.train_step(state, batch, lr, lr)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - start)
    parts = {
        "generator_fwd_bwd_ms": lambda: _grads(gan.generator_loss(
            state, criterion, config, batch)[0], gen_params),
        "regeneration_ms": lambda: gan.generate(state.generator, batch),
        "discriminator_fwd_bwd_ms": lambda: _grads(gan.discriminator_loss(
            state, criterion, config, batch, fake)[0], disc_params)}
    part_ms = {}
    for key, fn in parts.items():
        with torch.set_grad_enabled(key != "regeneration_ms"):
            part_ms[key] = time_ms(fn, 3)
    log(f"[{tag}] step median {1e3 * float(np.median(step_s)):.3f} ms [range "
        f"{1e3 * min(step_s):.3f}, {1e3 * max(step_s):.3f}] over "
        f"{STEP_ROUNDS}; " + ", ".join(f"{k} {v:.3f}" for k, v in
                                      part_ms.items()))

    result = {"run_seconds": run_seconds, "launches": launches,
              "launches_by_dtype": by_dtype,
              "launches_per_step": {k: v // steps
                                    for k, v in launches.items()},
              "mean_losses": losses, "grad_gaps": grad_gaps,
              "step_ms_median": 1e3 * float(np.median(step_s)),
              "step_ms_range": [1e3 * min(step_s), 1e3 * max(step_s)],
              **part_ms}
    gp = config["generator_params"]
    if gp.get("use_spk_id") or gp.get("use_ph"):
        return result
    # (e) decode one chunk from the written checkpoint
    ckpt = os.path.join(outdir, f"checkpoint-{steps}steps.ckpt")
    model = inference.load_model(ckpt, config, device="cuda")
    chunk = config["batch_max_steps"] // config["hop_size"]
    feats = [np.load(os.path.join(tmp, "data", "dev", f"u{i}.npy"))[:chunk]
             for i in range(4)]
    outs = inference.ar_loop_batched(model, feats, config)
    for out in outs:
        if out.shape != (config["batch_max_steps"],) or not np.isfinite(
                out).all():
            raise AssertionError(f"{tag}: decode from {ckpt} gave "
                                 f"{out.shape}, not finite or not "
                                 f"({config['batch_max_steps']},)")
    log(f"[{tag}] decoded one chunk of 4 utterances from "
        f"{os.path.basename(ckpt)}")
    return result


# [hybrid-train]: the JAX package's default training precision
# (benchmarks/train_bench.py: --gen-hybrid on, --disc-bf16) on the EMA
# HiFi-CAR at full width and TRAIN_CONFIG's B 64 x 2000; 3 steps through
# train(), then the f32, hybrid and hybrid + bf16-discriminator steps in
# turns on one batch
HYBRID_GP = dict(GENERATOR_PARAMS, compute_dtype="bfloat16",
                 hybrid_precision=True)
HYBRID_TRAIN_CONFIG = dict(TRAIN_CONFIG, generator_params=HYBRID_GP,
                           train_max_steps=3)
# m2w: the same HiFi-CAR on 80 mel channels (+ 128 AR features)
M2W_MELS = 80
M2W_CONFIG = dict(TRAIN_CONFIG, dataset_mode="m2w", generator_params=dict(
    GENERATOR_PARAMS, in_channels=M2W_MELS + GENERATOR_PARAMS["ar_output"]))


def _disc_bf16(config: dict) -> dict:
    return dict(config, discriminator_params=dict(
        config["discriminator_params"], compute_dtype="bfloat16"))


def _train_state(port: dict, config: dict, seed: int, steps: int = 2):
    """Fresh models of ``config`` from ``seed`` on the card with Adam, at
    ``steps`` (2: both models update)."""
    build, optimizer = port["build_model"], port["build_optimizer"]
    models = [build(config[f"{m}_type"], config[f"{m}_params"],
                    seed=seed + i).cuda()
              for i, m in enumerate(("generator", "discriminator"))]
    opts = [optimizer("Adam", {"lr": 1e-4, "betas": [0.5, 0.9]}, -1,
                      m.parameters()) for m in models]
    return port["gan"].GANTrainState(generator=models[0],
                                     discriminator=models[1], opt_g=opts[0],
                                     opt_d=opts[1], steps=steps)


def _counted_step(port: dict, config: dict, state, batch, tag: str,
                  remat_steps: int = 0) -> tuple[dict, float]:
    """One ``make_train_step`` step of ``config`` with the counts set to 0
    just before and read just after, held to ``expected_launches``;
    returns the metrics and the step's ms."""
    step = port["gan"].make_train_step(port["gan"].GANCriterion(config),
                                       config)
    torch.cuda.synchronize()
    reset_counts(port)
    start = time.perf_counter()
    metrics = step(state, batch, 1e-4, 1e-4)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - start)
    counts = read_counts(port)
    expected = expected_launches(config, 1, remat_steps)
    metrics = {k: float(v) for k, v in metrics.items()}
    if counts != expected or not all(np.isfinite(v)
                                     for v in metrics.values()):
        raise AssertionError(f"[hybrid-train] {tag}: launches {counts}, "
                             f"expected {expected}; losses {metrics}")
    return {"launches": counts, "losses": metrics, "ms": ms}, ms


def _config_batch(port: dict, config: dict, tmp: str) -> dict:
    """The first training batch of the corpus under ``tmp`` as ``train()``
    collates it for ``config``, on the card."""
    train_set, _, collater, _ = port["train"].build_datasets(
        config, os.path.join(tmp, "dump/tr/norm"),
        os.path.join(tmp, "dump/dev/norm"), os.path.join(tmp, "data"))
    items = [train_set[i] for i in range(config["batch_size"])]
    return port["to_device"](collater(items), torch.device("cuda"))


def phase_hybrid_train(port: dict, seed: int, tmp: str) -> dict:
    """[hybrid-train] the hybrid generator (bf16 stages 0-2: 27 bf16 pairs a
    forward, the last stage's 9 in f32) through ``train()`` with phase_train's
    checks (launches per dtype from ``expected_launches``: 54 bf16 and 18
    f32 pairs and 18 weight splits a step; the gradients, kernels against
    both plain versions, within twice the plain bf16 gradient's distance
    from the f32 one); then on one batch the f32, hybrid and hybrid +
    bf16-discriminator steps, STEP_ROUNDS each in turns after a counted
    warm-up step of each (the bf16 heads: 12 a step), with their parts; one
    profiled hybrid step split as [recipe]'s; one ``use_remat`` step (a
    third generator forward: 81 bf16 and 27 f32 pairs); and one m2w step
    (80 mels, the collater's m2w windows: 72 f32 pairs)."""
    gan = port["gan"]
    out = phase_train(port, seed, tmp, config=HYBRID_TRAIN_CONFIG,
                      tag="hybrid-train", exp="exp-hybrid")
    batch = _config_batch(port, TRAIN_CONFIG, tmp)
    configs = {"f32": TRAIN_CONFIG, "hybrid": HYBRID_TRAIN_CONFIG,
               "hybrid_disc_bf16": _disc_bf16(HYBRID_TRAIN_CONFIG)}
    states = {k: _train_state(port, c, seed) for k, c in configs.items()}
    steps = {k: gan.make_train_step(gan.GANCriterion(c), c)
             for k, c in configs.items()}
    counted = {k: _counted_step(port, c, states[k], batch, k)[0]
               for k, c in configs.items()}
    step_s = {k: [] for k in configs}
    for _ in range(STEP_ROUNDS):
        for k in configs:
            torch.cuda.synchronize()
            start = time.perf_counter()
            steps[k](states[k], batch, 1e-4, 1e-4)
            torch.cuda.synchronize()
            step_s[k].append(time.perf_counter() - start)
    turns = {}
    for k, config in configs.items():
        state, criterion = states[k], gan.GANCriterion(config)
        gen_params = list(state.generator.parameters())
        disc_params = list(state.discriminator.parameters())
        with torch.no_grad():
            fake = gan.generate(state.generator, batch)
        parts = {
            "generator_fwd_bwd_ms": lambda: _grads(gan.generator_loss(
                state, criterion, config, batch)[0], gen_params),
            "regeneration_ms": lambda: gan.generate(state.generator, batch),
            "discriminator_fwd_bwd_ms": lambda: _grads(
                gan.discriminator_loss(state, criterion, config, batch,
                                       fake)[0], disc_params)}
        turns[k] = {"step_ms_median": 1e3 * float(np.median(step_s[k])),
                    "step_ms_range": [1e3 * min(step_s[k]),
                                      1e3 * max(step_s[k])],
                    "counted_step": counted[k]}
        for key, fn in parts.items():
            with torch.set_grad_enabled(key != "regeneration_ms"):
                turns[k][key] = time_ms(fn, 3)
        log(f"[hybrid-train] {k}: step median "
            f"{turns[k]['step_ms_median']:.3f} ms [range "
            f"{turns[k]['step_ms_range'][0]:.3f}, "
            f"{turns[k]['step_ms_range'][1]:.3f}] over {STEP_ROUNDS} in "
            f"turns; " + ", ".join(f"{key} {turns[k][key]:.3f}"
                                   for key in parts)
            + f"; launches a step {counted[k]['launches']}")

    # one profiled hybrid step, split as [recipe]'s
    from torch.profiler import ProfilerActivity, profile

    steps["hybrid"](states["hybrid"], batch, 1e-4, 1e-4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_LEAD_S)
        steps["hybrid"](states["hybrid"], batch, 1e-4, 1e-4)
        torch.cuda.synchronize()
    profiled = _device_split(prof)
    # the last stage's 9 f32 pairs differentiate on the backward kernels
    # (a split, data and weight gradients and reductions each), the 27 bf16
    # pairs by recomputation; the HiFi-CAR step runs no banded attention
    want = {"resblock_pair_wgmma": 72, "split_tf32_kernel": 18,
            "scale_disc_head_wgmma": 12, "split_weights_kernel": 12,
            "pair_bwd_split_kernel": 9, "pair_bwd_hidden_kernel": 9,
            "pair_bwd_input_kernel": 9, "pair_bwd_weight_kernel": 18,
            "pair_bwd_reduce_kernel": 18, "banded_attn_": 0}
    ranges = {k: n for k, (n, _) in profiled["recompute"].items()}
    if profiled["kernel_counts"] != want or ranges != {
            "resblock_pair_plain": 27, "scale_disc_head_plain": 9}:
        raise AssertionError(f"[hybrid-train] profiled step: kernels "
                             f"{profiled['kernel_counts']}, recompute "
                             f"ranges {ranges}")
    split = profiled["split_ms"]
    log(f"[hybrid-train] profiled hybrid step: busy "
        f"{profiled['busy_ms']:.3f} ms of a {profiled['span_ms']:.3f} ms "
        f"span ({100 * profiled['busy_share']:.1f} %); kernels "
        f"{profiled['kernel_ms']:.3f} ms: pair kernels {split['pair']:.3f}, "
        f"pair backward kernels {split['pair_backward']:.3f}, "
        f"head kernels {split['head']:.3f}, convolutions "
        f"{split['conv']:.3f}, rest {split['rest']:.3f}; under the "
        f"recompute ranges: " + ", ".join(
            f"{k} {n} x, {ms:.3f} ms"
            for k, (n, ms) in profiled["recompute"].items())
        + f"; kernel counts {profiled['kernel_counts']}")

    # use_remat: the generator's forward recomputed in the backward
    remat_config = dict(HYBRID_TRAIN_CONFIG, use_remat=True)
    remat, _ = _counted_step(port, remat_config,
                             _train_state(port, remat_config, seed), batch,
                             "remat", remat_steps=1)
    log(f"[hybrid-train] use_remat hybrid step: {remat['ms']:.3f} ms (first "
        f"step of its models), launches {remat['launches']}")

    # m2w: mel windows from the collater, x = (mel,)
    rng = np.random.default_rng(seed + 6)
    hop = M2W_CONFIG["hop_size"]
    frames = TRAIN_SECONDS * M2W_CONFIG["sampling_rate"] // hop
    items = [{"audio": (0.3 * rng.standard_normal(frames * hop)).astype(
                  np.float32),
              "art": rng.standard_normal((frames, N_FEATS)).astype(
                  np.float32),
              "mel": rng.standard_normal((frames, M2W_MELS)).astype(
                  np.float32)} for _ in range(M2W_CONFIG["batch_size"])]
    m2w_batch = port["collate"].SpeechCollater(
        M2W_CONFIG["batch_max_steps"], hop, dataset_mode="m2w",
        config=M2W_CONFIG, rng=np.random.default_rng(seed))(items)
    x_shape = m2w_batch["x"][0].shape
    if x_shape != (len(items), M2W_CONFIG["batch_max_steps"] // hop,
                   M2W_MELS):
        raise AssertionError(f"[hybrid-train] m2w x {x_shape}")
    m2w, _ = _counted_step(port, M2W_CONFIG,
                           _train_state(port, M2W_CONFIG, seed),
                           port["to_device"](m2w_batch,
                                             torch.device("cuda")), "m2w")
    log(f"[hybrid-train] m2w step (x {tuple(x_shape)}): {m2w['ms']:.3f} ms "
        f"(first step of its models), launches {m2w['launches']}, mel loss "
        f"{m2w['losses']['train/mel_loss']:.4f}")
    return dict(out, turns=turns, profiled_step=profiled, remat_step=remat,
                m2w_step=m2w)


def numpy_bigru_params(gp: dict, seed: int) -> tuple[dict, dict]:
    """A BiGRU param tree and its BatchNorm statistics in the JAX package's
    layout: GRU weights U(+-1/sqrt(H)), dense U(+-1/sqrt(fan_in)) as
    torch's defaults, random BatchNorm affine and statistics."""
    rng = np.random.default_rng(seed)

    def uniform(shape, bound):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    def gru(c_in, h):
        b = h ** -0.5
        return {"w_ih": uniform((3 * h, c_in), b),
                "w_hh": uniform((3 * h, h), b),
                "b_ih": uniform((3 * h,), b), "b_hh": uniform((3 * h,), b)}

    def dense(c_in, c_out):
        return {"w": uniform((c_in, c_out), c_in ** -0.5),
                "b": uniform((c_out,), c_in ** -0.5)}

    h, out = gp["hidden_size"], gp["out_channels"]
    tree = {"gru1": {d: gru(gp["in_channels"], h) for d in ("fwd", "bwd")},
            "gru2": {d: gru(2 * h, h) for d in ("fwd", "bwd")},
            "fc1": dense(2 * h, 128), "fc2": dense(128, out),
            "bn": {"scale": rng.uniform(0.5, 1.5, 128).astype(np.float32),
                   "bias": uniform((128,), 0.1)}}
    if gp.get("use_ar"):
        dims = ([gp["ar_input"] // out * out] + [gp["ar_hidden"]] * 4
                + [gp["ar_output"]])
        tree["ar_model"] = {f"fc{i}": dense(dims[i], dims[i + 1])
                            for i in range(5)}
    stats = {"mean": uniform((128,), 0.3),
             "var": rng.uniform(0.5, 2.0, 128).astype(np.float32)}
    return tree, {"batch_stats": {"bn": stats}}


def bigru_checkpoint(port, gp: dict, seed: int, path: str) -> str:
    """A reference-layout torch pickle of a random BiGRU (through
    ``jax_bigru_to_state_dict``)."""
    params, mutables = numpy_bigru_params(gp, seed)
    torch.save({"model": {"generator": port["weights"].jax_bigru_to_state_dict(
        params, mutables, gp)}}, path)
    return path


def phase_w2a(port, seed: int, device_name: str, tmp: str) -> dict:
    """[w2a] The full-utterance BiGRU at B W2A_BATCH x W2A_SECONDS s, 13-d
    and 1024-d: samples/s of input audio (median of ROUNDS forwards), and
    the f32 output against the same module in float64 on the card."""
    inference = port["inference"]
    frame_rate = W2A_CONFIG["sampling_rate"] // W2A_CONFIG["hop_size"]
    frames = W2A_SECONDS * frame_rate
    rng = np.random.default_rng(seed + 2)
    results = {}
    for feats in W2A_FEATS:
        gp = dict(W2A_GP, in_channels=feats)
        config = dict(W2A_CONFIG, generator_params=gp)
        model = inference.load_model(bigru_checkpoint(
            port, gp, seed, os.path.join(tmp, f"w2a_{feats}.pth")), config,
            device="cuda")
        x = torch.from_numpy(rng.standard_normal(
            (W2A_BATCH, frames, feats)).astype(np.float32)).cuda()
        times = []
        for _ in range(ROUNDS + 1):  # the first untimed
            torch.cuda.synchronize()
            start = time.perf_counter()
            y = model(x)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
        seconds = float(np.median(times[1:]))
        with torch.inference_mode():
            y64 = copy.deepcopy(model.model).double()(x.double())
        err = ((y.double() - y64).abs().max() / y64.abs().max()).item()
        if (y.shape != (W2A_BATCH, frames, 12) or not torch.isfinite(y).all()
                or err > W2A_F64_TOL):
            raise AssertionError(f"[w2a] {feats}-d: output {tuple(y.shape)}, "
                                 f"not finite or {err:.3e} from float64 > "
                                 f"{W2A_F64_TOL} of max |y|")
        rate = W2A_BATCH * W2A_SECONDS * W2A_CONFIG["sampling_rate"] / seconds
        prof = profile_device(lambda: model(x))
        results[feats] = {"seconds": times[1:], "samples_per_s": rate,
                          "f64_rel_err": err, "profile": prof}
        busy = ("not measured" if prof["busy_share"] is None else
                f"{100 * prof['busy_share']:.1f} % of "
                f"{prof['span_ms']:.3f} ms")
        log(f"[w2a] BiGRU {feats}-d, B {W2A_BATCH} x {frames} frames: "
            f"{rate:.1f} samples/s (median of {ROUNDS} forwards, "
            f"{1e3 * seconds:.3f} ms) on {device_name}; f32 against float64 "
            f"{err:.3e} of max |y| (limit {W2A_F64_TOL}); profiler over one "
            f"forward: {prof['device_ops']} device ops, device busy {busy}")
    return results


def phase_w2a_ar(port, seed: int, device_name: str, tmp: str) -> dict:
    """[w2a-ar] The AR BiGRU (13-d MFCCs, 200-row chunks, a 42-frame
    carry): one 10 s stream through ``ar_loop_scan`` (graph) against
    ``ar_loop`` (eager) in turns, real-time factors and outputs bit-equal;
    one stream with a W2A_TAIL-row ragged tail (the exact tail forward)
    bit-equal to ``ar_loop``; W2A_LANES lanes of 10 s through
    ``ar_loop_batched`` eager and ``scan=True`` in turns, samples/s, chunks
    0, 1 and the last of the graph run against eager forwards from its
    carry (bit-equal), and a profiler window over PROFILE_CHUNKS replays."""
    inference = port["inference"]
    gp = dict(W2A_AR_GP, in_channels=13 + W2A_AR_GP["ar_output"])
    config = dict(W2A_CONFIG, generator_params=gp)
    ck = inference.chunking(config)
    model = inference.load_model(bigru_checkpoint(
        port, gp, seed, os.path.join(tmp, "w2a_ar.pth")), config,
        device="cuda")
    rows = W2A_SECONDS * config["sampling_rate"] // config["hop_size"]
    rng = np.random.default_rng(seed + 3)
    one = rng.standard_normal((rows, 13)).astype(np.float32)
    inference.ar_loop_scan(model, one, config)  # capture at B 1
    one_times, one_outs = run_turns({
        "eager": lambda: inference.ar_loop(model, one, config),
        "graph": lambda: inference.ar_loop_scan(model, one, config)}, TURNS)
    rtf = {k: float(np.median(v)) / W2A_SECONDS for k, v in one_times.items()}
    one_diff = float(np.abs(one_outs["graph"] - one_outs["eager"]).max())
    ragged = rng.standard_normal((rows + W2A_TAIL, 13)).astype(np.float32)
    tail = {k: fn(model, ragged, config) for k, fn in (
        ("graph", inference.ar_loop_scan), ("eager", inference.ar_loop))}
    tail_diff = float(np.abs(tail["graph"] - tail["eager"]).max())
    for name, out, n, diff in (("one stream", one_outs["graph"], rows,
                                one_diff),
                               ("ragged tail", tail["graph"],
                                rows + W2A_TAIL, tail_diff)):
        if out.shape != (n, 12) or not np.isfinite(out).all() or diff:
            raise AssertionError(f"[w2a-ar] {name}: ar_loop_scan gave "
                                 f"{out.shape}, not finite or {diff:.3e} "
                                 f"from ar_loop (expected bit-equal)")

    xs = [rng.standard_normal((rows, 13)).astype(np.float32)
          for _ in range(W2A_LANES)]
    inference.ar_loop_batched(model, xs, config, scan=True)  # capture
    times, outs = run_turns({
        "eager": lambda: inference.ar_loop_batched(model, xs, config),
        "graph": lambda: inference.ar_loop_batched(model, xs, config,
                                                   scan=True)}, TURNS)
    rate = {k: W2A_LANES * W2A_SECONDS * config["sampling_rate"]
            / float(np.median(v)) for k, v in times.items()}
    lanes_diff = max(float(np.abs(g - e).max())
                     for g, e in zip(outs["graph"], outs["eager"]))
    feats = torch.from_numpy(np.stack(xs)).cuda()
    wav = torch.from_numpy(np.stack(outs["graph"])).cuda()
    n_chunks = rows // ck.in_chunk_len
    chunk_err = 0.0
    for ci in sorted({0, 1, n_chunks - 1}):
        lo = ci * ck.in_chunk_len
        prev = (torch.zeros(W2A_LANES, ck.past_out_len, 12, device="cuda")
                if ci == 0 else wav[:, lo - ck.past_out_len:lo])
        ref = model(feats[:, lo:lo + ck.in_chunk_len], ar=prev)
        chunk_err = max(chunk_err, (wav[:, lo:lo + ck.in_chunk_len]
                                    - ref).abs().max().item())
    if lanes_diff or chunk_err or not all(
            o.shape == (rows, 12) and np.isfinite(o).all()
            for o in outs["graph"]):
        raise AssertionError(f"[w2a-ar] {W2A_LANES} lanes: graph against "
                             f"eager {lanes_diff:.3e}, chunks against eager "
                             f"forwards {chunk_err:.3e} (expected 0.0), or "
                             f"outputs not ({rows}, 12) and finite")
    graph = model.chunk_graph(W2A_LANES, 13, ck)
    replays = min(PROFILE_CHUNKS, n_chunks)
    chunks = feats[:, :replays * ck.in_chunk_len].reshape(
        W2A_LANES, replays, ck.in_chunk_len, 13).transpose(0, 1)
    prof = profile_device(lambda: graph.run(chunks))
    busy = ("not measured" if prof["busy_share"] is None else
            f"{100 * prof['busy_share']:.1f} % of {prof['span_ms']:.3f} ms")
    log(f"[w2a-ar] AR BiGRU 13-d on {device_name}: one {W2A_SECONDS} s "
        f"stream ({n_chunks} chunks of {ck.in_chunk_len}) RTF eager "
        f"{rtf['eager']:.6f}, graph {rtf['graph']:.6f} (medians of "
        f"{len(TURNS) // 2}, in turns), graph against eager {one_diff:.1e}; "
        f"+{W2A_TAIL}-row ragged tail against ar_loop {tail_diff:.1e}; "
        f"{W2A_LANES} lanes: eager {rate['eager']:.1f}, graph "
        f"{rate['graph']:.1f} samples/s, graph against eager {lanes_diff:.1e}"
        f", chunks against eager forwards {chunk_err:.1e}; profiler over "
        f"{replays} replays: device busy {busy}")
    return {"single_stream_rtf": rtf, "single_stream_seconds": one_times,
            "samples_per_s": rate, "seconds": times,
            "single_stream_max_abs_diff": one_diff,
            "ragged_tail_max_abs_diff": tail_diff,
            "lanes_max_abs_diff": lanes_diff,
            "chunk_max_abs_err": chunk_err, "profile": prof}


def _write_wavs(write_wav, root: str, lengths, rng) -> str:
    os.makedirs(root)
    for i, n in enumerate(lengths):
        write_wav(os.path.join(root, f"utt{i}.wav"),
                  0.3 * rng.standard_normal(n), 16000)
    return root


def phase_w2a_cli(port, seed: int, tmp: str) -> dict:
    """[w2a-cli] ``bin/decode.py`` in w2a mode on a wav.scp of synthetic
    waves with a raw-wave AR BiGRU (1 + 64 inputs, 4000-sample chunks):
    eager, ``--ar-scan`` and ``--decode-batch-size 4 --ar-scan``; then
    ``bin/predict_ema.py`` on a synthetic wav directory with the 13-d AR
    BiGRU, with and without ``--ar-scan --batch 4``. Each writes its .npy
    files, of the right shape and finite."""
    import yaml
    inference, decode, predict_ema = (port["inference"], port["decode"],
                                      port["predict_ema"])
    rng = np.random.default_rng(seed + 4)
    gp = dict(W2A_AR_GP, in_channels=1 + W2A_AR_GP["ar_output"])
    config = dict(W2A_CONFIG, generator_params=gp, batch_max_steps=4000)
    ckpt = bigru_checkpoint(port, gp, seed, os.path.join(tmp, "w2a_raw.pth"))
    lengths = (20000, 12800)
    wav_dir = _write_wavs(port["write_wav"], os.path.join(tmp, "wavs"),
                          lengths, rng)
    scp = os.path.join(tmp, "wav.scp")
    with open(scp, "w") as f:
        f.writelines(f"utt{i} {os.path.join(wav_dir, f'utt{i}.wav')}\n"
                     for i in range(len(lengths)))
    ck = inference.chunking(config)
    results = {}  # run -> the output shapes it wrote
    for name, kwargs in (("eager", {}), ("scan", {"ar_scan": True}),
                         ("scan_b4", {"ar_scan": True,
                                      "decode_batch_size": 4})):
        outdir = os.path.join(tmp, f"w2a_{name}")
        decode.decode(config, ckpt, outdir, feats_scp=scp, device="cuda",
                      **kwargs)
        results[f"decode_{name}"] = []
        for i, n in enumerate(lengths):
            out = np.load(os.path.join(outdir, f"utt{i}_gen.npy"))
            results[f"decode_{name}"].append(out.shape)
            if out.shape != (ck.kept_rows(n), 12) or not np.isfinite(
                    out).all():
                raise AssertionError(f"[w2a-cli] decode {name}: utt{i} "
                                     f"{out.shape}, not ({ck.kept_rows(n)}, "
                                     f"12) or not finite")
        log(f"[w2a-cli] decode w2a {kwargs or 'eager'}: wrote "
            f"utt0_gen.npy, utt1_gen.npy")
    # predict_ema: <exp>/config.yml + best_mel_ckpt.pkl, MFCC-13 features
    exp = os.path.join(tmp, "exp", "ema_w2a_mfcc")
    os.makedirs(exp)
    gp13 = dict(W2A_AR_GP, in_channels=13 + W2A_AR_GP["ar_output"])
    with open(os.path.join(exp, "config.yml"), "w") as f:
        yaml.safe_dump(dict(W2A_CONFIG, generator_params=gp13), f)
    bigru_checkpoint(port, gp13, seed, os.path.join(exp, "best_mel_ckpt.pkl"))
    ema_wavs = _write_wavs(port["write_wav"], os.path.join(tmp, "ema_wavs"),
                           (32000, 24080, 16000, 40000, 8000), rng)
    hop = predict_ema.hop_of(exp)
    ck = inference.chunking(dict(W2A_CONFIG, generator_params=gp13))
    for name, flags in (("loop", []), ("scan_b4", ["--ar-scan", "--batch",
                                                   "4"])):
        outdir = os.path.join(tmp, f"ema_{name}")
        predict_ema.main([exp, ema_wavs, outdir, *flags, "--device", "cuda"])
        results[f"predict_ema_{name}"] = []
        for i, n in enumerate((32000, 24080, 16000, 40000, 8000)):
            out = np.load(os.path.join(outdir, f"utt{i}.npy"))
            results[f"predict_ema_{name}"].append(out.shape)
            rows = ck.kept_rows(n // hop + 1)
            if out.shape != (rows, 12) or not np.isfinite(out).all():
                raise AssertionError(f"[w2a-cli] predict_ema {name}: utt{i} "
                                     f"{out.shape}, not ({rows}, 12) or not "
                                     f"finite")
        log(f"[w2a-cli] predict_ema {' '.join(flags) or '(chunk loop)'}: "
            f"wrote utt0.npy ... utt4.npy")
    return results


def churn_schedule(lanes: int) -> list[tuple[str, int, int]]:
    """(phase, joins, leaves) before each round of the churn."""
    return ([("1 stream", 0, 0)] * 10 + [(f"ramp to {lanes}", 1, 0)]
            * (lanes - 1) + [(f"{lanes} streams", 0, 0)] * 10
            + [("drain to 4", 0, 1)] * (lanes - 4) + [("4 streams", 0, 0)]
            * 10)


def run_churn(streaming, inference, model, config, feat_dim: int,
              rng, eager_check: bool) -> dict:
    """The churn schedule through one ``StreamingServer``: each round timed
    (``step``, its host readback included); with ``eager_check`` each round
    held against the eager masked step (``chunk_step``) on the same inputs,
    carry and mask, bit for bit; then each client's stream served alone in
    its lane (the lanes below it held by clients that send nothing), bit
    for bit. Clients with an odd id skip every seventh round of their
    stream (a stall keeps the carry)."""
    server = streaming.StreamingServer(model, config, max_lanes=STREAM_LANES)
    syn = server.syn
    rows = syn.chunk_frames
    server.join("warm-up")  # the capture, outside the timed rounds
    server.step({"warm-up": np.zeros((rows, feat_dim), np.float32)})
    server.leave("warm-up")
    server.join(0)
    lane_of, sent, got, lat = {0: 0}, {0: []}, {0: []}, {}
    next_id, age, worst = 1, {0: 0}, 0.0
    for label, joins, leaves in churn_schedule(STREAM_LANES):
        for _ in range(joins):
            lane_of[next_id] = server.join(next_id)
            sent[next_id], got[next_id], age[next_id] = [], [], 0
            next_id += 1
        for _ in range(leaves):
            server.leave(server.active[0])
        subs = {}
        for cid in server.active:
            age[cid] += 1
            if not (cid % 2 and age[cid] % 7 == 0):
                subs[cid] = rng.standard_normal((rows, feat_dim)).astype(
                    np.float32)
        prev = syn._prev.clone()
        torch.cuda.synchronize()
        start = time.perf_counter()
        outs = server.step(subs)
        lat.setdefault(label, []).append(1e3 * (time.perf_counter() - start))
        for cid, chunk in subs.items():
            sent[cid].append(chunk)
            got[cid].append(outs[cid])
        if eager_check:
            feats = torch.zeros((STREAM_LANES, rows, feat_dim), device="cuda")
            mask = torch.zeros((STREAM_LANES,), dtype=torch.bool,
                               device="cuda")
            for cid, chunk in subs.items():
                feats[lane_of[cid]] = torch.from_numpy(chunk).cuda()
                mask[lane_of[cid]] = True
            with torch.inference_mode():
                out, new_prev = inference.chunk_step(model, feats, prev,
                                                     syn.ck, mask)
            diff = max([(syn._prev - new_prev).abs().max().item()] + [
                float(np.abs(outs[cid] - out[lane_of[cid]].cpu().numpy()
                             ).max()) for cid in subs])
            worst = max(worst, diff)
    if worst:
        raise AssertionError(f"[stream] rounds against the eager masked "
                             f"step: {worst:.3e} (expected bit-equal)")
    for cid in sent:  # each stream alone, in its lane
        solo = streaming.StreamingServer(model, config,
                                         max_lanes=STREAM_LANES)
        for i in range(lane_of[cid]):
            solo.join(f"idle {i}")
        solo.join(cid)
        alone = [solo.step({cid: chunk})[cid] for chunk in sent[cid]]
        if not np.array_equal(np.concatenate(alone), np.concatenate(got[cid])):
            raise AssertionError(f"[stream] client {cid} (lane "
                                 f"{lane_of[cid]}): served with others "
                                 f"differs from served alone")
    every = [v for values in lat.values() for v in values]
    phases = {label: {"p50_ms": float(np.percentile(v, 50)),
                      "p99_ms": float(np.percentile(v, 99)), "rounds": len(v)}
              for label, v in [*lat.items(), ("overall", every)]}
    return {"phases": phases, "clients": len(sent),
            "eager_max_abs_diff": worst if eager_check else None,
            "server": server, "last_subs": subs}


def phase_stream(port, seed: int, device_name: str, tmp: str) -> dict:
    """[stream] ``StreamingServer(max_lanes=STREAM_LANES)`` with the EMA
    HiFi-CAR at full width (100-frame chunks, 0.5 s), f32 and hybrid: the
    churn (``run_churn``, eager check on), p50/p99 ms a round per phase and
    overall; a profiler window over PROFILE_CHUNKS rounds counting the pair
    kernels a replay (36), and a replay's device time by CUDA events; one stream's ms a chunk synced, pipelined
    (``pipeline_depth=2``) and by ``synthesize_all``, in turns, all three
    bit-equal; then the AR BiGRU served on the same churn, each client
    against its solo serve."""
    inference, streaming, weights = (port["inference"], port["streaming"],
                                     port["weights"])
    gp = GENERATOR_PARAMS
    ckpt = os.path.join(tmp, "stream_generator.pth")
    torch.save({"model": {"generator": weights.jax_params_to_state_dict(
        numpy_generator_params(gp, seed), gp)}}, ckpt)
    modes = {"f32": CONFIG, "hybrid_bf16": dict(CONFIG, generator_params=dict(
        gp, compute_dtype="bfloat16", hybrid_precision=True))}
    rng = np.random.default_rng(seed + 5)
    results = {}
    for mode, config in modes.items():
        model = inference.load_model(ckpt, config, device="cuda")
        model.remove_weight_norm()
        r = run_churn(streaming, inference, model, config, N_FEATS, rng,
                      eager_check=True)
        server, subs = r.pop("server"), r.pop("last_subs")
        prof = profile_device(lambda: [server.step(subs)
                                       for _ in range(PROFILE_CHUNKS)])
        pairs = prof["kernel_counts"]["resblock_pair_wgmma"]
        if pairs != 36 * PROFILE_CHUNKS:
            raise AssertionError(f"[stream] {mode}: the profiler counted "
                                 f"{pairs} pair kernels over "
                                 f"{PROFILE_CHUNKS} rounds, expected "
                                 f"{36 * PROFILE_CHUNKS}")
        # beside the profiler's busy share, one read without it: a replay's
        # device time over the round's p50 (a round adds the upload, the
        # mask, the copies out and the readback to the replay)
        replay_ms = time_ms(model.chunk_graph(
            STREAM_LANES, N_FEATS, server.syn.ck, masked=True).graph.replay,
            20)
        replay_share = replay_ms / r["phases"]["overall"]["p50_ms"]
        x = rng.standard_normal((W2A_SECONDS * 200, N_FEATS)).astype(
            np.float32)
        n_chunks = len(x) // CHUNK_FRAMES
        syn = streaming.StreamingSynthesizer(model, config)

        def synced():
            syn.reset()
            return np.concatenate([syn.synthesize_chunk(
                x[i:i + CHUNK_FRAMES])[0] for i in range(0, len(x),
                                                         CHUNK_FRAMES)])

        def pipelined():
            syn.reset()
            return np.concatenate(list(syn.synthesize(x, pipeline_depth=2)))

        times, outs = run_turns({"synced": synced, "pipelined": pipelined,
                                 "synthesize_all": lambda: syn.synthesize_all(
                                     x)}, ("synced", "pipelined",
                                           "synthesize_all") * 2)
        if not (np.array_equal(outs["synced"], outs["pipelined"])
                and np.array_equal(outs["synced"][:, 0],
                                   outs["synthesize_all"])):
            raise AssertionError(f"[stream] {mode}: one stream synced, "
                                 f"pipelined and synthesize_all differ")
        chunk_ms = {k: 1e3 * float(np.median(v)) / n_chunks
                    for k, v in times.items()}
        r.update(profile=prof, pair_launches_profiled=pairs,
                 replay_device_ms=replay_ms,
                 replay_share_of_round_p50=replay_share,
                 single_stream_chunk_ms=chunk_ms)
        results[mode] = r
        spans = "; ".join(f"{label} p50 {p['p50_ms']:.3f} p99 "
                          f"{p['p99_ms']:.3f}" for label, p in
                          r["phases"].items())
        busy = ("not measured" if prof["busy_share"] is None else
                f"{100 * prof['busy_share']:.1f} %")
        log(f"[stream] {mode}, {STREAM_LANES} lanes, {r['clients']} clients "
            f"over {len(churn_schedule(STREAM_LANES))} rounds on "
            f"{device_name}: ms a round {spans}; rounds against the eager "
            f"masked step {r['eager_max_abs_diff']:.1e}, every client "
            f"bit-equal to its solo serve; profiler over {PROFILE_CHUNKS} "
            f"rounds: {pairs} resblock_pair_wgmma, device busy {busy} (a "
            f"replay's device time {replay_ms:.3f} ms, "
            f"{100 * replay_share:.1f} % of the round's p50); one "
            f"stream, ms a chunk: synced {chunk_ms['synced']:.3f}, pipelined "
            f"{chunk_ms['pipelined']:.3f}, synthesize_all "
            f"{chunk_ms['synthesize_all']:.3f}")
    gp13 = dict(W2A_AR_GP, in_channels=13 + W2A_AR_GP["ar_output"])
    config = dict(W2A_CONFIG, generator_params=gp13)
    model = inference.load_model(bigru_checkpoint(
        port, gp13, seed, os.path.join(tmp, "stream_w2a.pth")), config,
        device="cuda")
    r = run_churn(streaming, inference, model, config, 13, rng,
                  eager_check=False)
    r.pop("server"), r.pop("last_subs")
    results["w2a"] = r
    spans = "; ".join(f"{label} p50 {p['p50_ms']:.3f} p99 {p['p99_ms']:.3f}"
                      for label, p in r["phases"].items())
    log(f"[stream] w2a AR BiGRU, {STREAM_LANES} lanes, {r['clients']} clients "
        f"on {device_name}: ms a round {spans}; every client bit-equal to its "
        f"solo serve")
    return results


# the generator zoo: egs/ema/voc1/conf/e2w_hifigan.yaml's features (13 EMA
# at 200 Hz), 16 kHz, hop 80, losses, optimizers and B 32 x 8000 samples,
# with each family's generator and discriminator at the JAX classes'
# defaults; only scale lists change (to products of the recipe's hop 80),
# none is autoregressive (use_ar false, the 13 features in). The w2a
# inversion models read 13-d features and write the 12 EMA channels, both at
# 200 rows a second (sampling_rate 200, hop 1: one output frame a row), in
# windows of ZOO_W2A_ROWS rows
E2W_RECIPE = os.path.join(ROOT, "egs", "ema", "voc1", "conf",
                          "e2w_hifigan.yaml")
ZOO_TRAIN_UTTS, ZOO_TRAIN_SECONDS = 32, 3
ZOO_WARMUP_STEPS, ZOO_TIMED_STEPS = 2, 3  # the run's steps, then timed ones
ZOO_DECODE_UTTS, ZOO_DECODE_SECONDS = 16, 10
ZOO_W2A_ROWS = 400  # 2 s (the banded attention holds no L x L logits)
ZOO_F64_TOL = 1e-4  # f32 generator against float64 on the card, of max |y|
ZOO_PROFILE_FORWARDS = 5
# the pair's and the head's shapes on the multi-band path: B 32, 100 frames
# (T x5, x10, x20); the MSD's three scales of 8000 samples, stride 4
MB_BATCH, MB_FRAMES = 32, 100
MB_HEAD_SHAPES = [(32, 8000, 4), (32, 4001, 4), (32, 2001, 4)]


def zoo_configs() -> dict:
    """Each family's full-width training config (see ZOO_* above)."""
    import yaml
    with open(E2W_RECIPE) as f:
        base = yaml.safe_load(f)
    base.update(format="npy", num_workers=2, train_max_steps=ZOO_WARMUP_STEPS,
                save_interval_steps=ZOO_WARMUP_STEPS,
                eval_interval_steps=200000, log_interval_steps=100)
    msmpd = base["discriminator_params"]
    ema = dict(msmpd, scale_discriminator_params=dict(
        msmpd["scale_discriminator_params"], in_channels=12),
        period_discriminator_params=dict(
            msmpd["period_discriminator_params"], in_channels=12))
    w2a = dict(base, dataset_mode="w2a", sampling_rate=200, hop_size=1,
               batch_max_steps=ZOO_W2A_ROWS, discriminator_params=ema)
    return {
        "mb-hifigan": dict(
            base, generator_params=dict(
                base["generator_params"], in_channels=13, use_ar=False,
                out_channels=4, upsample_scales=[5, 2, 2],
                upsample_kernel_sizes=[10, 4, 4]),
            pqmf=True, use_subband_stft_loss=True,
            subband_stft_loss_params={"fft_sizes": [384, 683, 171],
                                      "hop_sizes": [30, 60, 10],
                                      "win_lengths": [150, 300, 60]}),
        "melgan": dict(
            base, generator_type="MelGANGenerator",
            generator_params={"in_channels": 13, "out_channels": 1,
                              "kernel_size": 7, "channels": 512,
                              "upsample_scales": [5, 4, 2, 2], "stacks": 3},
            discriminator_type="MelGANMultiScaleDiscriminator",
            discriminator_params={}),
        # its discriminator returns one logits tensor: no feature matching
        "pwg": dict(
            base, generator_type="ParallelWaveGANGenerator",
            generator_params={"layers": 30, "stacks": 3,
                              "residual_channels": 64, "gate_channels": 128,
                              "skip_channels": 64, "aux_channels": 13,
                              "aux_context_window": 2, "upsample_params": {
                                  "upsample_scales": [5, 4, 2, 2]}},
            discriminator_type="ParallelWaveGANDiscriminator",
            discriminator_params={}, use_feat_match_loss=False),
        # kernels 2 s + 1: a GBlock takes odd kernels only
        "gblock": dict(
            base, generator_type="GBlockGenerator",
            generator_params={"in_channels": 13, "channels": 512,
                              "kernel_size": 7, "g_scales": [5, 4, 2, 2],
                              "g_kernel_sizes": [11, 9, 5, 5]}),
        # the noise upsampling gives the 100 frames of a window
        "style-melgan": dict(
            base, generator_type="StyleMelGANGenerator",
            generator_params={"in_channels": 128, "aux_channels": 13,
                              "channels": 64, "kernel_size": 9,
                              "noise_upsample_scales": [5, 5, 2, 2],
                              "upsample_scales": [5, 2, 2, 2, 2, 1]},
            discriminator_type="StyleMelGANDiscriminator",
            discriminator_params={}),
        "transformer": dict(
            w2a, generator_type="Transformer",
            generator_params={"in_channels": 13, "out_channels": 12,
                              "hidden_dim": 768, "elayers": 6}),
        # benchmarks/inversion_bench.py's model
        "bigru": dict(
            w2a, generator_type="BiGRU",
            generator_params={"in_channels": 13, "hidden_size": 256,
                              "out_channels": 12}),
    }


def _write_zoo_corpus(root: str, seed: int, config: dict, utts: int,
                      seconds: float, stage: str, dev: int = 0) -> None:
    """``dump/<stage>/norm/<utt>-{wave,feats}.npy`` and
    ``data/<stage>/feats.scp``: a2w random waves and 13 features at 200
    Hz; w2a 13 features in the wave stream and 12 EMA targets."""
    rng = np.random.default_rng(seed)
    w2a = config["dataset_mode"] == "w2a"
    frames = int(seconds * 200)
    for name, n in ((stage, utts), ("dev", dev)):
        if not n:
            continue
        dump = os.path.join(root, "dump", name, "norm")
        data = os.path.join(root, "data", name)
        os.makedirs(dump)
        os.makedirs(data)
        lines = []
        for i in range(n):
            if w2a:
                stream = rng.standard_normal((frames, 13))
                art = rng.standard_normal((frames, 12))
            else:
                stream = 0.3 * rng.standard_normal(frames * 80)
                art = rng.standard_normal((frames, 13))
            np.save(os.path.join(dump, f"u{i}-wave.npy"),
                    stream.astype(np.float32))
            np.save(os.path.join(dump, f"u{i}-feats.npy"),
                    art.astype(np.float32))
            np.save(os.path.join(data, f"u{i}.npy"), art.astype(np.float32))
            lines.append(f"u{i} {os.path.join(data, f'u{i}.npy')}\n")
        with open(os.path.join(data, "feats.scp"), "w") as f:
            f.writelines(lines)


def _zoo_forward(model, x, z):
    """One forward with explicit noise for the noise-driven families."""
    name = type(model).__name__
    if name == "ParallelWaveGANGenerator":
        return model(z, x)
    if name == "StyleMelGANGenerator":
        return model(x, z)
    return model(x)


def _zoo_noise(model, x):
    """The noise a forward of ``model`` on ``x`` reads, or None."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    name = type(model).__name__
    if name == "ParallelWaveGANGenerator":
        c = x.shape[1] - 2 * model.aux_context_window
        return torch.randn((x.shape[0], c * model.upsample_factor, 1),
                           generator=gen, device="cuda")
    if name == "StyleMelGANGenerator":
        return torch.randn((x.shape[0], x.shape[1]
                            // model.noise_upsample_factor, model.in_channels),
                           generator=gen, device="cuda")
    return None


def _banded_counts(since: dict | None = None) -> dict:
    """The banded attention's launch counts in ``expected_launches``'s
    form, less ``since``'s."""
    from articulatory_tpu_torch.ops.banded_attention import (
        banded_attention,
        banded_attention_backward,
    )
    now = {"banded_attention": dict(banded_attention.launches_by_dtype),
           "banded_attention_backward": banded_attention_backward.launches}
    if since is None:
        return now
    by_dtype = {k: n - since["banded_attention"].get(k, 0)
                for k, n in now["banded_attention"].items()}
    return {"banded_attention": {k: n for k, n in by_dtype.items() if n},
            "banded_attention_backward": now["banded_attention_backward"]
            - since["banded_attention_backward"]}


def phase_zoo(port: dict, family: str, config: dict, seed: int,
              device_name: str, tmp: str, tag: str | None = None) -> dict:
    """[zoo-<family>] ``bin/train.py::train`` for ZOO_WARMUP_STEPS steps on
    a synthetic corpus (launch counts; the generator gated off, as the
    recipe's ``generator_train_start_steps`` 1 has it), then one untimed
    and ZOO_TIMED_STEPS timed steps of its train step with both models on
    (median; finite losses; every parameter moved; for the multi-band
    HiFi-GAN, one batch's gradients with both kernels against both plain
    versions, as phase_train's (d)); ``bin/decode.py`` of the
    written checkpoint on ZOO_DECODE_UTTS x ZOO_DECODE_SECONDS s (samples/s
    and RTF, finite outputs of the right length); the f32 generator
    against the same module in float64 on the card (the pair's plain
    version there); and a profiler window over ZOO_PROFILE_FORWARDS
    forwards of one utterance."""
    train_cli, gan, decode = port["train"], port["gan"], port["decode"]
    pair, head = port["resblock_pair"], port["scale_disc_head"]
    split, head_split = port["split_tf32"], port["split_weights"]
    tag = tag or f"zoo-{family}"
    w2a = config["dataset_mode"] == "w2a"
    _write_zoo_corpus(tmp, seed, config, ZOO_TRAIN_UTTS, ZOO_TRAIN_SECONDS,
                      "tr", dev=8)
    outdir = os.path.join(tmp, "exp")
    pair.launches = head.launches = split.launches = head_split.launches = 0
    start = time.perf_counter()
    trainer = train_cli.train(
        config, train_dumpdir=os.path.join(tmp, "dump/tr/norm"),
        dev_dumpdir=os.path.join(tmp, "dump/dev/norm"), outdir=outdir,
        data_root=os.path.join(tmp, "data"), seed=seed, device="cuda")
    torch.cuda.synchronize()
    run_seconds = time.perf_counter() - start
    launches = {"resblock_pair": pair.launches,
                "scale_disc_head": head.launches,
                "split_tf32": split.launches,
                "split_weights": head_split.launches}
    if family == "mb-hifigan":
        # 27 pairs a generator forward, two forwards a step; 3 scales x 4
        # discriminator passes
        expected = {"resblock_pair": 54 * ZOO_WARMUP_STEPS,
                    "scale_disc_head": 12 * ZOO_WARMUP_STEPS,
                    "split_tf32": 54 * ZOO_WARMUP_STEPS,
                    "split_weights": 12 * ZOO_WARMUP_STEPS}
        if launches != expected:
            raise AssertionError(f"[{tag}] launches {launches}, expected "
                                 f"{expected}")
    state = trainer.state
    lr = config["generator_optimizer_params"]["lr"]
    batch = port["to_device"](next(iter(trainer.data_loader["train"])),
                              trainer.device)
    # one untimed step with both models on (the generator's optimizer
    # state is made in its first update), then the timed ones
    banded = _banded_counts()
    trainer.train_step(state, batch, lr, lr)
    step_s, metrics = [], {}
    for _ in range(ZOO_TIMED_STEPS):
        torch.cuda.synchronize()
        begin = time.perf_counter()
        metrics = trainer.train_step(state, batch, lr, lr)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - begin)
    banded = _banded_counts(banded)
    if config["generator_type"] == "Transformer":
        want = expected_launches(config, 1 + ZOO_TIMED_STEPS)
        if banded != want:
            raise AssertionError(f"[{tag}] banded attention launches "
                                 f"{banded} in {1 + ZOO_TIMED_STEPS} steps, "
                                 f"expected {want}")
        launches["banded_attention_timed_steps"] = banded
    losses = {k: float(v) for k, v in metrics.items()}
    if not losses or not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"[{tag}] losses not finite: {losses}")
    grad_gaps = {}
    if family == "mb-hifigan":  # (d) of phase_train on the multi-band path
        criterion = gan.GANCriterion(trainer.config)
        params = (list(state.generator.parameters()),
                  list(state.discriminator.parameters()))
        with torch.no_grad():
            fake = gan.synthesize(criterion, gan.generate(
                state.generator, batch, state.draws))

        def both_grads():
            gen_loss, _ = gan.generator_loss(state, criterion, config, batch)
            dis_loss, _ = gan.discriminator_loss(state, criterion, config,
                                                 batch, fake)
            return _grads(gen_loss, params[0]), _grads(dis_loss, params[1])

        kernel_grads = both_grads()
        with swapped(port["residual"], "resblock_pair",
                     port["resblock_pair_plain"]), \
                swapped(port["hifigan"], "scale_disc_head",
                        port["scale_disc_head_plain"]):
            plain_grads = both_grads()
        for name, got, want in zip(("generator", "discriminator"),
                                   kernel_grads, plain_grads):
            pooled, per = _grad_gaps(got, want)
            grad_gaps[name] = {"pooled_rel_l2": pooled,
                               "worst_tensor_rel_l2": per}
            if pooled > GRAD_TOL[0] or per > GRAD_TOL[1]:
                raise AssertionError(
                    f"[{tag}] {name} gradients with the kernels differ from "
                    f"plain by {pooled:.3e} pooled, {per:.3e} worst tensor "
                    f"> {GRAD_TOL}")
        log(f"[{tag}] kernel vs plain gradients, relative L2 pooled / worst "
            f"tensor: " + ", ".join(f"{k} {v['pooled_rel_l2']:.3e} / "
                                    f"{v['worst_tensor_rel_l2']:.3e}"
                                    for k, v in grad_gaps.items())
            + f" (limits {GRAD_TOL})")
    for model, name, model_seed in (
            (state.generator, "generator", seed),
            (state.discriminator, "discriminator", seed + 1)):
        initial = port["build_model"](config[f"{name}_type"],
                                      config[f"{name}_params"],
                                      seed=model_seed).state_dict()
        # a WaveNet stack's last residual output feeds nothing (only its
        # skip does), in the JAX package and the reference alike
        dead = (f"conv_layers.{len(model.conv_layers) - 1}.conv1x1_out."
                if type(model).__name__ == "ParallelWaveGANGenerator"
                else None)
        still = [k for k, p in model.named_parameters()
                 if torch.equal(p.detach().cpu(), initial[k])
                 and not (dead and k.startswith(dead))]
        if still:
            raise AssertionError(f"[{tag}] {name} parameters never moved: "
                                 f"{still[:5]}")
    step_ms = 1e3 * float(np.median(step_s))
    log(f"[{tag}] {config['generator_type']} + {config['discriminator_type']}"
        f", B {config['batch_size']} x {config['batch_max_steps']}: "
        f"{ZOO_WARMUP_STEPS} steps through bin/train.py in "
        f"{run_seconds:.3f} s (build and warm-up included), launches "
        f"{launches}; step median {step_ms:.3f} ms [range "
        f"{1e3 * min(step_s):.3f}, {1e3 * max(step_s):.3f}] over "
        f"{ZOO_TIMED_STEPS}; losses "
        + ", ".join(f"{k.split('/')[-1]} {v:.4f}" for k, v in losses.items()))

    # the decode CLI on the written checkpoint
    ckpt = os.path.join(outdir, f"checkpoint-{ZOO_WARMUP_STEPS}steps.ckpt")
    dec_root = os.path.join(tmp, "decode")
    _write_zoo_corpus(dec_root, seed + 3, config, ZOO_DECODE_UTTS,
                      ZOO_DECODE_SECONDS, "eval")
    pair.launches = 0
    result = decode.decode(config, ckpt, os.path.join(dec_root, "out"),
                           dumpdir=os.path.join(dec_root, "dump/eval/norm"),
                           device="cuda")
    decode_pairs = pair.launches
    frames = ZOO_DECODE_SECONDS * 200
    for i in range(ZOO_DECODE_UTTS):
        if w2a:
            y = np.load(os.path.join(dec_root, "out", f"u{i}_gen.npy"))
            want = (frames, 12)
        else:
            y, _ = port["read_wav"](os.path.join(dec_root, "out",
                                                 f"u{i}_gen.wav"))
            want = (frames * 80,)
        if y.shape != want or not np.isfinite(y).all():
            raise AssertionError(f"[{tag}] decode u{i}: {y.shape}, not "
                                 f"finite or not {want}")
    rate = result["seconds_audio"] * 16000 / result["seconds_elapsed"]
    log(f"[{tag}] bin/decode.py: {ZOO_DECODE_UTTS} x {ZOO_DECODE_SECONDS} s "
        f"in {result['seconds_elapsed']:.3f} s, {rate:.1f} samples/s of "
        f"16 kHz audio, mean RTF {result['rtf']:.6f}; resblock_pair launches "
        f"{decode_pairs}")

    # the f32 generator against float64, and a profiler window
    model = port["inference"].load_model(ckpt, config, device="cuda")
    gen = model.model
    x = torch.from_numpy(np.load(os.path.join(
        dec_root, "dump/eval/norm", "u0-" + ("wave" if w2a else "feats")
        + ".npy"))).cuda()[None]
    if type(gen).__name__ == "ParallelWaveGANGenerator":
        x = torch.nn.functional.pad(x.transpose(1, 2), (2, 2),
                                    mode="replicate").transpose(1, 2)
    z = _zoo_noise(gen, x)
    with torch.inference_mode():
        y = _zoo_forward(gen, x, z)
        with swapped(port["residual"], "resblock_pair",
                     port["resblock_pair_plain"]):
            y64 = _zoo_forward(copy.deepcopy(gen).double(), x.double(),
                               None if z is None else z.double())
    err = ((y.double() - y64).abs().max() / y64.abs().max()).item()
    if not torch.isfinite(y).all() or err > ZOO_F64_TOL:
        raise AssertionError(f"[{tag}] f32 generator {err:.3e} of max |y| "
                             f"from float64 (limit {ZOO_F64_TOL}) or not "
                             f"finite")
    with torch.inference_mode():
        prof = profile_device(lambda: [_zoo_forward(gen, x, z)
                                       for _ in range(ZOO_PROFILE_FORWARDS)])
    busy = ("not measured" if prof["busy_share"] is None else
            f"{100 * prof['busy_share']:.1f} % of {prof['span_ms']:.3f} ms")
    log(f"[{tag}] f32 generator against float64 on the card: {err:.3e} of "
        f"max |y| (limit {ZOO_F64_TOL}); profiler over "
        f"{ZOO_PROFILE_FORWARDS} forwards of one {ZOO_DECODE_SECONDS} s "
        f"utterance on {device_name}: device busy {busy}, "
        f"{prof['device_ops']} device ops, pair kernels "
        f"{prof['kernel_counts']['resblock_pair_wgmma']}; top: "
        + "; ".join(f"{o['name'][:60]} {o['ms']:.3f} ms x{o['calls']}"
                    for o in prof["top_ops"][:4]))
    if family == "mb-hifigan" and (
            prof["kernel_counts"]["resblock_pair_wgmma"]
            != 27 * ZOO_PROFILE_FORWARDS
            or decode_pairs != 27 * ZOO_DECODE_UTTS):
        raise AssertionError(f"[{tag}] pair kernels: "
                             f"{prof['kernel_counts']} in the profile, "
                             f"{decode_pairs} in the decode")
    return {"run_seconds": run_seconds, "launches": launches,
            "grad_gaps": grad_gaps, "step_ms_median": step_ms,
            "step_ms": [1e3 * s for s in step_s], "losses": losses,
            "decode": dict(result, samples_per_s=rate,
                           pair_launches=decode_pairs),
            "f64_rel_err": err, "profile": prof}


# conditioning and cascades: the EMA HiFi-CAR of e2w_hifigan_car.yaml
# conditioned on COND_SPEAKERS speakers (the Haskins Production Rate
# Comparison corpus's 8 talkers) and COND_PHONEMES phoneme ids (the 39
# ARPAbet phonemes of CMUdict and a silence), with the phoneme head at the
# JAX package's default weight; the tables are small beside the conv stack,
# so no width changes (spk_fc maps 32 -> 141, the input conv reads 141 + 8)
COND_SPEAKERS, COND_PHONEMES, COND_LAMBDA_PH = 8, 40, 1.0
COND_GP = dict(GENERATOR_PARAMS, use_spk_id=True, num_spk=COND_SPEAKERS,
               use_ph=True, num_ph=COND_PHONEMES, use_ph_loss=True)
COND_TRAIN_CONFIG = dict(TRAIN_CONFIG, generator_params=COND_GP,
                         lambda_ph=COND_LAMBDA_PH)
# the conditioning's leaves, whose kernel-vs-plain gradients print apart
COND_REPORT = ("spk_emb_mat.weight", "spk_fc.weight", "ph_emb_mat.weight",
               "ph_fc.weight")
# the decode of a phoneme-head checkpoint: the LoadedModel passes no
# speaker or phoneme ids (as the JAX package's), so only the head decodes
PH_GP = dict(GENERATOR_PARAMS, use_ph_loss=True, num_ph=COND_PHONEMES)
# the cascade's frozen second stage: a HiFi-GAN from the 12 EMA channels to
# the 13 input features, channels 512, MRF 3/7/11 x 1/3/5, scale 1
CASCADE_GP2 = {"in_channels": 12, "out_channels": 13, "channels": 512,
               "kernel_size": 7, "upsample_scales": [1],
               "upsample_kernel_sizes": [2],
               "resblock_kernel_sizes": [3, 7, 11],
               "resblock_dilations": [[1, 3, 5]] * 3, "use_ar": False}
# the multimodal decode: the EMA frames (200 Hz) and an MRI-like modality
# (hop 240 at 20 kHz, 83.3 frames a second: each chunk interpolated by 2.4)
MULT_HOPS, MULT_RATES = [80, 240], [16000, 20000]
MULT_CHUNKS_CHECKED = 3


def _cond_corpus(root: str, speakers: int, phonemes: int, seed: int) -> None:
    """utt2spk (utterance i is speaker i mod ``speakers``) and ph.scp
    (random ids, one a frame) beside each stage's feats.scp under root."""
    rng = np.random.default_rng(seed)
    for stage in ("tr", "dev"):
        data = os.path.join(root, "data", stage)
        utts = [line.split()[0] for line in open(
            os.path.join(data, "feats.scp"))]
        spk, ph = [], []
        for i, utt in enumerate(utts):
            frames = len(np.load(os.path.join(data, f"{utt}.npy")))
            path = os.path.join(data, f"{utt}-ph.npy")
            np.save(path, rng.integers(0, phonemes, frames).astype(np.int32))
            spk.append(f"{utt} s{i % speakers}\n")
            ph.append(f"{utt} {path}\n")
        with open(os.path.join(data, "utt2spk"), "w") as f:
            f.writelines(spk)
        with open(os.path.join(data, "ph.scp"), "w") as f:
            f.writelines(ph)


def phase_cond_train(port: dict, seed: int, tmp: str) -> dict:
    """[cond-train] ``bin/train.py`` on the conditioned HiFi-CAR (speaker
    ids, phoneme inputs, the phoneme head), phase_train's checks (a)-(d)
    with the conditioning's gradients apart and ``train/ph_loss`` finite
    and above 0; then one ``make_train_step`` with PCD inputs (random pitch
    and periodicity, the MSMPD on 3 channels: its scale discriminators on
    plain convs, no head launch)."""
    gan = port["gan"]
    pair, head = port["resblock_pair"], port["scale_disc_head"]
    _write_corpus(tmp, seed, COND_TRAIN_CONFIG)
    _cond_corpus(tmp, COND_SPEAKERS, COND_PHONEMES, seed + 4)
    out = phase_train(port, seed, tmp, config=COND_TRAIN_CONFIG,
                      tag="cond-train")
    gaps = out["grad_gaps"]["generator_tensors"]
    log("[cond-train] the conditioning's gradients, kernel vs plain, "
        "relative L2: " + ", ".join(f"{k} {gaps[k]:.3e}"
                                    for k in COND_REPORT))
    ph_loss = out["mean_losses"].get("train/ph_loss")
    if ph_loss is None or not np.isfinite(ph_loss) or ph_loss <= 0:
        raise AssertionError(f"[cond-train] train/ph_loss {ph_loss}")

    # PCD: one step of the recipe's model on pitch-conditioned
    # discriminator inputs
    dp = copy.deepcopy(TRAIN_CONFIG["discriminator_params"])
    for key in ("scale_discriminator_params", "period_discriminator_params"):
        dp[key]["in_channels"] = 3
    config = dict(TRAIN_CONFIG, use_pcd=True, discriminator_params=dp)
    build, optimizer = port["build_model"], port["build_optimizer"]
    generator = build("HiFiGANGenerator", GENERATOR_PARAMS, seed=seed).cuda()
    discriminator = build(config["discriminator_type"], dp,
                          seed=seed + 1).cuda()
    opt = {k: optimizer("Adam", {"lr": 1e-4, "betas": [0.5, 0.9]}, -1,
                        m.parameters())
           for k, m in (("g", generator), ("d", discriminator))}
    state = gan.GANTrainState(generator=generator, discriminator=discriminator,
                              opt_g=opt["g"], opt_d=opt["d"], steps=1)
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    b, n = config["batch_size"], config["batch_max_steps"]
    frames = n // config["hop_size"]

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    batch = {"x": (randn(b, frames, N_FEATS),), "y": randn(b, n, 1, scale=0.3),
             "ar": randn(b, GENERATOR_PARAMS["ar_input"], 1, scale=0.3),
             "pitch": randn(b, frames, 1), "periodicity": randn(b, frames, 1)}
    step = gan.make_train_step(gan.GANCriterion(config), config)
    pair.launches = head.launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    metrics = step(state, batch, 1e-4, 1e-4)
    torch.cuda.synchronize()
    pcd_ms = 1e3 * (time.perf_counter() - start)
    pcd = {"launches": {"resblock_pair": pair.launches,
                        "scale_disc_head": head.launches},
           "losses": {k: float(v) for k, v in metrics.items()},
           "first_step_ms": pcd_ms}
    if pcd["launches"] != {"resblock_pair": 72, "scale_disc_head": 0} or \
            not all(np.isfinite(v) for v in pcd["losses"].values()):
        raise AssertionError(f"[cond-train] PCD step: {pcd}")
    log(f"[cond-train] PCD step (3-channel MSMPD, B {b} x {n}): launches "
        f"{pcd['launches']}, first step {pcd_ms:.3f} ms, losses "
        + ", ".join(f"{k.split('/')[-1]} {v:.4f}"
                    for k, v in pcd["losses"].items()))
    out["pcd"] = pcd
    return out


def phase_cond_decode(port, seed: int, device_name: str, tmp: str) -> dict:
    """[cond-decode] a phoneme-head checkpoint of the recipe (random, from
    ``seed``) decoded UTTS x SECONDS s: eager in f32 and hybrid (36 pairs a
    chunk; chunks 0, 1 and the last against the plain pairs under the run's
    carry), phase_graph's captured loop (36 pairs a replay, chunks against
    eager), the graph and eager runs bit for bit, and ``bin/decode.py``
    eager and ``--ar-scan`` at batch UTTS (the same wav files)."""
    inference, residual, resblock_pair, plain, weights, decode = (
        port[k] for k in ("inference", "residual", "resblock_pair", "plain",
                          "weights", "decode"))
    tree = numpy_generator_params(PH_GP, seed)
    rng = np.random.default_rng(seed + 6)
    width = GENERATOR_PARAMS["channels"] // 2 ** len(
        GENERATOR_PARAMS["upsample_scales"])
    bound = 1.0 / np.sqrt(width)
    tree["ph_fc"] = {
        "w": rng.uniform(-bound, bound, (width, COND_PHONEMES)
                         ).astype(np.float32),
        "b": rng.uniform(-bound, bound, COND_PHONEMES).astype(np.float32)}
    ckpt = os.path.join(tmp, "ph_generator.pth")
    torch.save({"model": {"generator": weights.jax_params_to_state_dict(
        tree, PH_GP)}}, ckpt)
    config = dict(CONFIG, generator_params=PH_GP)
    modes = {"f32": config, "hybrid_bf16": dict(config, generator_params=dict(
        PH_GP, compute_dtype="bfloat16", hybrid_precision=True))}
    hop, chunk_len = CONFIG["hop_size"], CONFIG["batch_max_steps"]
    n_frames = int(SECONDS * CONFIG["sampling_rate"] / hop)
    n_chunks = -(-n_frames // CHUNK_FRAMES)
    xs = [rng.standard_normal((n_frames, N_FEATS)).astype(np.float32)
          for _ in range(UTTS)]
    models, results = {}, {}
    for mode, cfg in modes.items():
        model = models[mode] = inference.load_model(ckpt, cfg, device="cuda")
        model.remove_weight_norm()
        inference.ar_loop_batched(model, [x[:CHUNK_FRAMES] for x in xs], cfg)
    # the capture first (phase_graph counts its launches), then the eager
    # runs, and the graph runs replaying the cached capture
    results["graph"] = phase_graph(port, models, modes, xs, "cond-decode",
                                   CHUNK_FRAMES, PH_GP["ar_input"],
                                   device_name)
    for mode, cfg in modes.items():
        model = models[mode]
        resblock_pair.launches = 0
        torch.cuda.synchronize()
        start = time.perf_counter()
        eager = inference.ar_loop_batched(model, xs, cfg)
        seconds = time.perf_counter() - start
        launches = resblock_pair.launches
        if launches != 36 * n_chunks or any(
                o.shape != (n_frames * hop,) or not np.isfinite(o).all()
                for o in eager):
            raise AssertionError(f"[cond-decode] {mode}: {launches} pair "
                                 f"launches (expected {36 * n_chunks}) or "
                                 f"outputs not finite of the right length")
        checks = _chunk_checks(model, xs, eager, residual, plain, mode,
                               n_chunks, chunk_len, timings=False)
        graph = inference.ar_loop_batched(model, xs, cfg, scan=True)
        same = all(np.array_equal(g, e) for g, e in zip(graph, eager))
        if not same:
            raise AssertionError(
                f"[cond-decode] {mode}: graph and eager differ by "
                f"{max(float(np.abs(g - e).max()) for g, e in zip(graph, eager)):.3e}")
        results[mode] = {"launches": launches, "eager_seconds": seconds,
                         "samples_per_s": UTTS * n_frames * hop / seconds,
                         "graph_equals_eager": same, **checks}
        log(f"[cond-decode] {mode}: {UTTS} x {SECONDS} s, {n_chunks} chunks "
            f"eager in {seconds:.3f} s = "
            f"{results[mode]['samples_per_s']:.1f} samples/s on "
            f"{device_name}; resblock_pair launches {launches}; chunk max "
            f"abs err vs plain {checks['chunk_max_abs_err']:.3e} (tol "
            f"{CHUNK_TOL[mode]}); graph run bit-equal to eager")
    dump = os.path.join(tmp, "dump")
    os.makedirs(dump)
    for n, x in enumerate(xs):
        np.save(os.path.join(dump, f"utt{n}-feats.npy"), x)
    wavs = {}
    for name, kwargs in (("eager", {}), ("ar_scan", {"ar_scan": True})):
        outdir = os.path.join(tmp, name)
        resblock_pair.launches = 0
        r = decode.decode(config, ckpt, outdir, dumpdir=dump, device="cuda",
                          decode_batch_size=UTTS, **kwargs)
        wavs[name] = [port["read_wav"](os.path.join(outdir, f"utt{n}_gen.wav"))
                      [0] for n in range(UTTS)]
        results[f"cli_{name}"] = dict(r, pair_launches=resblock_pair.launches)
        log(f"[cond-decode] bin/decode.py {kwargs or 'eager'}, batch {UTTS}: "
            f"{r['utterances']} utterances in {r['seconds_elapsed']:.3f} s, "
            f"RTF {r['rtf']:.6f}; resblock_pair launches "
            f"{resblock_pair.launches}")
    if results["cli_eager"]["pair_launches"] != 36 * n_chunks or not all(
            w.shape == (n_frames * hop,) and np.array_equal(w, v)
            for w, v in zip(wavs["ar_scan"], wavs["eager"])):
        raise AssertionError("[cond-decode] the decode CLI's eager and "
                             "--ar-scan runs differ, or the eager run "
                             "launched other than 36 pairs a chunk")
    return results


def phase_cascade(port: dict, seed: int, device_name: str, tmp: str) -> dict:
    """[cascade] the w2a cycle of ``tests/test_cascade.py`` at full width:
    the [zoo-bigru] BiGRU (13 -> 12) into a frozen HiFi-GAN (12 -> 13,
    CASCADE_GP2) that ``--pretrain2`` loads, with the discriminator, from a
    checkpoint this phase writes; ``bin/train.py`` for ZOO_WARMUP_STEPS
    steps, judged against the input features: 18 pair launches a step (9
    in the generator pass, whose backward asks the frozen stage for its
    input gradient alone, 9 in the regeneration), no head launch (13
    channels); generator2 bit for bit as loaded after every step; one
    batch's generator gradients with the pair kernel against the plain
    pair (pooled relative L2 <= GRAD_TOL[0]); the step median."""
    train_cli, gan = port["train"], port["gan"]
    pair, head = port["resblock_pair"], port["scale_disc_head"]
    config = copy.deepcopy(zoo_configs()["bigru"])
    dp = config["discriminator_params"]
    for key in ("scale_discriminator_params", "period_discriminator_params"):
        dp[key]["in_channels"] = 13
    config.update(generator2_type="HiFiGANGenerator",
                  generator2_params=CASCADE_GP2)
    build = port["build_model"]
    stage2 = {"generator": build("HiFiGANGenerator", CASCADE_GP2,
                                 seed=seed + 7).state_dict(),
              "discriminator": build(config["discriminator_type"], dp,
                                     seed=seed + 8).state_dict()}
    path = os.path.join(tmp, "stage2.pth")
    torch.save({"model": stage2}, path)
    _write_zoo_corpus(tmp, seed, config, ZOO_TRAIN_UTTS, ZOO_TRAIN_SECONDS,
                      "tr", dev=8)
    pair.launches = head.launches = 0
    start = time.perf_counter()
    trainer = train_cli.train(
        config, train_dumpdir=os.path.join(tmp, "dump/tr/norm"),
        dev_dumpdir=os.path.join(tmp, "dump/dev/norm"),
        outdir=os.path.join(tmp, "exp"), data_root=os.path.join(tmp, "data"),
        pretrain2=path, seed=seed, device="cuda")
    torch.cuda.synchronize()
    run_seconds = time.perf_counter() - start
    launches = {"resblock_pair": pair.launches,
                "scale_disc_head": head.launches}
    if launches != {"resblock_pair": 18 * ZOO_WARMUP_STEPS,
                    "scale_disc_head": 0}:
        raise AssertionError(f"[cascade] launches {launches}, expected "
                             f"{18 * ZOO_WARMUP_STEPS} pairs and no head")
    state = trainer.state

    def frozen_as_loaded():
        sd = state.generator2.state_dict()
        return all(torch.equal(sd[k].cpu(), v)
                   for k, v in stage2["generator"].items())

    if not frozen_as_loaded():
        raise AssertionError("[cascade] generator2 moved in bin/train.py")
    criterion = gan.GANCriterion(trainer.config)
    batch = port["to_device"](next(iter(trainer.data_loader["train"])),
                              trainer.device)
    params = list(state.generator.parameters())

    def grads():  # the BiGRU's dropout masks drawn alike in both passes
        torch.manual_seed(seed)
        loss, _ = gan.generator_loss(state, criterion, config, batch)
        return _grads(loss, params)

    kernel = grads()
    with swapped(port["residual"], "resblock_pair",
                 port["resblock_pair_plain"]):
        plain = grads()
    pooled, per = _grad_gaps(kernel, plain)
    if pooled > GRAD_TOL[0] or any(p.grad is not None
                                   for p in state.generator2.parameters()):
        raise AssertionError(f"[cascade] generator gradients with the pair "
                             f"kernel {pooled:.3e} from plain (limit "
                             f"{GRAD_TOL[0]}), or generator2 kept a grad")
    lr = config["generator_optimizer_params"]["lr"]
    trainer.train_step(state, batch, lr, lr)
    step_s = []
    pair.launches = 0
    for _ in range(ZOO_TIMED_STEPS):
        torch.cuda.synchronize()
        begin = time.perf_counter()
        metrics = trainer.train_step(state, batch, lr, lr)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - begin)
    losses = {k: float(v) for k, v in metrics.items()}
    if not frozen_as_loaded() or pair.launches != 18 * ZOO_TIMED_STEPS or \
            not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"[cascade] after the timed steps: generator2 "
                             f"moved, {pair.launches} pair launches, or "
                             f"losses {losses}")
    step_ms = 1e3 * float(np.median(step_s))
    log(f"[cascade] BiGRU -> frozen HiFi-GAN (12 -> 13, "
        f"{CASCADE_GP2['channels']} channels, scale 1), B "
        f"{config['batch_size']} x {config['batch_max_steps']} rows on "
        f"{device_name}: {ZOO_WARMUP_STEPS} steps through bin/train.py "
        f"--pretrain2 in {run_seconds:.3f} s, launches {launches}; generator2 "
        f"bit-equal as loaded; generator gradients kernel vs plain pair "
        f"{pooled:.3e} pooled / {per:.3e} worst tensor (limit "
        f"{GRAD_TOL[0]}); step median {step_ms:.3f} ms [range "
        f"{1e3 * min(step_s):.3f}, {1e3 * max(step_s):.3f}] over "
        f"{ZOO_TIMED_STEPS}; losses "
        + ", ".join(f"{k.split('/')[-1]} {v:.4f}" for k, v in losses.items()))
    return {"run_seconds": run_seconds, "launches": launches,
            "launches_per_step": 18, "grad_gap_pooled": pooled,
            "grad_gap_worst_tensor": per, "step_ms_median": step_ms,
            "step_ms": [1e3 * s for s in step_s], "losses": losses}


def phase_ph2a(port: dict, seed: int, device_name: str, tmp: str) -> dict:
    """[ph2a] the [zoo-transformer] Transformer on phoneme ids
    (COND_PHONEMES, embedding 8) to the 12 EMA channels: ``bin/train.py``
    for ZOO_WARMUP_STEPS steps (ids through ph.scp, 200 a second), then
    ``bin/decode.py`` on integer ids in the dump over ZOO_DECODE_UTTS x
    ZOO_DECODE_SECONDS s (finite (frames, 12) outputs)."""
    train_cli, decode = port["train"], port["decode"]
    config = copy.deepcopy(zoo_configs()["transformer"])
    # the w2a corpus: its 12 EMA channels are the targets, its feature
    # stream the (unread) audio
    _write_zoo_corpus(tmp, seed, config, ZOO_TRAIN_UTTS, ZOO_TRAIN_SECONDS,
                      "tr", dev=8)
    config["dataset_mode"] = "ph2a"
    config["generator_params"].update(num_ph=COND_PHONEMES, ph_emb_size=8)
    _cond_corpus(tmp, 1, COND_PHONEMES, seed + 9)
    start = time.perf_counter()
    trainer = train_cli.train(
        config, train_dumpdir=os.path.join(tmp, "dump/tr/norm"),
        dev_dumpdir=os.path.join(tmp, "dump/dev/norm"),
        outdir=os.path.join(tmp, "exp"), data_root=os.path.join(tmp, "data"),
        seed=seed, device="cuda")
    torch.cuda.synchronize()
    run_seconds = time.perf_counter() - start
    losses = {k: float(v) / ZOO_WARMUP_STEPS
              for k, v in trainer.total_train_loss.items()}
    if not losses or not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"[ph2a] losses {losses}")
    dump = os.path.join(tmp, "eval")
    os.makedirs(dump)
    frames = ZOO_DECODE_SECONDS * 200
    rng = np.random.default_rng(seed + 10)
    for i in range(ZOO_DECODE_UTTS):
        np.save(os.path.join(dump, f"e{i}-feats.npy"),
                rng.integers(0, COND_PHONEMES, frames).astype(np.int32))
    ckpt = os.path.join(tmp, "exp", f"checkpoint-{ZOO_WARMUP_STEPS}steps.ckpt")
    before = _banded_counts()
    r = decode.decode(config, ckpt, os.path.join(tmp, "out"), dumpdir=dump,
                      device="cuda")
    launches = _banded_counts(before)
    layers = config["generator_params"]["elayers"]
    forwards = sum(launches["banded_attention"].values())
    if (launches["banded_attention_backward"] or not forwards
            or forwards % layers):
        raise AssertionError(f"[ph2a] banded attention launches {launches} "
                             f"in the decode: not a forward a layer")
    for i in range(ZOO_DECODE_UTTS):
        y = np.load(os.path.join(tmp, "out", f"e{i}_gen.npy"))
        if y.shape != (frames, 12) or not np.isfinite(y).all():
            raise AssertionError(f"[ph2a] decode e{i}: {y.shape}")
    log(f"[ph2a] Transformer on {COND_PHONEMES} phoneme ids, B "
        f"{config['batch_size']} x {config['batch_max_steps']} rows on "
        f"{device_name}: {ZOO_WARMUP_STEPS} steps through bin/train.py in "
        f"{run_seconds:.3f} s, mean losses "
        + ", ".join(f"{k.split('/')[-1]} {v:.4f}" for k, v in losses.items())
        + f"; bin/decode.py on integer ids: {ZOO_DECODE_UTTS} x "
        f"{ZOO_DECODE_SECONDS} s in {r['seconds_elapsed']:.3f} s, RTF "
        f"{r['rtf']:.6f}, banded attention launches {launches}")
    return {"run_seconds": run_seconds, "losses": losses, "decode": r,
            "decode_launches": launches}


def phase_mult(port: dict, seed: int, device_name: str) -> dict:
    """[mult] ``ar_loop(modality=1)`` on the card: an in-list callable (the
    kind of ``tests/test_multimodal.py``'s) that feeds the present
    modality's interpolated chunk to the full-width f32 HiFi-CAR (random
    weights from ``seed``), on SECONDS s of MRI-rate frames (83.3 a
    second, 13 features, each 100-frame chunk interpolated to 240); pair
    launches (36 a chunk); chunks 0, 1 and the last against the same
    callable and its interpolation on the CPU from the card run's carry
    (CHUNK_TOL f32)."""
    inference, weights = port["inference"], port["weights"]
    resblock_pair = port["resblock_pair"]
    gp = dict(GENERATOR_PARAMS, in_list=["ema", "mri"])
    config = dict(CONFIG, generator_params=gp, dataset_mode="a2w_mult",
                  hop_sizes=MULT_HOPS, sampling_rates=MULT_RATES)
    sd = weights.jax_params_to_state_dict(
        numpy_generator_params(GENERATOR_PARAMS, seed), GENERATOR_PARAMS)
    models = {}
    for dev in ("cuda", "cpu"):
        gen = port["build_model"]("HiFiGANGenerator", GENERATOR_PARAMS)
        gen.load_state_dict(sd)
        models[dev] = inference.LoadedModel(
            model=gen.to(dev).eval(), config=config, device=torch.device(dev))
        models[dev].remove_weight_norm()

    class InList:
        """The model of the present modality's entry of the list."""

        def __init__(self, loaded):
            self.loaded, self.device = loaded, loaded.device

        def __call__(self, cin_list, ar):
            return self.loaded(next(c for c in cin_list if c is not None),
                               ar=ar)

    rate = MULT_RATES[1] / MULT_HOPS[1]
    x = np.random.default_rng(seed + 11).standard_normal(
        (int(SECONDS * rate), N_FEATS)).astype(np.float32)
    card = InList(models["cuda"])
    inference.ar_loop(card, x[:CHUNK_FRAMES], config, modality=1)  # warm-up
    resblock_pair.launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    wav = inference.ar_loop(card, x, config, modality=1)
    seconds = time.perf_counter() - start
    launches = resblock_pair.launches
    n_chunks = -(-len(x) // CHUNK_FRAMES)
    scale = (CONFIG["sampling_rate"] / CONFIG["hop_size"] * MULT_HOPS[1]
             / MULT_RATES[1])
    if launches != 36 * n_chunks or not np.isfinite(wav).all():
        raise AssertionError(f"[mult] {launches} pair launches (expected "
                             f"{36 * n_chunks}) or not finite")
    cpu = InList(models["cpu"])
    ar_input, worst, pos = GENERATOR_PARAMS["ar_input"], 0.0, 0
    bounds = []
    for i in range(n_chunks):
        rows = len(x[i * CHUNK_FRAMES:(i + 1) * CHUNK_FRAMES])
        n = int(rows * scale) * CONFIG["hop_size"]
        bounds.append((pos, pos + n))
        pos += n
    if pos != len(wav):
        raise AssertionError(f"[mult] {len(wav)} samples, expected {pos}")
    checked = sorted({0, min(1, n_chunks - 1), n_chunks - 1})
    for i in checked:
        lo, hi = bounds[i]
        prev = np.zeros((1, ar_input, 1), np.float32) if i == 0 else \
            wav[None, lo - ar_input:lo, None]
        cin = torch.from_numpy(x[None, i * CHUNK_FRAMES:(i + 1) * CHUNK_FRAMES])
        ref = cpu([None, port["interpolate_linear_scale"](cin, scale)],
                  torch.from_numpy(np.ascontiguousarray(prev)))
        err = float(np.abs(ref[0, :, 0].numpy() - wav[lo:hi]).max())
        if err > CHUNK_TOL["f32"]:
            raise AssertionError(f"[mult] chunk {i}: {err:.3e} from the CPU "
                                 f"loop > {CHUNK_TOL['f32']}")
        worst = max(worst, err)
    log(f"[mult] ar_loop(modality=1): {SECONDS} s of {rate:.1f} Hz frames "
        f"(x{scale:g} to the 200 Hz grid), {n_chunks} chunks, "
        f"{len(wav)} samples in {seconds:.3f} s on {device_name}; "
        f"resblock_pair launches {launches}; chunks "
        f"{checked} against the CPU from the card's "
        f"carry: max abs err {worst:.3e} (tol {CHUNK_TOL['f32']})")
    return {"launches": launches, "chunks": n_chunks, "seconds": seconds,
            "chunk_max_abs_err": worst}


# the f32 pair's backward (csrc/resblock_pair_backward.cu): the weight
# splits, the data gradient (h and dh, then dx), the weight gradient and the
# reduction of its partial sums
PAIR_BACKWARD_KERNELS = ("pair_bwd_split_kernel", "pair_bwd_hidden_kernel",
                         "pair_bwd_input_kernel", "pair_bwd_weight_kernel",
                         "pair_bwd_reduce_kernel")
# the recipe run end to end on the port alone (phase 19): a synthetic
# corpus in the EMA recipe's layout (data/<set>/wav.scp, feats.scp of 13-d
# EMA at 200 Hz); RECIPE_TRAIN utterances of 2-5 s and RECIPE_SHORT shorter
# than the 25-frame window, RECIPE_DEV dev and eval ones
RECIPE_CONF = os.path.join(ROOT, "egs", "ema", "voc1", "conf",
                           "e2w_hifigan_car.yaml")
RECIPE_TRAIN, RECIPE_SHORT, RECIPE_DEV = 128, 3, 4
RECIPE_STEPS = 12  # stage 2 steps from the cache
RECIPE_PROFILE = [8, 9]  # profile_steps: one step, after the warm-up
RECIPE_TURNS = ("cache", "host", "native", "native", "host", "cache")
RECIPE_TURN_STEPS = 2
RECIPE_SAMPLER_STEPS = 3
RECIPE_SCRIPT_JOBS = 4  # recipe/run.sh's preprocess jobs a set
# the device split of the profiled step: the hand kernels by name; cuDNN's
# convolutions (the heads' and bf16 pairs' recompute backward among them)
# by the op that launched them
KERNEL_CLASSES = {"pair": ("resblock_pair_wgmma", "split_tf32_kernel"),
                  "head": ("scale_disc_head_wgmma", "split_weights_kernel"),
                  "pair_backward": PAIR_BACKWARD_KERNELS,
                  "banded_attention": ("banded_attn_",)}
# the profiler ranges of the kernels' recompute backward (ops/_recompute.py)
RECOMPUTE_RANGE = "recompute_grads:"


def _recipe_corpus(tmp: str, seed: int, write_wav) -> dict:
    """The synthetic corpus; returns set name -> wav directory."""
    rng = np.random.default_rng(seed)
    sr, hop = 16000, 80
    sets = {"tr": [rng.uniform(2.0, 5.0) for _ in range(RECIPE_TRAIN)]
            + [0.1] * RECIPE_SHORT,
            "dev": [rng.uniform(2.0, 4.0) for _ in range(RECIPE_DEV)],
            "eval": [rng.uniform(2.0, 4.0) for _ in range(RECIPE_DEV)]}
    wav_dirs = {}
    for name, seconds in sets.items():
        wav_dir = os.path.join(tmp, "wav", name)
        data = os.path.join(tmp, "data", name)
        os.makedirs(data)
        wavs, feats = [], []
        for i, s in enumerate(seconds):
            utt = f"{name}_{i:03d}"
            n = int(s * sr)
            t = np.arange(n) / sr
            f0 = 100 + 80 * rng.random()
            wave = (0.4 * np.sin(2 * np.pi * f0 * t * (1 + 0.1 * np.sin(t)))
                    + 0.05 * rng.standard_normal(n))
            path = os.path.join(wav_dir, f"{utt}.wav")
            write_wav(path, wave, sr)
            ema = np.cumsum(rng.standard_normal((n // hop + 1, 13)), axis=0)
            ema_path = os.path.join(data, f"{utt}.npy")
            np.save(ema_path, (0.1 * ema).astype(np.float32))
            wavs.append(f"{utt} {path}\n")
            feats.append(f"{utt} {ema_path}\n")
        with open(os.path.join(data, "wav.scp"), "w") as f:
            f.writelines(wavs)
        with open(os.path.join(data, "feats.scp"), "w") as f:
            f.writelines(feats)
        wav_dirs[name] = wav_dir
    return wav_dirs


def _endless(loader):
    """Batches of ``loader`` across epochs."""
    epoch = 0
    while True:
        loader.set_epoch(epoch)
        yield from loader
        epoch += 1


def _device_split(prof) -> dict:
    """A profiler window's device kernels: their time split into the pair,
    pair backward and head kernels (KERNEL_CLASSES), those a convolution op
    launched (its
    name holds "conv"; the profiler lists each op's kernels), and the rest;
    the busy share (the union of their intervals over their span); the
    device time under each kernel's recompute backward (``ops/_recompute.py``'s
    ranges, with the ops under them: forward and gradient convolutions,
    activations, adds), with its count; kernel counts; time per stream;
    top ops."""
    events = device_events(prof)
    split = dict.fromkeys([*KERNEL_CLASSES, "conv", "rest"], 0.0)
    counts = dict.fromkeys(
        [n for names in KERNEL_CLASSES.values() for n in names], 0)
    streams: dict = {}
    for e in events:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        cls = next((c for c, names in KERNEL_CLASSES.items()
                    if any(n in e.name for n in names)), "rest")
        split[cls] += ms
        for name in counts:
            counts[name] += name in e.name
        stream = streams.setdefault(
            str(getattr(e, "device_resource_id", None)), [0, 0.0])
        stream[0] += 1
        stream[1] += ms
    cpu_ops = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CPU]
    split["conv"] = sum(k.duration for e in cpu_ops if "conv" in e.name
                        for k in e.kernels) / 1e3
    split["rest"] -= split["conv"]
    recompute: dict = {}
    for e in cpu_ops:
        if e.name.startswith(RECOMPUTE_RANGE):
            entry = recompute.setdefault(e.name.split(":")[-1], [0, 0.0])
            entry[0] += 1
            entry[1] += _subtree_kernel_us(e) / 1e3
    busy, span = busy_span_us(events)
    return {"busy_share": busy / span, "span_ms": span / 1e3,
            "busy_ms": busy / 1e3, "kernel_ms": sum(split.values()),
            "split_ms": split, "recompute": recompute,
            "kernel_counts": counts, "streams": streams,
            "device_ops": len(events), "top_ops": top_ops(prof, 10)}


def _subtree_kernel_us(event) -> float:
    """Device µs of the kernels launched by a profiler op and the ops under
    it."""
    return (sum(k.duration for k in event.kernels)
            + sum(_subtree_kernel_us(c) for c in event.cpu_children))


def signal_after(proc, marker: str, sig, timeout: float) -> str:
    """Sends ``sig`` to ``proc`` once a line of its stderr holds ``marker``
    and returns its whole stderr when it has exited. A reader thread takes
    the lines, so a child that hangs without closing stderr cannot block
    this: past ``timeout`` seconds the child is killed and the error holds
    the tail of its stderr."""
    lines, seen = [], threading.Event()

    def read():
        for line in proc.stderr:
            lines.append(line)
            if marker in line:
                seen.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    deadline = time.monotonic() + timeout
    try:
        while not seen.wait(0.2):
            if proc.poll() is not None:
                reader.join()
                if not seen.is_set():
                    raise AssertionError(f"exit {proc.returncode} before "
                                         f"{marker!r}")
            elif time.monotonic() > deadline:
                raise AssertionError(f"no {marker!r} within {timeout} s")
        proc.send_signal(sig)
        proc.wait(max(deadline - time.monotonic(), 1.0))
    except (AssertionError, subprocess.TimeoutExpired) as e:
        proc.kill()
        proc.wait()
        reader.join()
        raise AssertionError(f"[recipe] {e}: {''.join(lines)[-2000:]}") \
            from e
    reader.join()
    return "".join(lines)


def phase_recipe(port: dict, seed: int, device_name: str, tmp: str) -> dict:
    """The EMA recipe on the port alone, from a recipe directory: stage 1
    through ``articulatory_tpu_torch/recipe/run.sh --stop_stage 1``
    (``bin/preprocess.py`` in RECIPE_SCRIPT_JOBS jobs a set through
    ``utils/run_jobs.py``, ``compute_statistics``, ``normalize``; format
    npy: the dumps and statistics checked), stage 2 in this process
    (``train()`` of e2w_hifigan_car.yaml as it stands, B 64 x 2000, from
    the corpus cache on the card, ``profile_steps`` over one step: 72 pair
    and 12 head kernels in it, its device split and busy share; the step
    timed in turns from the cache, the host loader and the native loader;
    3 steps with ``SizeAwareSampler`` and ``remove_short_samples``),
    preemption (``bin/train.py`` as a process, SIGTERM after a logged
    step: exit 0 and the checkpoint at that step, then ``--resume`` to the
    end), and stage 3 through ``run.sh --stage 3 --checkpoint`` of the
    stage-2 checkpoint (``bin/decode.py`` of the dev and eval sets: the
    wavs checked, ``bin/compute_mcd.py`` of the eval wavs finite). The
    script's stage 2 runs in the CPU test only."""
    import signal

    import yaml

    from articulatory_tpu_torch.bin import compute_mcd
    from articulatory_tpu_torch.data.device_cache import DeviceCachedBatcher
    from articulatory_tpu_torch.data.loader import DataLoader
    from articulatory_tpu_torch.data.native_loader import NativeDataLoader

    train_cli, pair, head = port["train"], port["resblock_pair"], \
        port["scale_disc_head"]
    pair_backward = port["resblock_pair_backward"]
    start_all = time.perf_counter()
    stage_s = {}
    wav_dirs = _recipe_corpus(tmp, seed, port["write_wav"])
    with open(RECIPE_CONF) as f:
        recipe = yaml.load(f, Loader=yaml.Loader)
    recipe["format"] = "npy"  # the card's machine has no h5py
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))

    # tmp laid out as a recipe directory: its data/, path.sh, egs/ema/voc1's
    # cmd.sh and utils/, and conf/ with the recipe's config
    os.makedirs(os.path.join(tmp, "conf"))
    with open(os.path.join(tmp, "conf", "recipe.yaml"), "w") as f:
        yaml.dump(recipe, f)
    with open(os.path.join(tmp, "path.sh"), "w") as f:
        f.write(f"export PYTHONPATH={ROOT}:${{PYTHONPATH:-}}\n")
    egs = os.path.join(ROOT, "egs", "ema", "voc1")
    shutil.copy(os.path.join(egs, "cmd.sh"), tmp)
    shutil.copytree(os.path.join(egs, "utils"), os.path.join(tmp, "utils"))
    script_env = dict(env, PATH=os.path.dirname(sys.executable) + os.pathsep
                      + env.get("PATH", ""))
    marks = []

    def run_script(stage: str, *args: str) -> None:
        start = time.perf_counter()
        script = subprocess.run(
            ["bash", os.path.join(ROOT, "articulatory_tpu_torch", "recipe",
                                  "run.sh"), "--conf", "conf/recipe.yaml",
             "--n_jobs", str(RECIPE_SCRIPT_JOBS), "--train_set", "tr",
             "--dev_set", "dev", "--eval_set", "eval", "--expdir",
             "exp_script", "--device", "cuda", *args],
            cwd=tmp, env=script_env, capture_output=True, text=True)
        stage_s[f"run.sh {stage}"] = time.perf_counter() - start
        if script.returncode != 0:
            raise AssertionError(f"[recipe] run.sh {stage} exit "
                                 f"{script.returncode}: "
                                 f"{script.stdout[-2000:]}"
                                 f"{script.stderr[-3000:]}")
        marks.extend(line for line in script.stdout.splitlines()
                     if line.startswith(("Stage", "Finished")))

    run_script("stage 1", "--stop_stage", "1")
    dump = os.path.join(tmp, "dump")
    stats = np.load(f"{dump}/tr/stats.npy")
    if stats.shape != (2, recipe["num_mels"]) or not np.isfinite(stats).all():
        raise AssertionError(f"[recipe] stats {stats.shape} not finite")
    n_norm = len([f for f in os.listdir(f"{dump}/tr/norm")
                  if f.endswith("-wave.npy")])
    if n_norm != RECIPE_TRAIN + RECIPE_SHORT:
        raise AssertionError(f"[recipe] {n_norm} normalised training "
                             f"utterances")
    log(f"[recipe] recipe/run.sh stage 1 (preprocess in "
        f"{RECIPE_SCRIPT_JOBS} jobs a set through utils/run_jobs.py, "
        f"statistics, normalize) in {stage_s['run.sh stage 1']:.3f} s")

    # stage 2: the recipe's training config from the corpus cache
    config = dict(recipe, train_max_steps=RECIPE_STEPS,
                  use_device_cache=True, profile_steps=RECIPE_PROFILE)
    dirs = dict(train_dumpdir=f"{dump}/tr/norm", dev_dumpdir=f"{dump}/dev/norm",
                data_root=os.path.join(tmp, "data"))
    outdir = os.path.join(tmp, "exp")
    pair.launches = head.launches = pair_backward.launches = 0
    start = time.perf_counter()
    trainer = train_cli.train(config, outdir=outdir, seed=seed,
                              device="cuda", **dirs)
    torch.cuda.synchronize()
    stage_s["train"] = time.perf_counter() - start
    launches = {"resblock_pair": pair.launches,
                "resblock_pair_backward": pair_backward.launches,
                "scale_disc_head": head.launches}
    # the generator's backward runs once its training has started
    gen_steps = RECIPE_STEPS - 1 - config["generator_train_start_steps"]
    expected = {"resblock_pair": 72 * RECIPE_STEPS,
                "resblock_pair_backward": 36 * gen_steps,
                "scale_disc_head": 12 * RECIPE_STEPS}
    if launches != expected:
        raise AssertionError(f"[recipe] launches {launches}, expected "
                             f"{expected}")
    cache = trainer.data_loader["train"]
    if not isinstance(cache, DeviceCachedBatcher):
        raise AssertionError(f"[recipe] train loader {type(cache)}")
    if cache.x.data.device.type != "cuda" or cache.art.data.device.type != \
            "cuda":
        raise AssertionError("[recipe] the cache is not on the card")
    losses = {k: float(v) for k, v in trainer.total_train_loss.items()}
    if not losses or not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"[recipe] losses not finite: {losses}")
    profiled = _device_split(trainer.profiler)
    counted = profiled["kernel_counts"]
    if (counted["resblock_pair_wgmma"], counted["pair_bwd_hidden_kernel"],
            counted["scale_disc_head_wgmma"]) != (72, 36, 12):
        raise AssertionError(f"[recipe] profiled step counted {counted}")
    split = profiled["split_ms"]
    log(f"[recipe] corpus cache: {cache.n_utts} utterances, "
        f"{cache.resident_bytes / 1e6:.1f} MB on the card; {RECIPE_STEPS} "
        f"steps in {stage_s['train']:.3f} s; launches {launches}")
    log(f"[recipe] profiled step {RECIPE_PROFILE[0]}: kernels "
        f"{profiled['kernel_ms']:.3f} ms, busy {profiled['busy_ms']:.3f} ms "
        f"of a {profiled['span_ms']:.3f} ms span "
        f"({100 * profiled['busy_share']:.1f} %, the profiler's host "
        f"overhead in it); pair kernels {split['pair']:.3f} ms, head "
        f"kernels {split['head']:.3f} ms, convolutions {split['conv']:.3f} "
        f"ms, pair backward kernels {split['pair_backward']:.3f} ms, rest "
        f"{split['rest']:.3f} ms; {counted['resblock_pair_wgmma']} pairs, "
        f"{counted['pair_bwd_hidden_kernel']} pair backwards, "
        f"{counted['scale_disc_head_wgmma']} heads; (kernels, ms) a stream "
        + ", ".join(f"{k}: {n} {ms:.3f}"
                    for k, (n, ms) in profiled["streams"].items()))
    for op in profiled["top_ops"]:
        log(f"[recipe]   {op['ms']:9.3f} ms {op['calls']:5d} x {op['name']}")
    # one backward for each pass with grad: the 36 generator pairs on their
    # backward kernels, nothing recomputed; 3 scales' heads recomputed in
    # the generator loss's fake pass and in the discriminator's real and
    # fake passes (the feature-matching real pass has no grad)
    recompute = profiled["recompute"]
    if {k: n for k, (n, _) in recompute.items()} != {
            "scale_disc_head_plain": 9}:
        raise AssertionError(f"[recipe] recompute ranges {recompute}")
    log("[recipe] recompute backward in the profiled step (device ms of "
        "the kernels under its ranges): " + ", ".join(
            f"{k} {n} x, {ms:.3f} ms" for k, (n, ms) in recompute.items()))

    # the step from each loader in turns
    train_set, _, collater, _ = train_cli.build_datasets(
        config, dirs["train_dumpdir"], dirs["dev_dumpdir"], dirs["data_root"])
    gp = config["generator_params"]
    ar_len = int(gp["ar_input"] / gp["out_channels"])
    loaders = {
        "cache": _endless(cache),
        "host": _endless(DataLoader(
            train_set, batch_size=config["batch_size"], shuffle=True,
            collate_fn=collater, drop_last=True,
            num_workers=config["num_workers"], seed=seed)),
        "native": _endless(NativeDataLoader(
            train_set, batch_size=config["batch_size"],
            batch_max_steps=config["batch_max_steps"],
            hop_size=config["hop_size"], ar_len=ar_len, seed=seed,
            n_threads=4))}
    lr = config["generator_optimizer_params"]["lr"]
    step_ms = {name: [] for name in loaders}
    for name in ("cache", "host", "native"):  # one untimed step each
        trainer.train_step(trainer.state, port["to_device"](
            next(loaders[name]), trainer.device), lr, lr)
    for name in RECIPE_TURNS:
        for _ in range(RECIPE_TURN_STEPS):
            torch.cuda.synchronize()
            start = time.perf_counter()
            trainer.train_step(trainer.state, port["to_device"](
                next(loaders[name]), trainer.device), lr, lr)
            torch.cuda.synchronize()
            step_ms[name].append(1e3 * (time.perf_counter() - start))
    medians = {k: float(np.median(v)) for k, v in step_ms.items()}
    log("[recipe] step median (loading included) over "
        f"{2 * RECIPE_TURN_STEPS} steps in turns: "
        + ", ".join(f"{k} {v:.3f} ms [{min(step_ms[k]):.3f}, "
                    f"{max(step_ms[k]):.3f}]" for k, v in medians.items())
        + f"; the profiled step's busy device time is "
        f"{100 * profiled['busy_ms'] / medians['cache']:.1f} % of the "
        f"cache's median")

    # the size-aware sampler with the short utterances removed
    start = time.perf_counter()
    mean_len = np.mean([len(train_set[i]["audio"])
                        for i in range(len(train_set))])
    sampler_config = dict(
        recipe, train_max_steps=RECIPE_SAMPLER_STEPS,
        batch_sampler_type="SizeAwareSampler",
        batch_sampler_params={"max_len": int(config["batch_size"]
                                             * mean_len)},
        remove_short_samples=True)
    pair.launches = head.launches = 0
    sampled = train_cli.train(sampler_config,
                              outdir=os.path.join(tmp, "exp_sampler"),
                              seed=seed, device="cuda", **dirs)
    torch.cuda.synchronize()
    dropped = RECIPE_TRAIN + RECIPE_SHORT - len(
        sampled.data_loader["train"].dataset)
    sampler_launches = pair.launches
    sizes = [len(b) for b in sampled.data_loader["train"].batch_sampler]
    if dropped != RECIPE_SHORT or sampler_launches != 72 * \
            RECIPE_SAMPLER_STEPS:
        raise AssertionError(f"[recipe] sampler run dropped {dropped}, "
                             f"{sampler_launches} pair launches")
    log(f"[recipe] SizeAwareSampler + remove_short_samples: "
        f"{RECIPE_SAMPLER_STEPS} steps in "
        f"{time.perf_counter() - start:.3f} s, {dropped} short utterances "
        f"dropped, batch sizes {min(sizes)}-{max(sizes)} over "
        f"{len(sizes)} batches")

    # preemption: bin/train.py as a process, SIGTERM after a logged step
    start = time.perf_counter()
    pre_conf = os.path.join(tmp, "conf_preempt.yaml")
    with open(pre_conf, "w") as f:
        yaml.dump(dict(recipe, use_device_cache=True, log_interval_steps=1,
                       train_max_steps=100000), f)
    pre_out = os.path.join(tmp, "exp_preempt")
    proc = subprocess.Popen(
        [sys.executable, "-m", "articulatory_tpu_torch.bin.train",
         "--train-dumpdir", dirs["train_dumpdir"], "--dev-dumpdir",
         dirs["dev_dumpdir"], "--data-root", dirs["data_root"], "--outdir",
         pre_out, "--config", pre_conf, "--seed", str(seed)],
        env=env, cwd=ROOT, stderr=subprocess.PIPE, text=True)
    rest = signal_after(proc, "(Steps: 2)", signal.SIGTERM, 300.0)
    ckpts = [f for f in os.listdir(pre_out) if f.startswith("checkpoint-")]
    if proc.returncode != 0 or len(ckpts) != 1:
        raise AssertionError(f"[recipe] preempted run exit "
                             f"{proc.returncode}, checkpoints {ckpts}: "
                             f"{rest[-2000:]}")
    stopped = port["load_checkpoint"](os.path.join(pre_out, ckpts[0]))["steps"]
    if ckpts[0] != f"checkpoint-{stopped}steps.ckpt" or stopped < 2:
        raise AssertionError(f"[recipe] {ckpts[0]} holds step {stopped}")
    resumed = train_cli.train(
        dict(recipe, use_device_cache=True, train_max_steps=stopped + 2),
        outdir=pre_out, seed=seed, device="cuda",
        resume=os.path.join(pre_out, ckpts[0]), **dirs)
    if resumed.steps != stopped + 2 or not os.path.exists(os.path.join(
            pre_out, f"checkpoint-{stopped + 2}steps.ckpt")):
        raise AssertionError(f"[recipe] resume ended at {resumed.steps}")
    preempt_s = time.perf_counter() - start
    log(f"[recipe] SIGTERM after step 2 logged: exit 0, {ckpts[0]}; "
        f"resumed to step {resumed.steps} ({preempt_s:.3f} s with the "
        f"process)")

    # stage 3 through the recipe script, of stage 2's checkpoint; the
    # eval set's wavs scored
    ckpt = f"checkpoint-{RECIPE_STEPS}steps.ckpt"
    run_script("stage 3", "--stage", "3", "--checkpoint",
               os.path.join(outdir, ckpt))
    gen_root = os.path.join(tmp, "exp_script", "wav", ckpt)
    for name in ("dev", "eval"):
        for i in range(RECIPE_DEV):
            y, _ = port["read_wav"](os.path.join(gen_root, name,
                                                 f"{name}_{i:03d}_gen.wav"))
            if not len(y) or not np.isfinite(y).all():
                raise AssertionError(f"[recipe] run.sh decoded {name}_{i:03d}"
                                     f" to {y.shape}, not finite")
    log(f"[recipe] recipe/run.sh stage 3 (bin/decode.py of the dev and "
        f"eval sets from {ckpt}) in {stage_s['run.sh stage 3']:.3f} s; "
        + "; ".join(marks))
    start = time.perf_counter()
    mcds = compute_mcd.compute_mcd(os.path.join(gen_root, "eval"),
                                   wav_dirs["eval"])
    stage_s["compute_mcd"] = time.perf_counter() - start
    if len(mcds) != RECIPE_DEV or not all(np.isfinite(v)
                                          for v in mcds.values()):
        raise AssertionError(f"[recipe] MCD {mcds}")
    total_s = time.perf_counter() - start_all
    log(f"[recipe] eval MCD (random weights) mean "
        f"{np.mean(list(mcds.values())):.3f} dB over {len(mcds)}; stages "
        + ", ".join(f"{k} {v:.3f} s" for k, v in stage_s.items())
        + f"; phase {total_s:.3f} s")
    return {"stage_s": stage_s, "phase_s": total_s, "launches": launches,
            "cache_mb": cache.resident_bytes / 1e6,
            "cache_utts": cache.n_utts, "profiled_step": profiled,
            "step_ms": step_ms,
            "step_ms_median": medians, "sampler_dropped": dropped,
            "sampler_batch_sizes": sizes,
            "sampler_launches": sampler_launches,
            "preempt_step": stopped, "preempt_s": preempt_s, "mcd": mcds,
            "mean_losses": {k: v / RECIPE_STEPS for k, v in losses.items()}}


# the entry points at e2w_hifigan_car.yaml's full width (phase 21): a JAX
# msgpack checkpoint of GENERATOR_PARAMS; ENTRY_UTTS utterances of
# ENTRY_FRAMES frames (3 chunks each) for predict_wav and the decode CLI;
# model_stats over ENTRY_LENGTHS frames, ENTRY_ITERS forwards each
ENTRY_UTTS, ENTRY_FRAMES = 2, 300
ENTRY_LENGTHS = [100, 200, 400, 800]
ENTRY_ITERS = 5


def checked_pair(kernel, plain, errs: dict):
    """The pair as ``kernel`` computes it, each call also computed by
    ``plain`` on the same inputs; the largest error of max |y| of each
    (dtype, shape) goes into ``errs``."""
    def pair(x, *args, **kwargs):
        y = kernel(x, *args, **kwargs)
        ref = plain(x, *args, **kwargs).float()
        err = ((y.float() - ref).abs().max() / ref.abs().max()).item()
        key = (x.dtype, tuple(x.shape))
        errs[key] = max(errs.get(key, 0.0), err)
        return y
    return pair


def phase_entry(port: dict, seed: int, device_name: str, tmp: str) -> dict:
    """[entry] The entry points at full width, in f32 and hybrid:
    ``bin/predict_wav.py`` on an ENTRY_UTTS-utterance npy feats.scp of a
    JAX msgpack checkpoint (36 pair launches a chunk; its wavs equal to
    ``bin/decode.py``'s eager ones), ``bin/model_stats.py`` over
    ENTRY_LENGTHS (latency, RTF; 36 pairs a forward), and
    ``bin/convert_checkpoint.py --to-torch``, whose pickle decodes bit-equal
    to the msgpack on the card (36 pairs a chunk). model_stats' shapes (B
    1, up to T 64,000) are held against the plain pair twice: each pair
    call of a second model_stats run against the plain pair on its inputs
    (KERNEL_TOL of max |y|), and the checkpoint's forward of random
    features at the longest length against the same forward on plain pairs
    (CHUNK_TOL)."""
    import yaml

    inference, pair, plain, residual, read_wav = (
        port[k] for k in ("inference", "resblock_pair", "plain", "residual",
                          "read_wav"))
    gp = GENERATOR_PARAMS
    exp = os.path.join(tmp, "exp")
    os.makedirs(exp)
    ckpt = os.path.join(exp, "ckpt.pkl")
    port["save_msgpack"](ckpt, {
        "model": {"generator": numpy_generator_params(gp, seed)},
        "steps": 0, "epochs": 0})
    with open(os.path.join(exp, "config.yml"), "w") as f:
        yaml.dump(CONFIG, f)
    rng = np.random.default_rng(seed + 21)
    scp = os.path.join(tmp, "feats.scp")
    with open(scp, "w") as f:
        for n in range(ENTRY_UTTS):
            path = os.path.join(tmp, f"utt{n}.npy")
            np.save(path, rng.standard_normal((ENTRY_FRAMES, N_FEATS)
                                              ).astype(np.float32))
            f.write(f"utt{n} {path}\n")
    chunks = -(-ENTRY_FRAMES // CHUNK_FRAMES)
    modes = {"f32": CONFIG, "hybrid_bf16": dict(CONFIG, generator_params=dict(
        gp, compute_dtype="bfloat16", hybrid_precision=True))}
    results = {}
    for mode, config in modes.items():
        out_p, out_d = (os.path.join(tmp, f"{name}_{mode}")
                        for name in ("predict", "decode"))
        pair.launches = 0
        start = time.perf_counter()
        written = port["predict_wav"].predict_wav(scp, out_p, ckpt,
                                                  dict(config), device="cuda")
        seconds = time.perf_counter() - start
        launches = pair.launches
        if written != [f"utt{n}" for n in range(ENTRY_UTTS)] or \
                launches != 36 * chunks * ENTRY_UTTS:
            raise AssertionError(f"[entry] {mode} predict_wav wrote "
                                 f"{written}, {launches} pair launches, "
                                 f"expected {36 * chunks * ENTRY_UTTS}")
        port["decode"].decode(config, ckpt, out_d, feats_scp=scp,
                              device="cuda")
        for fid in written:
            got, sr = read_wav(os.path.join(out_p, f"{fid}.wav"))
            want, _ = read_wav(os.path.join(out_d, f"{fid}_gen.wav"))
            if got.shape != (ENTRY_FRAMES * CONFIG["hop_size"],) or \
                    not np.array_equal(got, want):
                raise AssertionError(f"[entry] {mode} predict_wav {fid}: "
                                     f"{got.shape}, not decode's eager wav")
        log(f"[entry] {mode} bin/predict_wav.py: {len(written)} x "
            f"{ENTRY_FRAMES} frames in {seconds:.3f} s (load included), "
            f"{launches} pair launches ({chunks} chunks each), wavs equal "
            f"to bin/decode.py's eager ones")
        pair.launches = 0
        stats = port["model_stats"].model_stats(config, ENTRY_LENGTHS,
                                                ENTRY_ITERS, 1, "cuda")
        stats_launches = pair.launches
        if stats_launches != 36 * len(ENTRY_LENGTHS) * (ENTRY_ITERS + 1):
            raise AssertionError(f"[entry] {mode} model_stats: "
                                 f"{stats_launches} pair launches")
        log(f"[entry] {mode} bin/model_stats.py on {device_name}: "
            f"{stats['params']:,} parameters; " + ", ".join(
                f"{r['frames']} frames {r['latency_ms']:.3f} ms (RTF "
                f"{r['rtf']:.6f})" for r in stats["lengths"])
            + f"; {stats_launches} pair launches")
        results[mode] = {"predict_seconds": seconds,
                         "predict_launches": launches, "model_stats": stats,
                         "model_stats_launches": stats_launches}
        results[mode].update(_entry_pair_checks(
            port, config, ckpt, mode, np.random.default_rng(seed + 23)))

    pkl = os.path.join(tmp, "export", "ckpt.pkl")
    port["convert_checkpoint"].main(["--to-torch", "--checkpoint", ckpt,
                                     "--out", pkl])
    x = np.load(os.path.join(tmp, "utt0.npy"))
    outs = {}
    pair.launches = 0
    for name, path in (("msgpack", ckpt), ("pickle", pkl)):
        model = inference.load_model(path, CONFIG, device="cuda")
        model.remove_weight_norm()
        outs[name] = inference.ar_loop(model, x, CONFIG)
    convert_launches = pair.launches
    if not np.array_equal(outs["msgpack"], outs["pickle"]) or \
            convert_launches != 2 * 36 * chunks:
        raise AssertionError(f"[entry] the converted pickle decodes "
                             f"{np.abs(outs['msgpack'] - outs['pickle']).max()}"
                             f" from the msgpack; {convert_launches} pair "
                             f"launches")
    log(f"[entry] bin/convert_checkpoint.py --to-torch: the pickle decodes "
        f"bit-equal to the msgpack ({convert_launches} pair launches)")
    results["convert_launches"] = convert_launches
    return results


def _entry_pair_checks(port: dict, config: dict, ckpt: str, mode: str,
                       rng) -> dict:
    """model_stats' pair shapes against the plain pair (see
    ``phase_entry``)."""
    inference, pair, plain, residual = (port[k] for k in (
        "inference", "resblock_pair", "plain", "residual"))
    errs = {}
    with swapped(residual, "resblock_pair", checked_pair(pair, plain, errs)):
        port["model_stats"].model_stats(config, ENTRY_LENGTHS, 1, 1, "cuda")
    worst = {}
    for (dtype, shape), err in errs.items():
        if not err <= KERNEL_TOL[dtype]:  # NaN fails too
            raise AssertionError(f"[entry] {mode} model_stats pair {dtype} "
                                 f"{shape}: {err:.3e} of max |y| from the "
                                 f"plain pair > {KERNEL_TOL[dtype]}")
        name = str(dtype).replace("torch.", "")
        worst[name] = max(worst.get(name, 0.0), err)
    lengths = sorted({shape[1] for _, shape in errs})
    model = inference.load_model(ckpt, config, device="cuda")
    model.remove_weight_norm()
    gp = config["generator_params"]
    frames = max(ENTRY_LENGTHS)
    c = torch.from_numpy(rng.standard_normal((1, frames, N_FEATS)).astype(
        np.float32)).cuda()
    prev = torch.from_numpy(0.5 * rng.standard_normal(
        (1, gp["ar_input"], 1)).astype(np.float32)).cuda()
    y = model(c, ar=prev).float()
    with swapped(residual, "resblock_pair", plain):
        ref = model(c, ar=prev).float()
    forward_err = (y - ref).abs().max().item()
    if not torch.isfinite(y).all() or not forward_err <= CHUNK_TOL[mode]:
        raise AssertionError(f"[entry] {mode} forward of {frames} frames: "
                             f"max abs error {forward_err:.3e} against the "
                             f"plain pairs > {CHUNK_TOL[mode]}")
    log(f"[entry] {mode} model_stats' pairs against the plain pair on their "
        f"inputs: {len(errs)} shapes (B 1, T {lengths[0]}-{lengths[-1]}), "
        "largest error of max |y| " + ", ".join(
            f"{k} {v:.3e} (limit {KERNEL_TOL[getattr(torch, k)]})"
            for k, v in worst.items())
        + f"; a {frames}-frame forward of random features against plain "
        f"pairs: max abs {forward_err:.3e} (limit {CHUNK_TOL[mode]})")
    return {"model_stats_pair_rel_err": worst,
            "forward_plain_abs_err": forward_err}


# int8 and bf16 weight storage of the zoo (phase 22): each family of
# zoo_configs at full width, STORAGE_BATCH x STORAGE_SECONDS s a forward,
# STORAGE_ROUNDS forwards timed; a stored model against its float32 twin
# (the same effective weights in float32), of max |y|
STORAGE_BATCH, STORAGE_SECONDS, STORAGE_ROUNDS = 4, 10, 3
STORAGE_TOL = 1e-4


def storage_twin(model, twin) -> None:
    """Give ``twin`` (the same architecture, float32 weights) the weights
    ``model`` computes with: each conv's effective kernel and each layer's
    weights as stored, dequantized or upcast to float32; then freeze it."""
    from articulatory_tpu_torch.layers.conv import _Conv, _Stored

    with torch.no_grad():
        for a, b in zip(model.modules(), twin.modules()):
            if isinstance(a, _Conv):
                w = a.torch_weight().float()
                if b.use_weight_norm:
                    b.weight_v.copy_(w)
                    b.weight_g.copy_(w.square().sum(
                        dim=tuple(range(1, w.dim())), keepdim=True).sqrt())
                else:
                    b.weight.copy_(w)
                if a.bias is not None:
                    b.bias.copy_(a.bias.float())
                continue
            for name, p in b.named_parameters(recurse=False):
                p.copy_(a.weight_as(name, torch.float32)
                        if isinstance(a, _Stored) else getattr(a, name))
    twin.remove_weight_norm()


def _storage_rate(fn, samples: int) -> float:
    """Samples/s of STORAGE_ROUNDS calls of ``fn``, by CUDA events."""
    fn()
    begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    begin.record()
    for _ in range(STORAGE_ROUNDS):
        fn()
    end.record()
    end.synchronize()
    return samples * STORAGE_ROUNDS / (begin.elapsed_time(end) / 1e3)


def phase_storage_zoo(port: dict, seed: int, device_name: str,
                      tmp: str) -> dict:
    """[storage-zoo] int8 and bf16 weights (``LoadedModel.quantize_int8``,
    ``to_bf16_weights``) for every family of the zoo at full width and for
    the AR BiGRU of [w2a-ar] through the graph loop (``ar_loop_scan``):
    each stored model's output against its float32 twin's on plain pairs
    (STORAGE_TOL of max |y|), samples/s of f32, int8 and bf16 storage in
    turns; 27 pair launches a multi-band forward."""
    inference, pair = port["inference"], port["resblock_pair"]
    results = {}
    rng = np.random.default_rng(seed + 22)
    frames = STORAGE_SECONDS * 200
    for family, config in zoo_configs().items():
        gen = port["build_model"](config["generator_type"],
                                  config["generator_params"], seed=seed)
        ckpt = os.path.join(tmp, f"{family}.pth")
        torch.save({"model": {"generator": gen.state_dict()}}, ckpt)
        pad = 2 * getattr(gen, "aux_context_window", 0)
        x = torch.from_numpy(rng.standard_normal(
            (STORAGE_BATCH, frames + pad, 13)).astype(np.float32)).cuda()
        z = _zoo_noise(gen, x)
        models, outs, rates, launches = {}, {}, {}, {}
        for kind in ("f32", "int8", "bf16"):
            model = inference.load_model(ckpt, config, device="cuda")
            model.remove_weight_norm()
            if kind == "int8":
                model.quantize_int8()
            elif kind == "bf16":
                model.to_bf16_weights()
            models[kind] = model
            pair.launches = 0
            with torch.inference_mode():
                outs[kind] = _zoo_forward(model.model, x, z).float()
            launches[kind] = pair.launches
            if family == "mb-hifigan" and pair.launches != 27:
                raise AssertionError(f"[storage-zoo] {family} {kind}: "
                                     f"{pair.launches} pair launches a "
                                     f"forward, expected 27")
        errs = {}
        for kind in ("int8", "bf16"):
            twin = inference.load_model(ckpt, config, device="cuda")
            storage_twin(models[kind].model, twin.model)
            with torch.inference_mode(), swapped(
                    port["residual"], "resblock_pair", port["plain"]):
                want = _zoo_forward(twin.model, x, z).float()
            errs[kind] = ((outs[kind] - want).abs().max()
                          / want.abs().max()).item()
            if not torch.isfinite(outs[kind]).all() or \
                    errs[kind] > STORAGE_TOL:
                raise AssertionError(f"[storage-zoo] {family} {kind}: "
                                     f"{errs[kind]:.3e} of max |y| from its "
                                     f"float32 twin (limit {STORAGE_TOL})")
        samples = STORAGE_BATCH * STORAGE_SECONDS * 16000
        with torch.inference_mode():
            for kind in ("f32", "int8", "bf16", "bf16", "int8", "f32"):
                rate = _storage_rate(lambda: _zoo_forward(
                    models[kind].model, x, z), samples)
                rates.setdefault(kind, []).append(rate)
        rates = {k: float(np.median(v)) for k, v in rates.items()}
        log(f"[storage-zoo] {family}: B {STORAGE_BATCH} x {STORAGE_SECONDS} "
            f"s on {device_name}, samples/s of 16 kHz audio " + ", ".join(
                f"{k} {v:.1f}" for k, v in rates.items())
            + "; against the float32 twin " + ", ".join(
                f"{k} {v:.3e}" for k, v in errs.items())
            + f" of max |y| (limit {STORAGE_TOL})")
        results[family] = {"samples_per_s": rates, "twin_rel_err": errs,
                           "pair_launches": launches}

    # the AR BiGRU through the graph loop
    gp = dict(W2A_AR_GP, in_channels=13 + W2A_AR_GP["ar_output"])
    config = dict(W2A_CONFIG, generator_params=gp)
    ckpt = bigru_checkpoint(port, gp, seed, os.path.join(tmp, "bigru.pth"))
    one = rng.standard_normal((frames, 13)).astype(np.float32)
    outs, rtf, errs = {}, {}, {}
    for kind in ("f32", "int8", "bf16"):
        model = inference.load_model(ckpt, config, device="cuda")
        if kind == "int8":
            model.quantize_int8()
        elif kind == "bf16":
            model.to_bf16_weights()
        outs[kind] = inference.ar_loop_scan(model, one, config)  # captures
        start = time.perf_counter()
        again = inference.ar_loop_scan(model, one, config)
        rtf[kind] = (time.perf_counter() - start) / STORAGE_SECONDS
        if kind != "f32":
            twin = inference.load_model(ckpt, config, device="cuda")
            storage_twin(model.model, twin.model)
            want = inference.ar_loop_scan(twin, one, config)
            errs[kind] = float(np.abs(outs[kind] - want).max()
                               / np.abs(want).max())
            if errs[kind] > STORAGE_TOL or not np.array_equal(again,
                                                              outs[kind]):
                raise AssertionError(f"[storage-zoo] bigru-ar {kind}: "
                                     f"{errs[kind]:.3e} of max |y| from its "
                                     f"float32 twin, or replays differ")
    log(f"[storage-zoo] bigru-ar (graph loop, one {STORAGE_SECONDS} s "
        f"stream): RTF " + ", ".join(f"{k} {v:.6f}" for k, v in rtf.items())
        + "; against the float32 twin " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items()))
    results["bigru-ar"] = {"rtf": rtf, "twin_rel_err": errs}
    return results


def causal_configs() -> dict:
    """[causal] e2w_hifigan.yaml's MelGAN and Parallel WaveGAN of
    ``zoo_configs`` with causal convs."""
    zoo = zoo_configs()
    return {f"causal-{family}": dict(zoo[family], generator_params=dict(
        zoo[family]["generator_params"], use_causal_conv=True))
        for family in ("melgan", "pwg")}


# the _h2 inversion (phase 24): facebook/hubert-large-ll60k's published
# config (24 layers, 1024 wide, 16 heads, FFN 4096, the layer-normed conv
# feature extractor), random weights from the seed (no download); 50 hidden
# states a second (a 320-sample hop at 16 kHz), interpolated x4 to the 200
# Hz EMA rate (x2 for hprc), into the AR BiGRU of [w2a-ar]
SSL_WIDTH, SSL_STATE_RATE = 1024, 50
HUBERT_LARGE = dict(
    hidden_size=SSL_WIDTH, num_hidden_layers=24, num_attention_heads=16,
    intermediate_size=4096, feat_extract_norm="layer",
    do_stable_layer_norm=True, conv_bias=True, conv_dim=[512] * 7,
    conv_kernel=[10, 3, 3, 3, 3, 2, 2], conv_stride=[5, 2, 2, 2, 2, 2, 2],
    num_conv_pos_embeddings=128, num_conv_pos_embedding_groups=16)
SSL_FEATURE_TOL = 1e-6  # the card's interpolation against the CPU's
SSL_HUBERT_TOL = 1e-4  # the card's HuBERT forward against the CPU's, of max
SSL_WAVS, SSL_WAV_SECONDS = 2, 4  # bin/predict_ema.py's input


def phase_ssl(port: dict, seed: int, device_name: str, tmp: str) -> dict:
    """[ssl] The ``_h2`` inversion at SSL_WIDTH: random
    ``last_hidden_state``s of STORAGE_SECONDS s interpolated on the card
    (``bin/predict_ema.py::interpolate_states``, x4 and x2) against the
    CPU's, then through the AR BiGRU's ``ar_loop`` (eager) and
    ``ar_loop_scan`` (graph): bit-equal, and each chunk against the CPU
    model's forward from the card's carry (W2A_F64_TOL of max |y|); a
    HuBERT of hubert-large-ll60k's config with random weights, saved and
    loaded through ``ARTICULATORY_HUBERT_MODEL``: its hidden states on the
    card against the CPU's (SSL_HUBERT_TOL of max |h|), and
    ``bin/predict_ema.py`` on SSL_WAVS wavs of an ``_h2`` experiment,
    eager and ``--ar-scan``, against each other and the BiGRU on its
    features (W2A_F64_TOL of max |y|; each computes HuBERT afresh)."""
    import yaml
    from transformers import HubertConfig, HubertModel

    inference, predict_ema = port["inference"], port["predict_ema"]
    gp = dict(W2A_AR_GP, in_channels=SSL_WIDTH + W2A_AR_GP["ar_output"])
    config = dict(W2A_CONFIG, generator_params=gp)
    exp = os.path.join(tmp, "exp", "mngu0_w2a_h2")
    os.makedirs(exp)
    ckpt = bigru_checkpoint(port, gp, seed,
                            os.path.join(exp, "best_mel_ckpt.pkl"))
    with open(os.path.join(exp, "config.yml"), "w") as f:
        yaml.dump(config, f)
    rng = np.random.default_rng(seed + 24)
    states = torch.from_numpy(rng.standard_normal(
        (1, STORAGE_SECONDS * SSL_STATE_RATE, SSL_WIDTH)).astype(
            np.float32)).cuda()
    feat_errs = {}
    for factor in (4, 2):
        got = predict_ema.interpolate_states(states, factor)
        want = predict_ema.interpolate_states(states.cpu(), factor)
        feat_errs[factor] = (got.cpu() - want).abs().max().item()
        if got.shape != (states.shape[1] * factor, SSL_WIDTH) or \
                feat_errs[factor] > SSL_FEATURE_TOL:
            raise AssertionError(f"[ssl] x{factor} features {got.shape}, "
                                 f"{feat_errs[factor]:.3e} from the CPU's")
    feats = predict_ema.interpolate_states(states, 4).cpu().numpy()
    model = inference.load_model(ckpt, config, device="cuda")
    times, outs = run_turns({
        "eager": lambda: inference.ar_loop(model, feats, config),
        "graph": lambda: inference.ar_loop_scan(model, feats, config)},
        TURNS[:4])
    if not np.array_equal(outs["graph"], outs["eager"]):
        raise AssertionError("[ssl] the graph loop differs from the eager "
                             "one")
    y = outs["eager"]
    cpu = inference.load_model(ckpt, config, device="cpu")
    ck = inference.chunking(config)
    worst = 0.0
    for start in range(0, len(y), ck.in_chunk_len):
        rows = y[start:start + ck.in_chunk_len]
        prev = (y[None, start - ck.past_out_len:start] if start else
                np.zeros((1, ck.past_out_len, gp["out_channels"]),
                         np.float32))
        out = cpu(feats[None, start:start + len(rows)], prev)[0].numpy()
        worst = max(worst, float(np.abs(out - rows).max()))
    err = worst / float(np.abs(y).max())
    if y.shape != (len(feats), gp["out_channels"]) or err > W2A_F64_TOL:
        raise AssertionError(f"[ssl] {y.shape}; chunks {err:.3e} of max |y| "
                             f"from the CPU's (limit {W2A_F64_TOL})")
    rtf = {k: float(np.median(v)) / STORAGE_SECONDS for k, v in times.items()}
    log(f"[ssl] {SSL_WIDTH}-wide hidden states of {STORAGE_SECONDS} s on "
        f"{device_name}: interpolated x4 / x2 on the card, "
        f"{feat_errs[4]:.3e} / {feat_errs[2]:.3e} from the CPU's; the AR "
        f"BiGRU, eager and graph bit-equal, RTF eager {rtf['eager']:.6f}, "
        f"graph {rtf['graph']:.6f}; chunks {err:.3e} of max |y| from the "
        f"CPU's under the card's carry (limit {W2A_F64_TOL})")

    # the HuBERT forward: hubert-large-ll60k's config, random weights
    start = time.perf_counter()
    torch.manual_seed(seed)
    hubert_dir = os.path.join(tmp, "hubert")
    HubertModel(HubertConfig(**HUBERT_LARGE)).save_pretrained(hubert_dir)
    os.environ["ARTICULATORY_HUBERT_MODEL"] = hubert_dir
    predict_ema._HUBERT = None
    wav_dir = os.path.join(tmp, "wavs")
    n = SSL_WAV_SECONDS * 16000
    for i in range(SSL_WAVS):
        port["write_wav"](os.path.join(wav_dir, f"utt{i}.wav"),
                          0.1 * rng.standard_normal(n + 320 * i), 16000)
    audio, _ = port["read_wav"](os.path.join(wav_dir, "utt0.wav"))
    torch.cuda.synchronize()
    begin = time.perf_counter()
    card = predict_ema.hubert_states(audio, "cuda")
    torch.cuda.synchronize()
    hubert_s = time.perf_counter() - begin
    card = card.cpu()
    host = predict_ema.hubert_states(audio, "cpu")
    hubert_err = ((card - host).abs().max() / host.abs().max()).item()
    if card.shape != (1, SSL_WAV_SECONDS * SSL_STATE_RATE - 1, SSL_WIDTH) \
            or hubert_err > SSL_HUBERT_TOL:
        raise AssertionError(f"[ssl] HuBERT states {tuple(card.shape)}, "
                             f"{hubert_err:.3e} of max |h| from the CPU's "
                             f"(limit {SSL_HUBERT_TOL})")
    predicted = {}
    for name, ar_scan in (("eager", False), ("graph", True)):
        out_dir = os.path.join(tmp, f"pred_{name}")
        written = predict_ema.predict(exp, wav_dir, out_dir,
                                      ar_scan=ar_scan, device="cuda")
        predicted[name] = [np.load(os.path.join(out_dir, f"{fid}.npy"))
                           for fid in written]
    direct = inference.ar_loop(model, predict_ema.hubert_features(
        audio, 4, "cuda"), config)
    # each run computes its HuBERT features afresh
    gaps = [float(np.abs(a - b).max() / np.abs(b).max())
            for a, b in (*zip(*predicted.values()),
                         (predicted["eager"][0], direct))]
    if max(gaps) > W2A_F64_TOL or not all(
            np.isfinite(a).all() for a in predicted["eager"]):
        raise AssertionError(f"[ssl] predict_ema --ar-scan against eager and "
                             f"eager against the BiGRU on its features: "
                             f"{gaps} of max |y| (limit {W2A_F64_TOL}), or "
                             f"not finite")
    del os.environ["ARTICULATORY_HUBERT_MODEL"]
    log(f"[ssl] HuBERT (hubert-large-ll60k's config, random weights, saved "
        f"and loaded through ARTICULATORY_HUBERT_MODEL) on {device_name}: "
        f"{SSL_WAV_SECONDS} s in {1e3 * hubert_s:.3f} ms, states "
        f"{hubert_err:.3e} of max |h| from the CPU's (limit "
        f"{SSL_HUBERT_TOL}); bin/predict_ema.py on {SSL_WAVS} wavs of an "
        f"_h2 experiment: {[a.shape for a in predicted['eager']]}, "
        f"--ar-scan {gaps[0]:.3e} / {gaps[1]:.3e} of max |y| from eager, "
        f"eager {gaps[2]:.3e} from the BiGRU on its features (limit "
        f"{W2A_F64_TOL}); "
        f"{time.perf_counter() - start:.3f} s with the model's build")
    return {"feature_err": feat_errs, "rtf": rtf, "chunk_rel_err": err,
            "hubert_ms": 1e3 * hubert_s, "hubert_rel_err": hubert_err}

# [dp] / [dp-native] / [tp]: data and tensor parallelism through the
# launcher and the train CLI, two ranks sharing the card (gloo: NCCL
# refuses two ranks on one device), at TRAIN_CONFIG's widths on phase 6's
# corpus; PAR_BATCH is a data-parallel rank's (dp: the global batch is the
# single-process shape, 64; tp: one TP group of both ranks shares B 16);
# dp-native is dp with use_native_loader (each rank its shard of the
# native loader)
PAR_STEPS = {"dp": 3, "dp-native": 3, "tp": 2}
PAR_BATCH = {"dp": 32, "dp-native": 32, "tp": 16}
PAR_GRAD_STEP = 1  # the step whose all-reduced gradients are checked
PAR_TIMEOUT_S = 600


def parallel_config(mode: str) -> dict:
    # both models update from step 0, so step PAR_GRAD_STEP reduces both
    return dict(TRAIN_CONFIG, batch_size=PAR_BATCH[mode],
                train_max_steps=PAR_STEPS[mode],
                generator_train_start_steps=0,
                eval_interval_steps=PAR_STEPS[mode],
                num_save_intermediate_results=0,
                use_native_loader=mode == "dp-native",
                tensor_parallel=2 if mode == "tp" else 1)


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _batch_digest(batch: dict) -> str:
    """The digest of a batch's step inputs: y, x, and the AR past."""
    return _digest([torch.as_tensor(batch["y"]), *map(
        torch.as_tensor, batch["x"])] + ([torch.as_tensor(batch["ar"])]
                                         if batch.get("ar") is not None
                                         else []))


def native_digests(port: dict, config: dict, dirs: dict, seed: int,
                   shard_id: int, num_shards: int, steps: int) -> list[str]:
    """The batch digests of the first ``steps`` batches of a rank's native
    loader shard, epoch after epoch, as ``bin/train.py`` draws them."""
    from articulatory_tpu_torch.data.native_loader import NativeDataLoader

    train_set = port["train"].build_datasets(
        config, dirs["train_dumpdir"], dirs["dev_dumpdir"],
        dirs["data_root"])[0]
    gp = config["generator_params"]
    loader = NativeDataLoader(
        train_set, batch_size=config["batch_size"],
        batch_max_steps=config["batch_max_steps"],
        hop_size=config["hop_size"],
        ar_len=int(gp["ar_input"] / gp["out_channels"]), seed=seed,
        shard_id=shard_id, num_shards=num_shards, n_threads=2)
    digests, epoch = [], 0
    while len(digests) < steps:
        loader.set_epoch(epoch)
        digests += [_batch_digest(b) for b in loader][: steps - len(digests)]
        epoch += 1
    return digests


def rank_worker(workdir: str) -> int:
    """One rank of [dp] / [dp-native] / [tp], started by the launcher:
    ``bin/train.py``'s ``main`` on ``workdir``'s spec, each step's
    launches, time, the host time between its record and the previous
    one's (the loader's), collective seconds, batch digest and parameter
    digest
    recorded (a TP generator gathered full), and at PAR_GRAD_STEP the
    weights before and after, the rank's batch and the all-reduced
    gradients saved for the one-rank reference."""
    with open(os.path.join(workdir, "spec.json")) as f:
        spec = json.load(f)
    sys.path.insert(0, ROOT)
    from articulatory_tpu_torch.parallel import mesh, tp

    port = training_port()
    train_cli = port["train"]
    records, grads, keep = [], [], {"on": False}
    last_end = [None]
    reduce_grads = mesh.all_reduce_grads
    # each collective's calls and wall seconds, the device synchronised
    # before and after it, so the time is the collective's own
    collectives = {"calls": 0, "seconds": 0.0}
    collective = mesh._collective

    def timed_collective(fn, tensor, *args, **kwargs):
        collectives["calls"] += 1
        if tensor.is_cuda:
            torch.cuda.synchronize(tensor.device)
        start = time.perf_counter()
        collective(fn, tensor, *args, **kwargs)
        if tensor.is_cuda:
            torch.cuda.synchronize(tensor.device)
        collectives["seconds"] += time.perf_counter() - start

    mesh._collective = timed_collective

    def reduce_and_keep(params, group):
        reduce_grads(params, group)
        if keep["on"]:
            grads.append([torch.zeros_like(p) if p.grad is None
                          else p.grad.detach().clone() for p in params])

    def full_generator(state) -> dict:
        sd = (state.generator.state_dict() if state.generator.tp is None
              else tp.full_state(state.generator)[0])
        return {k: v.detach().clone() for k, v in sd.items()}

    def full_grads(state, local: list) -> dict:
        gen = state.generator
        names = [n for n, _ in gen.named_parameters()]
        if gen.tp is None:
            return dict(zip(names, local))
        plan, held = gen.tp, dict(zip(names, local))
        return {n: tp._gathered(held.get(n), n, plan, local[0])
                for n in plan.full_names}

    make_train_step = train_cli.make_train_step

    def make(criterion, config):
        step = make_train_step(criterion, config)

        def recorded(state, batch, lr_g, lr_d):
            # the host's time since the last step's record ended: the
            # trainer's loop, the loader and the batch's copy
            arrived = time.perf_counter()
            gap = None if last_end[0] is None else arrived - last_end[0]
            k, rank = state.steps, mesh.rank()
            if k == PAR_GRAD_STEP:
                pre = {"generator": full_generator(state),
                       "discriminator": {
                           k: v.detach().clone() for k, v in
                           state.discriminator.state_dict().items()}}
                torch.save({key: value.cpu() for key, value in batch.items()
                            if torch.is_tensor(value)} | {
                    "x": tuple(v.cpu() for v in batch["x"])},
                    os.path.join(workdir, f"batch{rank}.pt"))
                keep["on"] = True
            reset_counts(port)
            calls, seconds = collectives["calls"], collectives["seconds"]
            torch.cuda.synchronize()
            start = time.perf_counter()
            metrics = step(state, batch, lr_g, lr_d)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - start
            counts = read_counts(port)
            gen = full_generator(state)
            records.append({
                "step": k, "seconds": elapsed, "gap_seconds": gap,
                "launches": counts, "batch_digest": _batch_digest(batch),
                "collective_calls": collectives["calls"] - calls,
                "collective_seconds": collectives["seconds"] - seconds,
                "digest": _digest(list(gen.values()) + list(
                    state.discriminator.state_dict().values())),
                "generator_loss": float(metrics["train/generator_loss"])})
            if k == PAR_GRAD_STEP:
                keep["on"] = False
                got_g = full_grads(state, grads[0])
                names_d = [n for n, _ in state.discriminator.named_parameters()]
                if rank == 0:
                    torch.save({**pre, "generator_after": gen,
                                "grads_generator": got_g,
                                "grads_discriminator": dict(zip(
                                    names_d, grads[1]))},
                               os.path.join(workdir, "step.pt"))
            last_end[0] = time.perf_counter()
            return metrics

        return recorded

    mesh.all_reduce_grads = reduce_and_keep
    train_cli.make_train_step = make
    held = {}
    split_generator = train_cli._split_generator

    def split_and_count(state, config, lay):
        split_generator(state, config, lay)
        plan = state.generator.tp
        held.update(
            params=sum(p.numel() for p in state.generator.parameters()),
            full=sum(int(np.prod(plan.full_shapes[n]))
                     for n in plan.full_names),
            blocks=[j for j in range(len(plan.owners)) if plan.mine(j)])

    train_cli._split_generator = split_and_count
    rank = int(os.environ["RANK"])
    backend = {}
    init = mesh.init_distributed

    def init_and_keep(*args, **kwargs):
        backend["name"] = init(*args, **kwargs)
        return backend["name"]

    mesh.init_distributed = init_and_keep
    train_cli.main(spec["argv"])
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "backend": backend.get("name"),
                   "records": records, "held": held}, f)
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_parallel(port: dict, mode: str, seed: int, tmp: str) -> dict:
    """[dp], [dp-native] or [tp]: ``python -m
    articulatory_tpu_torch.distributed.launch --nproc_per_node 2`` on this
    script's rank worker, which runs ``bin/train.py``'s ``main``
    (``parallel_config(mode)``) on the corpus under ``tmp``; holds every
    step's parameters bit-equal on both ranks, each rank's launches a step
    (dp: 72 pairs and 12 heads; tp: the pairs of the rank's MRF blocks, 12
    heads), the final checkpoint full, and the step-PAR_GRAD_STEP
    all-reduced gradients (a TP generator's gathered) against one
    process's on the concatenated batch (pooled relative L2 <= GRAD_TOL[0]
    per model); [dp-native] also each rank's batches against its shard of
    the native loader built here, and no loader warning."""
    gan, train_cli = port["gan"], port["train"]
    config = parallel_config(mode)
    workdir = os.path.join(tmp, f"par-{mode}")
    os.makedirs(workdir)
    import yaml

    cfg_path = os.path.join(workdir, "config.yml")
    with open(cfg_path, "w") as f:
        yaml.dump(config, f)
    outdir = os.path.join(workdir, "exp")
    argv = ["--train-dumpdir", os.path.join(tmp, "dump/tr/norm"),
            "--dev-dumpdir", os.path.join(tmp, "dump/dev/norm"),
            "--outdir", outdir, "--config", cfg_path,
            "--data-root", os.path.join(tmp, "data"), "--device", "cuda",
            "--seed", str(seed)]
    with open(os.path.join(workdir, "spec.json"), "w") as f:
        json.dump({"argv": argv}, f)
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "articulatory_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--master_port", str(_free_port()),
         os.path.join(ROOT, "chip_smoke.py"), "--rank-worker", workdir],
        env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=PAR_TIMEOUT_S)
    run_seconds = time.perf_counter() - start
    if proc.returncode != 0:
        raise AssertionError(f"[{mode}] the launcher exited "
                             f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-6000:]}")
    build = [ln for ln in proc.stderr.splitlines()
             if "launcher: kernels built" in ln]
    ranks = []
    for r in range(2):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    steps = PAR_STEPS[mode]
    if any(len(r["records"]) != steps for r in ranks):
        raise AssertionError(f"[{mode}] steps recorded "
                             f"{[len(r['records']) for r in ranks]}")
    for a, b in zip(ranks[0]["records"], ranks[1]["records"]):
        if a["digest"] != b["digest"]:
            raise AssertionError(f"[{mode}] the ranks' parameters differ "
                                 f"after step {a['step']}")
    if mode == "dp-native":
        warned = [ln for ln in proc.stderr.splitlines()
                  if "use_native_loader" in ln or "single-process" in ln]
        if warned:
            raise AssertionError(f"[{mode}] a loader warning: {warned}")
        dirs = {"train_dumpdir": os.path.join(tmp, "dump/tr/norm"),
                "dev_dumpdir": os.path.join(tmp, "dump/dev/norm"),
                "data_root": os.path.join(tmp, "data")}
        for r in ranks:
            want = native_digests(port, config, dirs, seed, r["rank"], 2,
                                  steps)
            got = [rec["batch_digest"] for rec in r["records"]]
            if got != want:
                raise AssertionError(
                    f"[{mode}] rank {r['rank']}'s batches are not its "
                    f"native shard's: {got} against {want}")
        if ranks[0]["records"][0]["batch_digest"] == \
                ranks[1]["records"][0]["batch_digest"]:
            raise AssertionError(f"[{mode}] both ranks took one batch")
    one_step = expected_launches(config, 1)
    pairs_a_block = (sum(len(d) for d in config["generator_params"][
        "resblock_dilations"]) // len(config["generator_params"][
            "resblock_kernel_sizes"]) * len(config["generator_params"][
                "upsample_scales"]) * 2)
    for r in ranks:
        want = dict(one_step)
        if mode == "tp":
            n = pairs_a_block * len(r["held"]["blocks"])
            want = dict(one_step, resblock_pair={"torch.float32": n},
                        split_tf32=n)
        for rec in r["records"]:
            if rec["launches"] != want:
                raise AssertionError(
                    f"[{mode}] rank {r['rank']} step {rec['step']}: "
                    f"launches {rec['launches']}, expected {want}")
    ckpt = port["load_checkpoint"](os.path.join(
        outdir, f"checkpoint-{steps}steps.ckpt"))
    full = port["build_model"](config["generator_type"],
                               config["generator_params"], seed=seed)
    if {k: tuple(v.shape) for k, v in ckpt["model"]["generator"].items()} \
            != {k: tuple(v.shape) for k, v in full.state_dict().items()}:
        raise AssertionError(f"[{mode}] the checkpoint's generator is not "
                             f"the full model")

    # the one-process reference on the ranks' concatenated batch
    saved = torch.load(os.path.join(workdir, "step.pt"))
    parts = [torch.load(os.path.join(workdir, f"batch{r}.pt"))
             for r in range(2)]
    if mode == "tp":  # one TP group: both ranks had the same batch
        same = all(torch.equal(a, b) for a, b in zip(
            [parts[0]["y"], *parts[0]["x"]], [parts[1]["y"], *parts[1]["x"]]))
        if not same:
            raise AssertionError("[tp] the TP ranks' batches differ")
        parts = parts[:1]
    batch = {k: (tuple(torch.cat([p[k][i] for p in parts]).cuda()
                       for i in range(len(parts[0][k])))
                 if isinstance(parts[0][k], tuple) else
                 torch.cat([p[k] for p in parts]).cuda())
             for k in parts[0]}
    disc = port["build_model"](config["discriminator_type"],
                               config["discriminator_params"],
                               seed=seed + 1).cuda()
    full.cuda().load_state_dict(saved["generator"])
    disc.load_state_dict(saved["discriminator"])
    state = gan.GANTrainState(generator=full, discriminator=disc, opt_g=None,
                              opt_d=None, steps=PAR_GRAD_STEP)
    state.draws.at(PAR_GRAD_STEP)
    criterion = gan.GANCriterion(config)
    gen_loss, _ = gan.generator_loss(state, criterion, config, batch)
    gen_names = [n for n, _ in full.named_parameters()]
    want_g = _grads(gen_loss, list(full.parameters()))
    full.load_state_dict(saved["generator_after"])
    with torch.no_grad():
        fake = gan.synthesize(criterion, gan.generate(
            full, batch, state.draws, "regeneration"))
    dis_loss, _ = gan.discriminator_loss(state, criterion, config, batch,
                                         fake)
    want_d = _grads(dis_loss, list(disc.parameters()))
    disc_names = [n for n, _ in disc.named_parameters()]
    gaps = {}
    for name, names, want, got in (
            ("generator", gen_names, want_g, saved["grads_generator"]),
            ("discriminator", disc_names, want_d,
             saved["grads_discriminator"])):
        pooled, per = _grad_gaps([got[n].cuda() for n in names], want)
        gaps[name] = {"pooled_rel_l2": pooled, "worst_tensor_rel_l2": per}
        if pooled > GRAD_TOL[0]:
            raise AssertionError(f"[{mode}] {name} all-reduced gradients "
                                 f"differ from one process's by {pooled:.3e}"
                                 f" pooled > {GRAD_TOL[0]}")
    del state, full, disc, batch, fake
    torch.cuda.empty_cache()

    result = {"run_seconds": run_seconds, "backend": ranks[0]["backend"],
              "launcher_build": build[0] if build else None,
              "grad_gaps": gaps, "ranks": ranks,
              "launches_per_step": {r["rank"]: r["records"][-1]["launches"]
                                    for r in ranks}}
    for r in ranks:
        secs = [rec["seconds"] for rec in r["records"]]
        coll = [rec["collective_seconds"] for rec in r["records"]]
        r["step_ms_median"] = 1e3 * float(np.median(secs))
        r["gap_ms_median"] = 1e3 * float(np.median(
            [rec["gap_seconds"] for rec in r["records"][1:]]))
        r["collective_ms_median"] = 1e3 * float(np.median(coll))
        held = (f"; generator parameters {r['held']['params']:,} of "
                f"{r['held']['full']:,} (blocks {r['held']['blocks']})"
                if mode == "tp" else "")
        log(f"[{mode}] rank {r['rank']} ({r['backend']}, two ranks sharing "
            f"one card's SMs): step median {r['step_ms_median']:.3f} ms over "
            f"{steps} [{', '.join(f'{1e3 * s:.1f}' for s in secs)}], "
            f"{r['gap_ms_median']:.3f} ms between steps (the loader), "
            f"{r['collective_ms_median']:.3f} ms of it in "
            f"{r['records'][-1]['collective_calls']} collectives; launches a "
            f"step {r['records'][-1]['launches']}{held}")
    log(f"[{mode}] {steps} steps through the launcher in "
        f"{run_seconds:.1f} s (two processes' start-up, model build and "
        f"checkpoint included; {build[0].split('WARNING: ')[-1] if build else 'no launcher build line'}); "
        f"parameters bit-equal on both ranks after every step; "
        + (f"each rank's {steps} batches equal to its native loader "
           f"shard's (shard_id r of 2) built here; "
           if mode == "dp-native" else "")
        + f"step {PAR_GRAD_STEP} all-reduced gradients against one process "
        f"on the {'shared' if mode == 'tp' else 'concatenated'} batch: "
        + ", ".join(f"{k} {v['pooled_rel_l2']:.3e} pooled / "
                    f"{v['worst_tensor_rel_l2']:.3e} worst tensor"
                    for k, v in gaps.items())
        + f" (limit {GRAD_TOL[0]} pooled)")
    return result


# [pp]: PipelinedGenerator of the EMA HiFi-CAR on cuda:0, a stream a stage
# group; B 16 chunks of 100 frames and the 512-sample carry
PP_GROUPS, PP_MICROBATCHES, PP_ROUNDS = (2, 3), (2, 4), 5


def phase_pp(port: dict, seed: int) -> dict:
    """Each (groups, microbatches) of PipelinedGenerator in f32 and hybrid
    against the monolithic forward: bit for bit against it on the same
    microbatches, and within KERNEL_TOL of the whole-batch forward (cuDNN
    may take another algorithm at another batch); 36 pairs a microbatch;
    its time against the monolith's (median of PP_ROUNDS, in turns)."""
    pp, pair = port["pp"], port["resblock_pair"]
    rng = np.random.default_rng(seed)
    c = torch.tensor(rng.standard_normal((UTTS, CHUNK_FRAMES, N_FEATS)),
                     dtype=torch.float32, device="cuda")
    ar = torch.tensor(0.3 * rng.standard_normal((UTTS, 512, 1)),
                      dtype=torch.float32, device="cuda")
    results = {}
    for mode, extra in (("f32", {}), ("hybrid_bf16", {
            "compute_dtype": "bfloat16", "hybrid_precision": True})):
        model = port["build_model"]("HiFiGANGenerator",
                                    dict(GENERATOR_PARAMS, **extra),
                                    seed=seed).cuda().eval()
        model.remove_weight_norm()
        with torch.inference_mode():
            whole = model(c, ar)
            per_mb = {m: torch.cat([model(a, b) for a, b in zip(
                c.chunk(m), ar.chunk(m))]) for m in PP_MICROBATCHES}
        for groups in PP_GROUPS:
            for m in PP_MICROBATCHES:
                pipe = pp.PipelinedGenerator(model, ["cuda:0"] * groups,
                                             num_microbatches=m)
                pair.launches = 0
                out = pipe(c, ar)
                torch.cuda.synchronize()
                launches = pair.launches
                if launches != 36 * m:
                    raise AssertionError(f"[pp] {mode} {groups} groups, {m} "
                                         f"microbatches: {launches} pairs, "
                                         f"expected {36 * m}")
                if not torch.equal(out, per_mb[m]):
                    raise AssertionError(f"[pp] {mode} {groups} groups, {m} "
                                         f"microbatches differ from the "
                                         f"monolith on the same microbatches")
                whole_err = float((out - whole).abs().max() / whole.abs().max())
                tol = KERNEL_TOL[torch.bfloat16 if extra else torch.float32]
                if whole_err > tol:
                    raise AssertionError(f"[pp] {mode}: {whole_err:.3e} of max"
                                         f" |y| from the whole-batch forward")
                fns = {"pipeline": lambda: pipe(c, ar),
                       "monolith": lambda: model(c, ar)}
                times = {k: [] for k in fns}
                with torch.inference_mode():
                    for _ in range(PP_ROUNDS):
                        for key in ("pipeline", "monolith", "monolith",
                                    "pipeline"):
                            torch.cuda.synchronize()
                            t0 = time.perf_counter()
                            fns[key]()
                            torch.cuda.synchronize()
                            times[key].append(time.perf_counter() - t0)
                ms = {k: 1e3 * float(np.median(v)) for k, v in times.items()}
                results[f"{mode}/{groups}x{m}"] = {
                    "launches": launches, "bit_equal_per_microbatch": True,
                    "whole_batch_rel_err": whole_err, **{
                        f"{k}_ms": v for k, v in ms.items()}}
                log(f"[pp] {mode}, {groups} stage groups on cuda:0 (a stream "
                    f"each), {m} microbatches: {launches} pairs, bit-equal to "
                    f"the monolith on the same microbatches, "
                    f"{whole_err:.2e} of max |y| from the whole batch's; "
                    f"{ms['pipeline']:.3f} ms against the monolith's "
                    f"{ms['monolith']:.3f} ms (median of {2 * PP_ROUNDS})")
        del model
    torch.cuda.empty_cache()
    return results


# [sp]: the EMA widths without AR (in_channels 13), one 60 s utterance
SP_FRAMES, SP_TILES, SP_TOL = 12000, 4, 1e-5


def phase_sp(port: dict, seed: int, tmp: str) -> dict:
    """``LoadedModel.enable_sequence_parallel(SP_TILES)`` on a SP_FRAMES
    frame utterance against the unsharded forward (SP_TOL of max |y|; no
    padded tail at this length), 36 pairs a tile, the peak memory of both;
    then ``bin/decode.py --sequence-parallel`` on a checkpoint of the same
    model, its wav against the unsharded decode's."""
    inference, decode, pair = (port["inference"], port["decode"],
                               port["resblock_pair"])
    gp = dict(GENERATOR_PARAMS, use_ar=False, in_channels=N_FEATS)
    config = dict(CONFIG, generator_params=gp)
    model = port["build_model"]("HiFiGANGenerator", gp, seed=seed)
    ckpt = os.path.join(tmp, "sp.pkl")
    torch.save({"model": {"generator": model.state_dict()}}, ckpt)
    loaded = inference.LoadedModel(model.cuda().eval(), config,
                                   torch.device("cuda"))
    loaded.remove_weight_norm()
    c = np.random.default_rng(seed).standard_normal(
        (1, SP_FRAMES, N_FEATS)).astype(np.float32)
    runs = {}
    for key in ("unsharded", "sequence_parallel"):
        if key == "sequence_parallel":
            loaded.enable_sequence_parallel(SP_TILES)
        loaded(c)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        pair.launches = 0
        t0 = time.perf_counter()
        y = loaded(c)
        torch.cuda.synchronize()
        runs[key] = {"ms": 1e3 * (time.perf_counter() - t0),
                     "launches": pair.launches,
                     "peak_bytes": torch.cuda.max_memory_allocated() - base,
                     "y": y}
    full, sp = runs["unsharded"]["y"], runs["sequence_parallel"]["y"]
    err = float((sp - full).abs().max() / full.abs().max())
    if sp.shape != full.shape or err > SP_TOL:
        raise AssertionError(f"[sp] tiled forward {tuple(sp.shape)} is "
                             f"{err:.3e} of max |y| from the unsharded one")
    if runs["sequence_parallel"]["launches"] != 36 * SP_TILES:
        raise AssertionError(f"[sp] {runs['sequence_parallel']['launches']} "
                             f"pairs, expected {36 * SP_TILES}")
    dump = os.path.join(tmp, "sp-dump")
    os.makedirs(dump)
    np.save(os.path.join(dump, "u0-feats.npy"), c[0])
    import yaml

    with open(os.path.join(tmp, "config.yml"), "w") as f:
        yaml.dump(config, f)
    wavs = {}
    for key, extra in (("unsharded", []), ("sequence_parallel",
                                           ["--sequence-parallel",
                                            str(SP_TILES)])):
        out = os.path.join(tmp, f"sp-{key}")
        pair.launches = 0
        decode.main(["--dumpdir", dump, "--checkpoint", ckpt, "--config",
                     os.path.join(tmp, "config.yml"), "--outdir", out,
                     "--device", "cuda", "--verbose", "0", *extra])
        wavs[key] = (port["read_wav"](os.path.join(out, "u0_gen.wav"))[0],
                     pair.launches)
    lsb = float(np.abs(wavs["sequence_parallel"][0]
                       - wavs["unsharded"][0]).max() * 32767)
    if (wavs["sequence_parallel"][0].shape != (SP_FRAMES * 80,) or lsb > 1
            or wavs["sequence_parallel"][1] != 36 * SP_TILES):
        raise AssertionError(f"[sp] decode: {wavs['sequence_parallel'][0].shape}"
                             f", {lsb:.1f} lsb from the unsharded decode, "
                             f"{wavs['sequence_parallel'][1]} pairs")
    result = {"rel_err": err, "decode_lsb": lsb,
              "decode_launches": wavs["sequence_parallel"][1],
              **{key: {k: v for k, v in r.items() if k != "y"}
                 for key, r in runs.items()}}
    log(f"[sp] {SP_FRAMES} frames ({SP_FRAMES * 80 / 16000:.0f} s), "
        f"{SP_TILES} tiles with a {loaded.sp.halo}-frame halo on one card: "
        f"{err:.2e} of max |y| from the unsharded forward, "
        f"{result['sequence_parallel']['launches']} pairs; "
        f"{result['sequence_parallel']['ms']:.1f} ms against "
        f"{result['unsharded']['ms']:.1f} ms; peak memory above the weights "
        f"{result['sequence_parallel']['peak_bytes'] / 2**20:.0f} MiB "
        f"against {result['unsharded']['peak_bytes'] / 2**20:.0f} MiB; "
        f"bin/decode.py --sequence-parallel {SP_TILES}: "
        f"{wavs['sequence_parallel'][1]} pairs, {lsb:.0f} lsb from the "
        f"unsharded decode")
    del loaded, model, runs
    torch.cuda.empty_cache()
    return result


# [export] / [convert] / [pretrained] / [quality]: the exported generator,
# the reference-to-JAX conversion, the registry's downloader and the
# quality A/B tool chain. EXPORT_TURNS: the exported program and the eager
# forward timed in turns (ms a forward); QUALITY_*: the A/B at a tiny size
EXPORT_TURNS = ("eager", "exported", "exported", "eager") * 2
# the loaded program calls each op through the dispatcher's boxed path,
# which costs the host-bound hybrid forward 5-20 % over eager's direct
# calls; a program that derives its kernels in the graph reads 1.6-3.9x
EXPORT_SLOWER = 1.5
EXPORT_TAG = "ljspeech_hifigan.v1"
QUALITY_STEPS = 10
QUALITY_ENV = {"N_UTTS": "5", "DEV_UTTS": "1", "MIN_SECONDS": "1.0",
               "MAX_SECONDS": "1.5", "BATCH_SIZE": "4"}
QUALITY_TIMEOUT_S = 400
# [cotrain]: the committed artifact whose port leg runs here, its arms (in
# turns in one process with COTRAIN_THREADS CPU threads) and their time limit
COTRAIN_PROFILE = "f32-wide"
COTRAIN_ARMS = ("kernel", "plain")
COTRAIN_THREADS = 2
COTRAIN_TIMEOUT_S = 600


# [past-seq]: PastSeqEncoder at its defaults (output 128, 2 layers of 8
# heads, feed-forward 512, relative distance 100) on a B 16 x P 512 past.
# The card against the CPU in float64 (PAST_SEQ_F64_TOL of max |y|); the
# card's float32 against the CPU's float64, within PAST_SEQ_TOL or twice
# the CPU's own float32 distance, whichever is larger: the first
# LayerNorm divides rows of the ResBlock's output whose spread is 1/1000
# of max |y|, so float32 reads about 5e-5 there on either device
PAST_SEQ_B, PAST_SEQ_P = 16, 512
PAST_SEQ_TOL, PAST_SEQ_F64_TOL = 1e-5, 1e-10


def phase_past_seq(seed: int, device_name: str) -> dict:
    """[past-seq]: ``layers/past_encoder.py::PastSeqEncoder`` in eval mode
    (running statistics drawn away from (0, 1)): the card's forward against
    the same module's on the CPU in float64, the card's and the CPU's
    float32 against the CPU's float64, and the card's float32 ms by CUDA
    events; in training, two forwards whose dropout draws from a card
    generator of one seed agree (PAST_SEQ_TOL) and differ from another
    seed's."""
    from articulatory_tpu_torch.layers.past_encoder import PastSeqEncoder
    from articulatory_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    gen = torch.Generator().manual_seed(seed)
    enc = PastSeqEncoder(generator=gen).eval()
    with torch.no_grad():
        for name, buf in enc.named_buffers():
            if "running" in name:
                buf.uniform_(0.5, 1.5, generator=gen)
    x = 0.3 * torch.randn(PAST_SEQ_B, PAST_SEQ_P, 1, generator=gen)
    card, xc = copy.deepcopy(enc).to(dev), x.to(dev)
    with torch.no_grad():
        ref = copy.deepcopy(enc).double()(x.double())
        cpu32 = enc(x)
        before = _banded_counts()
        got = card(xc)
        launches = _banded_counts(before)
        got64 = copy.deepcopy(card).double()(xc.double())
        ms = time_ms(lambda: card(xc), 20)
    shape = (PAST_SEQ_B, PAST_SEQ_P, 128)
    if got.shape != shape or not torch.isfinite(got).all():
        raise AssertionError(f"[past-seq] output {tuple(got.shape)}, "
                             f"expected {shape}, finite")
    scale = float(ref.abs().max())
    err64 = float((got64.cpu() - ref).abs().max()) / scale
    err = float((got.cpu().double() - ref).abs().max()) / scale
    cpu_err = float((cpu32.double() - ref).abs().max()) / scale
    limit = max(PAST_SEQ_TOL, 2 * cpu_err)
    layers = len(card.transformer.layers)
    want = {"banded_attention": {str(torch.float32): layers},
            "banded_attention_backward": 0}
    if launches != want:
        raise AssertionError(f"[past-seq] banded attention launches "
                             f"{launches} in one forward, expected {want}")
    if err64 > PAST_SEQ_F64_TOL or err > limit:
        raise AssertionError(
            f"[past-seq] the card's float64 forward is {err64:.3e} of max "
            f"|y| from the CPU's (limit {PAST_SEQ_F64_TOL}), its float32 "
            f"{err:.3e} from the CPU's float64 (limit {limit:.3e})")
    card.train()
    with torch.no_grad():
        runs = [card(xc, torch.Generator(device=dev).manual_seed(k))
                for k in (seed, seed, seed + 1)]
    top = float(runs[0].abs().max())
    same = float((runs[0] - runs[1]).abs().max()) / top
    other = float((runs[0] - runs[2]).abs().max()) / top
    if same > PAST_SEQ_TOL or other <= PAST_SEQ_TOL:
        raise AssertionError(f"[past-seq] dropout: one seed's forwards "
                             f"{same:.3e} apart, another seed's {other:.3e}")
    log(f"[past-seq] PastSeqEncoder B {PAST_SEQ_B} x P {PAST_SEQ_P} on "
        f"{device_name}: {ms:.3f} ms a forward (eval, f32, TF32 off); "
        f"float64 {err64:.3e} of max |y| from the CPU's (limit "
        f"{PAST_SEQ_F64_TOL}); float32 {err:.3e} from the CPU's float64 "
        f"(limit {limit:.3e}), the CPU's float32 {cpu_err:.3e}; training "
        f"dropout from a card generator: one seed's forwards {same:.3e} "
        f"apart, another seed's {other:.3e}; banded attention launches a "
        f"forward {launches['banded_attention']}")
    return {"ms": ms, "f64_rel_err": err64, "f32_rel_err": err,
            "cpu_f32_rel_err": cpu_err, "dropout_same_seed": same,
            "dropout_other_seed": other}


def _export_models(port, seed: int, tmp: str) -> dict:
    """The EMA HiFi-CAR at full width from ``--seed`` as the decode loads it
    (``load_model``, frozen kernels), f32 and hybrid."""
    gp = GENERATOR_PARAMS
    ckpt = os.path.join(tmp, "generator.pth")
    torch.save({"model": {"generator": port["weights"].jax_params_to_state_dict(
        numpy_generator_params(gp, seed), gp)}}, ckpt)
    modes = {"f32": CONFIG, "hybrid_bf16": dict(CONFIG, generator_params=dict(
        gp, compute_dtype="bfloat16", hybrid_precision=True))}
    models = {}
    for mode, config in modes.items():
        models[mode] = port["inference"].load_model(ckpt, config,
                                                    device="cuda")
        models[mode].remove_weight_norm()
    return models


def export_worker(workdir: str) -> int:
    """[export]'s fresh process: imports the port's ``export`` module only
    (which registers the pair op), loads each serialized program of
    ``workdir``, runs it once on the saved inputs and saves its output and
    the pair launches it counted."""
    sys.path.insert(0, ROOT)
    from articulatory_tpu_torch import export
    from articulatory_tpu_torch.ops.resblock_pair import resblock_pair
    from articulatory_tpu_torch.utils.device import set_float32_parity

    set_float32_parity()
    c, ar = torch.load(os.path.join(workdir, "inputs.pt"))
    counts = {}
    for mode in ("f32", "hybrid_bf16"):
        with open(os.path.join(workdir, f"program_{mode}.pt2"), "rb") as f:
            program = export.deserialize(f.read()).module()
        resblock_pair.launches = 0
        with torch.inference_mode():
            y = program(c, ar)
        torch.cuda.synchronize()
        counts[mode] = resblock_pair.launches
        torch.save(y.cpu(), os.path.join(workdir, f"out_{mode}.pt"))
    with open(os.path.join(workdir, "worker.json"), "w") as f:
        json.dump(counts, f)
    return 0


def phase_export(port: dict, seed: int, device_name: str, tmp: str) -> dict:
    """[export] The EMA HiFi-CAR at full width, f32 and hybrid, B UTTS
    chunks of CHUNK_FRAMES frames with the 512-sample carry, through
    ``export.to_torch_export`` -> ``serialize``: the graph holds 36 pair op
    nodes; a fresh process (``--export-worker``) that imports the port
    alone deserializes and runs it, bit-equal to the eager chunk forward
    with 36 hand pair launches; in this process the loaded program (36
    launches a forward) is within CHUNK_TOL of the same forward on plain
    pairs, and its ms a forward against eager's, in turns, at most
    EXPORT_SLOWER times eager's."""
    export, pair, plain, residual = (port[k] for k in (
        "export", "resblock_pair", "plain", "residual"))
    models = _export_models(port, seed, tmp)
    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    c = torch.randn(UTTS, CHUNK_FRAMES, N_FEATS, device="cuda", generator=gen)
    ar = 0.1 * torch.randn(UTTS, GENERATOR_PARAMS["ar_input"], 1,
                           device="cuda", generator=gen)
    work = os.path.join(tmp, "export")
    os.makedirs(work)
    torch.save((c, ar), os.path.join(work, "inputs.pt"))
    results, eager, programs = {}, {}, {}
    for mode, model in models.items():
        with torch.inference_mode():
            eager[mode] = model.model(c, ar)
        start = time.perf_counter()
        ep = export.to_torch_export(model.model, (c, ar))
        blob = export.serialize(ep)
        seconds = time.perf_counter() - start
        nodes = export.pair_nodes(ep)
        if nodes != 36:
            raise AssertionError(f"[export] {mode}: {nodes} pair op nodes in "
                                 f"the exported graph, expected 36")
        derived = [k for k in ep.state_dict
                   if k.endswith(("weight_g", "weight_v"))]
        if derived:  # the frozen kernels must be the program's constants
            raise AssertionError(f"[export] {mode}: the program derives its "
                                 f"kernels from {derived[:3]} ...")
        with open(os.path.join(work, f"program_{mode}.pt2"), "wb") as f:
            f.write(blob)
        programs[mode] = export.deserialize(blob).module()
        results[mode] = {"export_seconds": seconds, "bytes": len(blob),
                         "pair_nodes": nodes}
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--export-worker", work],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    worker_seconds = time.perf_counter() - start
    if proc.returncode != 0:
        raise AssertionError(f"[export] the fresh process failed "
                             f"({proc.returncode}): {proc.stderr[-3000:]}")
    with open(os.path.join(work, "worker.json")) as f:
        worker_launches = json.load(f)
    pair.launches = 0
    for mode, program in programs.items():
        got = torch.load(os.path.join(work, f"out_{mode}.pt"))
        if worker_launches[mode] != 36 or not torch.equal(
                got, eager[mode].cpu()):
            raise AssertionError(
                f"[export] {mode}: the fresh process launched "
                f"{worker_launches[mode]} pairs; "
                f"{(got - eager[mode].cpu()).abs().max().item()} from eager")
        before = pair.launches
        with torch.inference_mode():
            y = program(c, ar)
            with swapped(residual, "resblock_pair", plain):
                want = models[mode].model(c, ar)
        launches = pair.launches - before
        err = (y.float() - want.float()).abs().max().item()
        if launches != 36 or not torch.equal(y, eager[mode]) or \
                err > CHUNK_TOL[mode]:
            raise AssertionError(f"[export] {mode}: {launches} pair launches "
                                 f"in this process, {err:.2e} from the plain "
                                 f"pairs' forward (limit {CHUNK_TOL[mode]})")
        with torch.inference_mode():
            times, _ = run_turns({"eager": lambda: models[mode].model(c, ar),
                                  "exported": lambda: program(c, ar)},
                                 EXPORT_TURNS)
        results[mode].update(
            launches=launches, worker_launches=worker_launches[mode],
            plain_err=err, eager_ms=1e3 * float(np.median(times["eager"])),
            exported_ms=1e3 * float(np.median(times["exported"])))
        if results[mode]["exported_ms"] > EXPORT_SLOWER * results[mode][
                "eager_ms"]:
            raise AssertionError(
                f"[export] {mode}: the program takes "
                f"{results[mode]['exported_ms']:.3f} ms a forward, eager "
                f"{results[mode]['eager_ms']:.3f} (limit {EXPORT_SLOWER}x)")
        log(f"[export] {mode} on {device_name}: {results[mode]['bytes']:,} "
            f"bytes, {results[mode]['export_seconds']:.1f} s to export; 36 "
            f"pair op nodes; a fresh process ({worker_seconds:.1f} s) ran it "
            f"bit-equal to the eager chunk forward with "
            f"{worker_launches[mode]} pair launches; here {launches} "
            f"launches, {err:.2e} from plain pairs (limit {CHUNK_TOL[mode]});"
            f" {results[mode]['exported_ms']:.3f} ms a forward exported, "
            f"{results[mode]['eager_ms']:.3f} ms eager (median of "
            f"{EXPORT_TURNS.count('eager')}, in turns)")
    # the loaded programs' forwards, not the timed turns
    results["launches"] = sum(results[m]["launches"] for m in programs)
    results["worker_seconds"] = worker_seconds
    del models, programs
    torch.cuda.empty_cache()
    return results


def _reference_pickle(port, seed: int, tmp: str) -> str:
    """The EMA HiFi-CAR from ``--seed`` as a reference-format torch pickle
    (weight_g / weight_v) beside its config.yml."""
    import yaml

    gp = GENERATOR_PARAMS
    os.makedirs(tmp, exist_ok=True)
    path = os.path.join(tmp, "checkpoint-100steps.pkl")
    torch.save({"model": {"generator": port["weights"].jax_params_to_state_dict(
        numpy_generator_params(gp, seed), gp)}, "optimizer": {},
        "scheduler": {}, "steps": 100, "epochs": 1}, path)
    with open(os.path.join(tmp, "config.yml"), "w") as f:
        yaml.dump(CONFIG, f)
    return path


def phase_convert(port: dict, seed: int, tmp: str) -> dict:
    """[convert] A reference-format pickle of the EMA HiFi-CAR through
    ``bin/convert_checkpoint.py`` (the default direction) to a JAX msgpack:
    ``load_model`` of the msgpack decodes ENTRY_FRAMES frames bit-equal to
    its decode of the pickle on the card (36 pairs a chunk each)."""
    inference, pair = port["inference"], port["resblock_pair"]
    pkl = _reference_pickle(port, seed, os.path.join(tmp, "ref"))
    out = os.path.join(tmp, "jax", "checkpoint-100steps.ckpt")
    start = time.perf_counter()
    port["convert_checkpoint"].main(["--checkpoint", pkl, "--out", out])
    seconds = time.perf_counter() - start
    payload = port["load_checkpoint"](out)
    if payload["steps"] != 100 or "v" not in payload["model"]["generator"][
            "input_conv"]:
        raise AssertionError("[convert] the msgpack is not the JAX layout")
    x = np.random.default_rng(seed + 41).standard_normal(
        (ENTRY_FRAMES, N_FEATS)).astype(np.float32)
    chunks = -(-ENTRY_FRAMES // CHUNK_FRAMES)
    outs = {}
    pair.launches = 0
    for name, path in (("pickle", pkl), ("msgpack", out)):
        model = inference.load_model(path, CONFIG, device="cuda")
        model.remove_weight_norm()
        outs[name] = inference.ar_loop(model, x, CONFIG)
    launches = pair.launches
    if not np.array_equal(outs["pickle"], outs["msgpack"]) or \
            launches != 2 * 36 * chunks or not np.isfinite(outs["pickle"]).all():
        raise AssertionError(
            f"[convert] the msgpack decodes "
            f"{np.abs(outs['pickle'] - outs['msgpack']).max()} from the "
            f"pickle; {launches} pair launches")
    log(f"[convert] bin/convert_checkpoint.py (reference pickle -> JAX "
        f"msgpack) in {seconds:.2f} s, {os.path.getsize(out):,} bytes; the "
        f"msgpack decodes bit-equal to the pickle ({launches} pair "
        f"launches)")
    return {"seconds": seconds, "launches": launches, "wav": outs["pickle"],
            "x": x}


def phase_pretrained(port: dict, seed: int, tmp: str, convert: dict) -> dict:
    """[pretrained] A local ``ThreadingHTTPServer`` serves a tarball of
    [convert]'s reference pickle under EXPORT_TAG behind a confirm-token
    interstitial; ``download_pretrained_model`` fetches and extracts it into
    a temporary cache, and the checkpoint decodes on the card as [convert]'s
    pickle did (bit-equal, 36 pairs a chunk)."""
    import io
    import tarfile
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    inference, pair, pretrained = (port[k] for k in (
        "inference", "resblock_pair", "pretrained"))
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz", compresslevel=1) as tar:
        tar.add(os.path.join(tmp, "ref", "checkpoint-100steps.pkl"),
                arcname="exp/train_all/checkpoint-100steps.pkl")
        tar.add(os.path.join(tmp, "ref", "config.yml"),
                arcname="exp/train_all/config.yml")
    archive, hits = buf.getvalue(), []

    class Drive(BaseHTTPRequestHandler):
        def do_GET(self):
            hits.append(self.path)
            confirmed = "confirm=" in self.path
            body = archive if confirmed else (
                b'<html><a href="#">Download anyway&amp;confirm=t0k</a>'
                b'</html>')
            self.send_response(200)
            self.send_header("Content-Type", "application/x-gzip" if confirmed
                             else "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Drive)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    saved = os.environ.get("ARTICULATORY_PRETRAIN_URL")
    os.environ["ARTICULATORY_PRETRAIN_URL"] = (
        f"http://127.0.0.1:{server.server_address[1]}/uc")
    try:
        start = time.perf_counter()
        path = pretrained.download_pretrained_model(
            EXPORT_TAG, download_dir=os.path.join(tmp, "cache"))
        seconds = time.perf_counter() - start
    finally:
        server.shutdown()
        thread.join()
        if saved is None:
            os.environ.pop("ARTICULATORY_PRETRAIN_URL")
        else:
            os.environ["ARTICULATORY_PRETRAIN_URL"] = saved
    config = port["load_config"](os.path.join(os.path.dirname(path),
                                              "config.yml"))
    pair.launches = 0
    model = inference.load_model(path, config, device="cuda")
    model.remove_weight_norm()
    wav = inference.ar_loop(model, convert["x"], config)
    launches = pair.launches
    chunks = -(-ENTRY_FRAMES // CHUNK_FRAMES)
    if len(hits) != 2 or not path.endswith("checkpoint-100steps.pkl") or \
            launches != 36 * chunks or not np.array_equal(wav, convert["wav"]):
        raise AssertionError(f"[pretrained] {len(hits)} requests, {path}, "
                             f"{launches} pair launches, the decode "
                             f"{np.abs(wav - convert['wav']).max()} from "
                             f"[convert]'s")
    log(f"[pretrained] download_pretrained_model('{EXPORT_TAG}') from a "
        f"local server behind a confirm interstitial: {len(archive):,} "
        f"bytes in {seconds:.2f} s, extracted to the cache; its checkpoint "
        f"decodes bit-equal to the pickle's ({launches} pair launches)")
    return {"seconds": seconds, "launches": launches, "bytes": len(archive)}


def phase_quality(seed: int, tmp: str) -> dict:
    """[quality] ``tools/bf16_quality_ab.sh`` of the port end to end at a
    tiny size (QUALITY_ENV, QUALITY_STEPS steps): corpus, features,
    training, the f32 / bf16 / hybrid / 1-ulp decodes and the MCDs, on the
    card without JAX. The MCDs at this size mean nothing; they are
    printed."""
    script = os.path.join(ROOT, "articulatory_tpu_torch", "tools",
                          "bf16_quality_ab.sh")
    env = dict(os.environ, DEVICE="cuda", **QUALITY_ENV)
    start = time.perf_counter()
    proc = subprocess.run(["bash", script, os.path.join(tmp, "ab"),
                           str(QUALITY_STEPS)], capture_output=True,
                          text=True, timeout=QUALITY_TIMEOUT_S, env=env,
                          cwd=ROOT)
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        raise AssertionError(f"[quality] the A/B failed ({proc.returncode}):"
                             f" {proc.stdout[-2000:]} {proc.stderr[-3000:]}")
    mcds, heading = {}, None
    for line in proc.stdout.splitlines():
        if line.startswith("== MCD("):
            heading = line.split(")")[0][len("== MCD("):]
        elif line.startswith("mean MCD") and heading:
            mcds[heading] = float(line.split(":")[1].split()[0])
    if len(mcds) != 7 or not all(np.isfinite(v) for v in mcds.values()):
        raise AssertionError(f"[quality] MCDs {mcds}: {proc.stdout[-2000:]}")
    log(f"[quality] tools/bf16_quality_ab.sh, {QUALITY_STEPS} steps on "
        f"{QUALITY_ENV['N_UTTS']} utterances: {seconds:.1f} s; MCD dB "
        + ", ".join(f"({k}) {v:.3f}" for k, v in mcds.items()))
    return {"seconds": seconds, "mcd": mcds}


def _cotrain_eval_launches(gp: dict, forwards: int) -> dict:
    """The launches of ``forwards`` float32 generator forwards without
    grad (the harness's evaluations): each stage's pairs, each splitting
    its weights; no head."""
    pairs = (sum(len(d) for d in gp["resblock_dilations"])
             * len(gp["upsample_scales"]) * forwards)
    return {"resblock_pair": {str(torch.float32): pairs} if pairs else {},
            "scale_disc_head": {}, "split_tf32": pairs, "split_weights": 0}


def cotrain_worker(workdir: str) -> int:
    """[cotrain]'s arms in turns in a process of their own
    (``--cotrain-worker``): the port leg of the COTRAIN_PROFILE artifact,
    ``against`` on the card, with the hand kernels, then with their plain
    versions swapped in; writes each arm's report to ``workdir``."""
    sys.path.insert(0, ROOT)
    from articulatory_tpu_torch.tools import cotrain_parity
    from articulatory_tpu_torch.utils.device import set_float32_parity

    set_float32_parity()
    torch.set_num_threads(COTRAIN_THREADS)
    port = training_port()
    for arm in COTRAIN_ARMS:
        start = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if arm == "plain":
                stack.enter_context(swapped(port["residual"], "resblock_pair",
                                            port["resblock_pair_plain"]))
                stack.enter_context(swapped(port["hifigan"], "scale_disc_head",
                                            port["scale_disc_head_plain"]))
            report = cotrain_parity.against(
                cotrain_parity.artifact_path(COTRAIN_PROFILE), "cuda")
        report["arm_seconds"] = time.perf_counter() - start
        with open(os.path.join(workdir, f"{arm}.json"), "w") as f:
            json.dump(report, f)
    return 0


def start_cotrain(workdir: str) -> tuple:
    """Start [cotrain]'s process (``cotrain_worker``: the arms in turns,
    host-bound at B 2, so they run beside [quality]); ``phase_cotrain``
    waits for it, ``stop_cotrain`` ends it if the phases between fail."""
    return time.perf_counter(), subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cotrain-worker",
         workdir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=ROOT)


def stop_cotrain(started: tuple) -> None:
    _, proc = started
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


def phase_cotrain(workdir: str, started: tuple) -> dict:
    """[cotrain] ``tools/cotrain_parity.py --against`` the committed
    f32-wide artifact (COTRAIN_PROFILE), its arms run in turns by the
    process ``start_cotrain`` started: the e2w_hifigan_car generator at
    full width and its discriminator trained 300 steps (B 2 x 2000) from
    the artifact's seed,
    the inputs' digests equal to the artifact's (``against`` raises
    otherwise), with the hand kernels as the training path launches them
    and with their plain versions swapped in. Each arm must pass the
    artifact's checks against the JAX trajectory and decodes (pre-disc
    mel, eval-mel, decode MCD, each within its budget or twice JAX's own
    cone over its four controls; both sides learn; the discriminator from
    its start step on)
    and launch exactly the kernels ``expected_launches`` gives for its
    steps (none in the plain arm), and the evaluations' pairs."""
    from articulatory_tpu_torch.tools import cotrain_parity

    results, waited = {}, time.perf_counter()
    t0, proc = started
    try:
        out, _ = proc.communicate(timeout=COTRAIN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise AssertionError(f"[cotrain] the arms ran past "
                             f"{COTRAIN_TIMEOUT_S} s: {out[-3000:]}")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[cotrain] the arms failed "
                             f"({proc.returncode}): {out[-3000:]}")
    for arm in COTRAIN_ARMS:
        with open(os.path.join(workdir, f"{arm}.json")) as f:
            report = json.load(f)
        a = cotrain_parity.settings(report)
        gp, run, c = report["gen_cfg"], report["port"], report["checks"]
        config = cotrain_parity.train_config(a, gp, report["disc_cfg"])
        forwards = len(run["evals"]) * a.n_eval_batches
        none = _cotrain_eval_launches(gp, 0)
        want = ({"train": expected_launches(config, a.steps),
                 "eval": _cotrain_eval_launches(gp, forwards)}
                if arm == "kernel" else {"train": none, "eval": none})
        got = {k: run["launches"][k] for k in ("train", "eval")}
        decode_pairs = sum(run["launches"]["decode"]["resblock_pair"].values())
        log(f"[cotrain] {arm} arm: {a.steps} steps in {run['seconds']:.3f} s "
            f"({1e3 * run['seconds'] / a.steps:.3f} ms a step, "
            f"{len(run['evals'])} evaluations in it), decodes "
            f"{run['decode_seconds']:.3f} s, inputs remade in "
            f"{report['setup_seconds']:.3f} s with digests equal to the "
            f"artifact's; the arm {report['arm_seconds']:.3f} s (the "
            f"process of both {wall:.3f} s)")
        log(f"[cotrain] {arm} arm: " + "; ".join(
            f"{what} {c.get(key)} (bound {c.get(key + '_bound')}, JAX's "
            f"cone {c.get(key + '_cone')})" for what, key in (
                ("pre-disc mel max rel", "pre_disc_mel_max_rel"),
                ("eval-mel max rel", "eval_mel_max_rel"),
                ("decode MCD(port, JAX) worst dB", "worst_mcd_port_vs_jax")))
            + "; per utterance " + ", ".join(
                f"{r['mcd_port_vs_jax']:.3f}" for r in report["decode"])
            + "; MCD(port, gt) - MCD(JAX, gt) "
            + ", ".join(f"{d:+.3f}" for d in c["gt_mcd_delta_per_utt"])
            + f"; eval mel first/last port {c.get('port_eval_first_last')}, "
            f"JAX {c.get('jax_eval_first_last')}")
        log(f"[cotrain] {arm} arm: launches train {got['train']}, evaluations "
            f"{got['eval']}, decodes {run['launches']['decode']}")
        if got != want:
            raise AssertionError(f"[cotrain] {arm} arm launched {got}, "
                                 f"expected {want}")
        if arm == "kernel" and decode_pairs < a.n_decode:
            raise AssertionError(f"[cotrain] the decodes launched "
                                 f"{decode_pairs} pairs")
        if not report["ok"]:
            raise AssertionError(f"[cotrain] {arm} arm: {report['failures']}")
        results[arm] = {"seconds": report["arm_seconds"], "process_s": wall,
                        "train_seconds": run["seconds"],
                        "decode_seconds": run["decode_seconds"],
                        "setup_seconds": report["setup_seconds"],
                        "checks": c, "launches": run["launches"],
                        "decode": report["decode"],
                        "evals": run["evals"]}
    results["waited_s"] = time.perf_counter() - waited
    log(f"[cotrain] the arms ended {results['waited_s']:.3f} s after the "
        f"phase began waiting for them")
    return results


def training_port() -> dict:
    """The port's modules and kernel wrappers that the training phases
    (``phase_train``, ``phase_hybrid_train`` and those built on them)
    take; ``bin/ab_phase.py`` runs ``phase_hybrid_train`` with it too."""
    from articulatory_tpu_torch import inference
    from articulatory_tpu_torch.bin import train
    from articulatory_tpu_torch.data import collate
    from articulatory_tpu_torch.layers import residual
    from articulatory_tpu_torch.models import build_model, hifigan
    from articulatory_tpu_torch.ops import resblock_pair as pair
    from articulatory_tpu_torch.ops import scale_disc_head as head
    from articulatory_tpu_torch.train import gan
    from articulatory_tpu_torch.train.optimizers import build_optimizer
    from articulatory_tpu_torch.train.trainer import to_device

    return dict(
        train=train, gan=gan, inference=inference, residual=residual,
        hifigan=hifigan, build_model=build_model, to_device=to_device,
        resblock_pair=pair.resblock_pair,
        resblock_pair_backward=pair.resblock_pair_backward,
        resblock_pair_plain=pair.resblock_pair_plain,
        split_tf32=pair.split_tf32, scale_disc_head=head.scale_disc_head,
        split_weights=head.split_weights,
        scale_disc_head_plain=head.scale_disc_head_plain,
        build_optimizer=build_optimizer, collate=collate)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--rank-worker", default=None,
                        help="run one rank of the [dp] / [tp] phases on "
                             "this directory's spec (the launcher passes "
                             "it)")
    parser.add_argument("--cotrain-worker", default=None,
                        help="run [cotrain]'s arms in turns, writing their "
                             "reports to this directory")
    parser.add_argument("--export-worker", default=None,
                        help="run [export]'s fresh process on this "
                             "directory's programs")
    args = parser.parse_args()
    if args.rank_worker:
        return rank_worker(args.rank_worker)
    if args.export_worker:
        return export_worker(args.export_worker)
    if args.cotrain_worker:
        return cotrain_worker(args.cotrain_worker)

    smi, device_name = phase_device()
    sys.path.insert(0, ROOT)
    from articulatory_tpu_torch import inference, streaming
    from articulatory_tpu_torch.bin import convert_checkpoint, decode
    from articulatory_tpu_torch.bin import model_stats, predict_ema
    from articulatory_tpu_torch.bin import predict_wav
    from articulatory_tpu_torch.layers import residual
    from articulatory_tpu_torch.models import build_model
    from articulatory_tpu_torch.ops import _build
    from articulatory_tpu_torch.ops.interp import interpolate_linear_scale
    from articulatory_tpu_torch.ops.resblock_pair import (
        resblock_pair,
        resblock_pair_plain,
        split_tf32,
        split_tf32_plain,
    )
    from articulatory_tpu_torch.ops.scale_disc_head import (
        scale_disc_head,
        scale_disc_head_plain,
        split_weights,
        split_weights_plain,
    )
    from articulatory_tpu_torch.utils import weights
    from articulatory_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        save_msgpack,
    )
    from articulatory_tpu_torch.utils.device import set_float32_parity
    from articulatory_tpu_torch.utils.io import read_wav, write_wav

    set_float32_parity()
    build_seconds = phase_build(_build)
    splits = (split_tf32, split_tf32_plain)
    rows = phase_kernel(resblock_pair, resblock_pair_plain, splits, args.seed,
                        UTTS, CHUNK_FRAMES)
    host_us = {"inference_mode": host_us_per_launch(resblock_pair, False),
               "requires_grad": host_us_per_launch(resblock_pair, True)}
    log(f"[kernel] host time per launch: {host_us['inference_mode']:.2f} us "
        f"under inference_mode, {host_us['requires_grad']:.2f} us with "
        f"inputs that require grad")
    by_dtype = kernel_sums(rows)
    by_stage = stage_sums(rows)
    for dtype, sums in by_dtype.items():
        log(f"[kernel] {dtype}: 36 main-path shapes at B={UTTS}: "
            f"{sum_line(dtype, sums)}")
    log_stage_sums(by_stage, UTTS)
    head_rows = phase_head_kernel(scale_disc_head, scale_disc_head_plain,
                                  (split_weights, split_weights_plain),
                                  args.seed)
    for r in head_rows:
        f32 = (f", FMA bound {r['fma_bound_ms']:.4f} ms; error against "
               f"float64 {r['f64_rel_err']:.3e} of max |h| (limit {F64_TOL}), "
               f"cuDNN f32's {r['plain_f64_rel_err']:.3e}"
               if r["dtype"] == "float32" else "")
        log(f"[head] B{r['B']} T{r['T']} s{r['stride']} {r['dtype']}: kernel "
            f"{r['kernel_ms']:.4f} ms (weight split {r['split_ms']:.4f} ms "
            f"of it), plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{100 * r['bound_ms'] / r['kernel_ms']:.1f} % of the bound, max "
            f"rel err {r['max_rel_err']:.2e}{f32}")
    head_host_us = {
        "no_grad_inputs": head_host_us_per_launch(scale_disc_head, False),
        "requires_grad": head_host_us_per_launch(scale_disc_head, True)}
    log(f"[head] host time per head call (split and head launches): "
        f"{head_host_us['no_grad_inputs']:.2f} us with inputs that do not "
        f"require grad, {head_host_us['requires_grad']:.2f} us with inputs "
        f"that do")
    batch = TRAIN_CONFIG["batch_size"]
    train_frames = TRAIN_CONFIG["batch_max_steps"] // CONFIG["hop_size"]
    train_rows = phase_kernel(resblock_pair, resblock_pair_plain, splits,
                              args.seed, batch, train_frames)
    train_sums = kernel_sums(train_rows)
    train_stages = stage_sums(train_rows)
    for dtype, sums in train_sums.items():
        log(f"[kernel] {dtype}: 36 training shapes at B={batch}: "
            f"{sum_line(dtype, sums)}")
    log_stage_sums(train_stages, batch)
    train_backward = phase_pair_backward("pair-backward", args.seed, batch,
                                         train_frames)
    banded = phase_banded_attention(args.seed)
    port = dict(inference=inference, residual=residual,
                resblock_pair=resblock_pair, plain=resblock_pair_plain,
                split=split_tf32, weights=weights, decode=decode,
                warmup_steps=inference.WARMUP_STEPS)
    with tempfile.TemporaryDirectory() as tmp:
        slice_results = phase_slice(port, args.seed, device_name, tmp)
    train_port = training_port()
    with tempfile.TemporaryDirectory() as tmp:
        _write_corpus(tmp, args.seed)
        train_results = phase_train(train_port, args.seed, tmp)
        hybrid = phase_hybrid_train(train_port, args.seed, tmp)

    # the MRI recipe: its pair and head shapes, its decode, its training
    mri = mri_config()
    mri_gp = mri["generator_params"]
    mri_frames = mri["batch_max_steps"] // mri["hop_size"]
    mri_rows = phase_kernel(resblock_pair, resblock_pair_plain, splits,
                            args.seed, MRI_UTTS, mri_frames, gp=mri_gp)
    mri_sums, mri_stages = kernel_sums(mri_rows), stage_sums(mri_rows)
    for dtype, sums in mri_sums.items():
        log(f"[mri-kernel] {dtype}: 36 MRI shapes at B={MRI_UTTS}, "
            f"{mri_frames} frames: {sum_line(dtype, sums)}")
    log_stage_sums(mri_stages, MRI_UTTS)
    mri_backward = phase_pair_backward("mri-pair-backward", args.seed,
                                       MRI_UTTS, mri_frames, gp=mri_gp)
    mri_head_rows = phase_head_kernel(scale_disc_head, scale_disc_head_plain,
                                      (split_weights, split_weights_plain),
                                      args.seed, shapes=MRI_HEAD_SHAPES)
    for r in mri_head_rows:
        log(f"[mri-head] B{r['B']} T{r['T']} s{r['stride']} {r['dtype']}: "
            f"kernel {r['kernel_ms']:.4f} ms (weight split "
            f"{r['split_ms']:.4f} ms of it), plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{100 * r['bound_ms'] / r['kernel_ms']:.1f} % of the bound, "
            f"max rel err {r['max_rel_err']:.2e}, error against float64 "
            f"{r['f64_rel_err']:.3e}")
    with tempfile.TemporaryDirectory() as tmp:
        mri_results = phase_mri(port, args.seed, device_name, tmp)
    mri_train_config = dict(mri, train_max_steps=MRI_TRAIN_STEPS,
                            save_interval_steps=200000,
                            eval_interval_steps=200000, log_interval_steps=100)
    with tempfile.TemporaryDirectory() as tmp:
        _write_corpus(tmp, args.seed, mri_train_config, MRI_TRAIN_UTTS,
                      MRI_TRAIN_SECONDS,
                      mri_gp["in_channels"] - mri_gp["ar_output"])
        mri_train = phase_train(train_port, args.seed, tmp,
                                config=mri_train_config, grads=False,
                                tag="mri-train")

    # inversion and streaming
    port.update(streaming=streaming, predict_ema=predict_ema,
                write_wav=write_wav)
    with tempfile.TemporaryDirectory() as tmp:
        w2a = phase_w2a(port, args.seed, device_name, tmp)
        w2a_ar = phase_w2a_ar(port, args.seed, device_name, tmp)
        w2a_cli = phase_w2a_cli(port, args.seed, tmp)
        stream = phase_stream(port, args.seed, device_name, tmp)

    # the zoo: the multi-band shapes of both kernels, then each family
    mb = zoo_configs()
    mb_gp = mb["mb-hifigan"]["generator_params"]
    mb_rows = phase_kernel(resblock_pair, resblock_pair_plain, splits,
                           args.seed, MB_BATCH, MB_FRAMES, gp=mb_gp)
    mb_sums, mb_stages = kernel_sums(mb_rows), stage_sums(mb_rows)
    for dtype, sums in mb_sums.items():
        log(f"[mb-kernel] {dtype}: 27 multi-band shapes at B={MB_BATCH}, "
            f"{MB_FRAMES} frames: {sum_line(dtype, sums)}")
    log_stage_sums(mb_stages, MB_BATCH)
    mb_head_rows = phase_head_kernel(scale_disc_head, scale_disc_head_plain,
                                     (split_weights, split_weights_plain),
                                     args.seed, shapes=MB_HEAD_SHAPES)
    for r in mb_head_rows:
        log(f"[mb-head] B{r['B']} T{r['T']} s{r['stride']} {r['dtype']}: "
            f"kernel {r['kernel_ms']:.4f} ms (weight split "
            f"{r['split_ms']:.4f} ms of it), plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{100 * r['bound_ms'] / r['kernel_ms']:.1f} % of the bound, "
            f"max rel err {r['max_rel_err']:.2e}, error against float64 "
            f"{r['f64_rel_err']:.3e}")
    zoo_port = dict(train_port, decode=decode, read_wav=read_wav)
    zoo = {}
    for family, config in mb.items():
        with tempfile.TemporaryDirectory() as tmp:
            zoo[family] = phase_zoo(zoo_port, family, config, args.seed,
                                    device_name, tmp)

    # conditioning and cascades
    cond_port = dict(zoo_port, weights=weights, plain=resblock_pair_plain,
                     split=split_tf32, warmup_steps=inference.WARMUP_STEPS,
                     interpolate_linear_scale=interpolate_linear_scale)
    with tempfile.TemporaryDirectory() as tmp:
        cond_train = phase_cond_train(cond_port, args.seed, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        cond_decode = phase_cond_decode(cond_port, args.seed, device_name, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        cascade = phase_cascade(cond_port, args.seed, device_name, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        ph2a = phase_ph2a(cond_port, args.seed, device_name, tmp)
    mult = phase_mult(cond_port, args.seed, device_name)

    # the recipe end to end on the port alone
    recipe_port = dict(train_port, decode=decode, write_wav=write_wav,
                       read_wav=read_wav, load_checkpoint=load_checkpoint)
    with tempfile.TemporaryDirectory() as tmp:
        recipe = phase_recipe(recipe_port, args.seed, device_name, tmp)

    # the entry points, int8 / bf16 storage of the zoo, causal convs, and
    # the _h2 inversion after HuBERT
    entry_port = dict(inference=inference, resblock_pair=resblock_pair,
                      plain=resblock_pair_plain, residual=residual,
                      read_wav=read_wav, decode=decode,
                      predict_wav=predict_wav, model_stats=model_stats,
                      convert_checkpoint=convert_checkpoint,
                      save_msgpack=save_msgpack)
    with tempfile.TemporaryDirectory() as tmp:
        entry = phase_entry(entry_port, args.seed, device_name, tmp)
    storage_port = dict(inference=inference, resblock_pair=resblock_pair,
                        plain=resblock_pair_plain, residual=residual,
                        build_model=build_model, weights=weights)
    with tempfile.TemporaryDirectory() as tmp:
        storage = phase_storage_zoo(storage_port, args.seed, device_name, tmp)
    causal = {}
    for family, config in causal_configs().items():
        with tempfile.TemporaryDirectory() as tmp:
            causal[family] = phase_zoo(zoo_port, family, config, args.seed,
                                       device_name, tmp, tag=family)
    ssl_port = dict(inference=inference, predict_ema=predict_ema,
                    weights=weights, read_wav=read_wav, write_wav=write_wav)
    with tempfile.TemporaryDirectory() as tmp:
        ssl = phase_ssl(ssl_port, args.seed, device_name, tmp)

    # parallelism: data and tensor parallel training through the launcher
    # (two ranks sharing the card), pipeline and sequence-parallel serving
    from articulatory_tpu_torch.parallel import pp

    par_port = dict(train_port, load_checkpoint=load_checkpoint)
    with tempfile.TemporaryDirectory() as tmp:
        _write_corpus(tmp, args.seed)
        parallel = {mode: phase_parallel(par_port, mode, args.seed, tmp)
                    for mode in ("dp", "dp-native", "tp")}
    log("[dp-native] a rank's step median, native / host loader (the "
        "loader's time between steps): " + "; ".join(
            f"rank {n['rank']} {n['step_ms_median']:.3f} / "
            f"{h['step_ms_median']:.3f} ms ({n['gap_ms_median']:.3f} / "
            f"{h['gap_ms_median']:.3f} ms)"
            for n, h in zip(parallel["dp-native"]["ranks"],
                            parallel["dp"]["ranks"])))
    pp_results = phase_pp(dict(pp=pp, resblock_pair=resblock_pair,
                               build_model=build_model), args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        sp = phase_sp(dict(inference=inference, decode=decode,
                           resblock_pair=resblock_pair,
                           build_model=build_model, read_wav=read_wav),
                      args.seed, tmp)
    past_seq = phase_past_seq(args.seed, device_name)

    # export, the reference-to-JAX conversion, the registry's downloader
    # and the quality A/B tool chain
    from articulatory_tpu_torch import export
    from articulatory_tpu_torch.config import load_config
    from articulatory_tpu_torch.utils import pretrained

    tools_port = dict(inference=inference, weights=weights, export=export,
                      resblock_pair=resblock_pair, plain=resblock_pair_plain,
                      residual=residual, load_config=load_config,
                      convert_checkpoint=convert_checkpoint,
                      load_checkpoint=load_checkpoint, pretrained=pretrained)
    with tempfile.TemporaryDirectory() as tmp:
        exported = phase_export(tools_port, args.seed, device_name, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        converted = phase_convert(tools_port, args.seed, tmp)
        fetched = phase_pretrained(tools_port, args.seed, tmp, converted)
    # [quality] and the co-training parity arms side by side: both are
    # host-bound, and the machine has cores to spare
    with tempfile.TemporaryDirectory() as tmp:
        cotrain_started = start_cotrain(tmp)
        try:
            with tempfile.TemporaryDirectory() as qtmp:
                quality = phase_quality(args.seed, qtmp)
        except BaseException:
            stop_cotrain(cotrain_started)
            raise
        cotrain = phase_cotrain(tmp, cotrain_started)

    f32 = by_dtype["float32"]
    pair_entry = {
        "name": "resblock_pair", "route": "cuda",
        "source": "articulatory_tpu_torch/csrc/resblock_pair.cu",
        "replaces": "articulatory_tpu/ops/pallas/resblock.py:98",
        # the decode path's run (2 modes x 20 chunks); the training path's
        # launches beside it
        "launches": slice_results["launches_total"],
        "launches_train": train_results["launches"]["resblock_pair"],
        # the 36 main-path shapes of one chunk forward, float32 (3xTF32;
        # ms includes the weight split, split_ms alone); bound_ms at three
        # tf32 products a multiply-add, fma_bound_ms at the fp32 FMA rate
        "max_abs_err": f32["max_abs_err"], "ms": f32["kernel_ms"],
        "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
        "bound_by": ("operations" if f32["ops_ms"] >= f32["bytes_ms"]
                     else "bytes"),
        "library_ms": None,
        "fma_bound_ms": f32["fma_bound_ms"], "split_ms": f32["split_ms"],
        "f64_max_rel_err": f32["f64_rel_err"],
        "plain_f64_max_rel_err": f32["plain_f64_rel_err"],
        "split_launches_train": train_results["launches"]["split_tf32"],
        # the decode's splits: in the first chunk (warm-up), then cached
        "split_launches_decode_warmup": slice_results["split_launches_warmup"],
        "split_launches_decode": slice_results["split_launches"],
        "stage_ms": [st["kernel_ms"] for st in by_stage["float32"]],
        "stage_plain_ms": [st["plain_ms"] for st in by_stage["float32"]],
        "stage_bound_ms": [st["bound_ms"] for st in by_stage["float32"]],
        "bf16_ms": by_dtype["bfloat16"]["kernel_ms"],
        "bf16_plain_ms": by_dtype["bfloat16"]["plain_ms"],
        "bf16_bound_ms": by_dtype["bfloat16"]["bound_ms"],
        "bf16_max_abs_err": by_dtype["bfloat16"]["max_abs_err"],
        # per generator stage (C 256, 128, 64, 32), the decode's shapes
        "bf16_stage_ms": [st["kernel_ms"] for st in by_stage["bfloat16"]],
        "bf16_stage_plain_ms": [st["plain_ms"]
                                for st in by_stage["bfloat16"]],
        "bf16_stage_bound_ms": [st["bound_ms"]
                                for st in by_stage["bfloat16"]],
        "train_shapes_ms": train_sums["float32"]["kernel_ms"],
        "train_shapes_plain_ms": train_sums["float32"]["plain_ms"],
        "train_shapes_bound_ms": train_sums["float32"]["bound_ms"],
        "train_shapes_f64_max_rel_err": train_sums["float32"]["f64_rel_err"],
        "train_shapes_bf16_ms": train_sums["bfloat16"]["kernel_ms"],
        "train_shapes_bf16_plain_ms": train_sums["bfloat16"]["plain_ms"],
        "train_shapes_bf16_bound_ms": train_sums["bfloat16"]["bound_ms"],
        "host_us_per_launch": host_us,
        # inside the captured loop (CUDA-graph replays run no Python): the
        # pair kernels the profiler counted over PROFILE_CHUNKS replays
        "launches_graph_profiled": {
            f"{tag}/{mode}": r["profile"]["kernel_counts"]["resblock_pair_wgmma"]
            for tag, graph in (("ema", slice_results["graph"]),
                               ("mri", mri_results["graph"]))
            for mode, r in graph.items()},
        "launches_mri_decode": mri_results["launches_total"],
        "launches_mri_train": mri_train["launches"]["resblock_pair"],
        # the MRI recipe's 36 shapes (B 16, 125 frames: T 1000 to 30000),
        # its decode chunk's and its training step's
        "mri_shapes_ms": mri_sums["float32"]["kernel_ms"],
        "mri_shapes_plain_ms": mri_sums["float32"]["plain_ms"],
        "mri_shapes_bound_ms": mri_sums["float32"]["bound_ms"],
        "mri_shapes_f64_max_rel_err": mri_sums["float32"]["f64_rel_err"],
        "mri_shapes_bf16_ms": mri_sums["bfloat16"]["kernel_ms"],
        "mri_shapes_bf16_plain_ms": mri_sums["bfloat16"]["plain_ms"],
        "mri_shapes_bf16_bound_ms": mri_sums["bfloat16"]["bound_ms"],
        # the streaming server's captured round (replays run no Python):
        # the pair kernels the profiler counted over PROFILE_CHUNKS rounds
        "launches_stream_profiled": {
            mode: stream[mode]["pair_launches_profiled"]
            for mode in ("f32", "hybrid_bf16")},
        # the multi-band HiFi-GAN path (27 pairs a forward): its training
        # run, its decode, its profiled forwards; its 27 shapes (B 32, 100
        # frames: C 256/128/64 at T 500/1000/2000)
        "launches_multiband_train": zoo["mb-hifigan"]["launches"][
            "resblock_pair"],
        "launches_multiband_decode": zoo["mb-hifigan"]["decode"][
            "pair_launches"],
        "launches_multiband_profiled": zoo["mb-hifigan"]["profile"][
            "kernel_counts"]["resblock_pair_wgmma"],
        **{f"multiband_shapes_{key}": {d: mb_sums[d][key]
                                       for d in ("float32", "bfloat16")}
           for key in ("kernel_ms", "plain_ms", "bound_ms")},
        "multiband_shapes_f64_max_rel_err": mb_sums["float32"]["f64_rel_err"],
        # conditioning and cascades: the conditioned training run (72 a
        # step) and its PCD step; the phoneme-head decode, eager (36 a
        # chunk) and replayed (36 a replay, profiled); the cascade's run
        # (18 a step: the frozen stage's forward, input-only backward and
        # regeneration); the multimodal decode
        "launches_cond_train": cond_train["launches"]["resblock_pair"],
        "launches_pcd_step": cond_train["pcd"]["launches"]["resblock_pair"],
        "launches_cond_decode": {mode: cond_decode[mode]["launches"]
                                 for mode in ("f32", "hybrid_bf16")},
        "launches_cond_decode_profiled": {
            mode: r["profile"]["kernel_counts"]["resblock_pair_wgmma"]
            for mode, r in cond_decode["graph"].items()},
        "launches_cascade_train": cascade["launches"]["resblock_pair"],
        "launches_mult": mult["launches"],
        # the recipe's stage 2 from the corpus cache (72 a step), and the
        # kernels the profiler counted in its profiled step
        "launches_recipe_train": recipe["launches"]["resblock_pair"],
        "launches_recipe_profiled": recipe["profiled_step"]["kernel_counts"][
            "resblock_pair_wgmma"],
        # [hybrid-train]: the hybrid run through train() (per dtype), the
        # counted step of each variant, the use_remat and m2w steps, and
        # the kernels the profiler counted in the profiled hybrid step
        "launches_hybrid_train": hybrid["launches_by_dtype"]["resblock_pair"],
        "launches_hybrid_steps": {
            k: v["counted_step"]["launches"]["resblock_pair"]
            for k, v in hybrid["turns"].items()},
        "launches_remat_step": hybrid["remat_step"]["launches"][
            "resblock_pair"],
        "launches_m2w_step": hybrid["m2w_step"]["launches"]["resblock_pair"],
        "launches_hybrid_profiled": hybrid["profiled_step"]["kernel_counts"][
            "resblock_pair_wgmma"],
        # [entry]: predict_wav (36 a chunk), model_stats (36 a forward) per
        # precision, and the converted pickle's and the msgpack's decodes
        "launches_predict_wav": {mode: entry[mode]["predict_launches"]
                                 for mode in ("f32", "hybrid_bf16")},
        "launches_model_stats": {mode: entry[mode]["model_stats_launches"]
                                 for mode in ("f32", "hybrid_bf16")},
        "launches_convert_decode": entry["convert_launches"],
        # [storage-zoo]: one multi-band forward per weight storage
        "launches_storage_multiband": storage["mb-hifigan"]["pair_launches"],
        # [dp] / [tp]: a step's launches on each rank (two ranks sharing
        # the card); [pp]: a call of each pipeline (36 a microbatch); [sp]:
        # the tiled forward (36 a tile) and its decode
        **{f"launches_{mode.replace('-', '_')}_per_rank_step": {
            r: c["resblock_pair"] for r, c in
            parallel[mode]["launches_per_step"].items()}
           for mode in ("dp", "dp-native", "tp")},
        "launches_pp": {k: v["launches"] for k, v in pp_results.items()},
        "launches_sp": sp["sequence_parallel"]["launches"],
        "launches_sp_decode": sp["decode_launches"],
        # [export]: the loaded program's forwards here (36 a forward, f32
        # and hybrid) and in the fresh process; [convert]: the pickle's and
        # the msgpack's decodes; [pretrained]: the downloaded checkpoint's
        "launches_export": exported["launches"],
        "launches_export_fresh_process": {
            mode: exported[mode]["worker_launches"]
            for mode in ("f32", "hybrid_bf16")},
        "launches_convert": converted["launches"],
        "launches_pretrained": fetched["launches"],
        # [cotrain]: the 300 training steps of the f32-wide co-training
        # run (72 a step) and its evaluations (36 a forward)
        "launches_cotrain_train": cotrain["kernel"]["launches"]["train"][
            "resblock_pair"],
        "launches_cotrain_eval": cotrain["kernel"]["launches"]["eval"][
            "resblock_pair"],
    }
    main_head = [r for r in head_rows if r["stride"] == 4]
    head_f32 = [r for r in main_head if r["dtype"] == "float32"]
    head_bf16 = [r for r in main_head if r["dtype"] == "bfloat16"]
    pallas = {r["dtype"]: r for r in head_rows if r["stride"] == 2}
    head_entry = {
        "name": "scale_disc_head", "route": "cuda",
        "source": "articulatory_tpu_torch/csrc/scale_disc_head.cu",
        "replaces": "articulatory_tpu/ops/pallas/scale_disc_head.py:150",
        "launches": train_results["launches"]["scale_disc_head"],
        # the training path's three scales (one MSMPD pass), float32 (3xTF32;
        # ms includes the weight split, split_ms alone); bound_ms at three
        # tf32 products a multiply-add, fma_bound_ms at the fp32 FMA rate
        "max_abs_err": max(r["max_abs_err"] for r in head_f32),
        "ms": sum(r["kernel_ms"] for r in head_f32),
        "plain_ms": sum(r["plain_ms"] for r in head_f32),
        "bound_ms": sum(r["bound_ms"] for r in head_f32),
        "bound_by": ("operations" if sum(r["ops_ms"] for r in head_f32)
                     >= sum(r["bytes_ms"] for r in head_f32) else "bytes"),
        # no single PyTorch call computes both layers with the mask
        "library_ms": None,
        "fma_bound_ms": sum(r["fma_bound_ms"] for r in head_f32),
        "f64_rel_err": max(r["f64_rel_err"] for r in head_rows
                           if r["dtype"] == "float32"),
        "plain_f64_rel_err": max(r["plain_f64_rel_err"] for r in head_rows
                                 if r["dtype"] == "float32"),
        "split_ms": sum(r["split_ms"] for r in head_f32),
        "split_launches_train": train_results["launches"]["split_weights"],
        "host_us_per_launch": head_host_us,
        "bf16_ms": sum(r["kernel_ms"] for r in head_bf16),
        "bf16_plain_ms": sum(r["plain_ms"] for r in head_bf16),
        "bf16_bound_ms": sum(r["bound_ms"] for r in head_bf16),
        "bf16_max_abs_err": max(r["max_abs_err"] for r in head_bf16),
        "pallas_shape_ms": {d: r["kernel_ms"] for d, r in pallas.items()},
        "pallas_shape_plain_ms": {d: r["plain_ms"] for d, r in pallas.items()},
        "pallas_shape_bound_ms": {d: r["bound_ms"] for d, r in pallas.items()},
        "launches_mri_train": mri_train["launches"]["scale_disc_head"],
        # the MRI training step's three scales (B 16, T 30512/15257/7629)
        **{f"mri_shapes_{key}": {d: sum(r[key] for r in mri_head_rows
                                        if r["dtype"] == d)
                                 for d in ("float32", "bfloat16")}
           for key in ("kernel_ms", "plain_ms", "bound_ms")},
        # the multi-band HiFi-GAN training run (3 scales x 4 passes a
        # step) and its three scales (B 32, T 8000/4001/2001, stride 4)
        "launches_multiband_train": zoo["mb-hifigan"]["launches"][
            "scale_disc_head"],
        **{f"multiband_shapes_{key}": {d: sum(r[key] for r in mb_head_rows
                                              if r["dtype"] == d)
                                       for d in ("float32", "bfloat16")}
           for key in ("kernel_ms", "plain_ms", "bound_ms")},
        # the conditioned training run (3 scales x 4 passes a step); none
        # in the PCD step or the cascade (3 and 13 channels: plain convs)
        "launches_cond_train": cond_train["launches"]["scale_disc_head"],
        "launches_pcd_step": cond_train["pcd"]["launches"]["scale_disc_head"],
        "launches_cascade_train": cascade["launches"]["scale_disc_head"],
        "launches_recipe_train": recipe["launches"]["scale_disc_head"],
        "launches_recipe_profiled": recipe["profiled_step"]["kernel_counts"][
            "scale_disc_head_wgmma"],
        "launches_hybrid_train": hybrid["launches_by_dtype"][
            "scale_disc_head"],
        "launches_hybrid_steps": {
            k: v["counted_step"]["launches"]["scale_disc_head"]
            for k, v in hybrid["turns"].items()},
        "launches_remat_step": hybrid["remat_step"]["launches"][
            "scale_disc_head"],
        "launches_m2w_step": hybrid["m2w_step"]["launches"][
            "scale_disc_head"],
        "launches_hybrid_profiled": hybrid["profiled_step"]["kernel_counts"][
            "scale_disc_head_wgmma"],
        **{f"launches_{mode.replace('-', '_')}_per_rank_step": {
            r: c["scale_disc_head"] for r, c in
            parallel[mode]["launches_per_step"].items()}
           for mode in ("dp", "dp-native", "tp")},
        "launches_cotrain_train": cotrain["kernel"]["launches"]["train"][
            "scale_disc_head"],
    }
    kernels = [pair_entry, head_entry]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "build_seconds": build_seconds,
                   "kernel_shapes": rows, "kernel_totals": by_dtype,
                   "kernel_stages": by_stage,
                   "kernel_train_shapes": train_rows,
                   "kernel_train_totals": train_sums,
                   "kernel_train_stages": train_stages,
                   "pair_backward_train": train_backward,
                   "pair_backward_mri": mri_backward,
                   "banded_attention": banded,
                   "head_shapes": head_rows, "slice": slice_results,
                   "train": train_results, "hybrid_train": hybrid,
                   "mri_kernel_shapes": mri_rows,
                   "mri_kernel_totals": mri_sums,
                   "mri_kernel_stages": mri_stages,
                   "mri_head_shapes": mri_head_rows, "mri": mri_results,
                   "mri_train": mri_train, "w2a": w2a, "w2a_ar": w2a_ar,
                   "w2a_cli": w2a_cli, "stream": stream,
                   "mb_kernel_shapes": mb_rows, "mb_kernel_totals": mb_sums,
                   "mb_kernel_stages": mb_stages,
                   "mb_head_shapes": mb_head_rows, "zoo": zoo,
                   "cond_train": cond_train, "cond_decode": cond_decode,
                   "cascade": cascade, "ph2a": ph2a, "mult": mult,
                   "recipe": recipe, "entry": entry, "storage_zoo": storage,
                   "causal": causal, "ssl": ssl, "parallel": parallel,
                   "pp": pp_results, "sp": sp, "past_seq": past_seq,
                   "export": exported,
                   "convert": {k: v for k, v in converted.items()
                               if k not in ("wav", "x")},
                   "pretrained": fetched, "quality": quality,
                   "cotrain": cotrain,
                   "kernels": kernels}, f,
                  indent=1)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
