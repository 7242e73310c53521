#!/usr/bin/env python3
"""Decode dumped features with a trained generator on the GPU (port of
``articulatory_tpu/bin/decode.py`` for the wave-output modes: default, a2w
and the generic x2y modes such as the MRI recipe's; ``art`` and ``a2m``
write features; ``w2a`` inverts the waves of a wav.scp (``--feats-scp``),
or the input stream of a dump directory (``--dumpdir``: ``<utt>-wave.npy``
or the hdf5 ``wave``, e.g. frame-rate MFCCs), into EMA trajectories with
an inversion model, a ``BiGRU`` or the ``Transformer``; ``ph2a`` and
``ph2m`` read integer phoneme ids from the dump or feats.scp into the
model's embedding and write features; ``a2w_mult`` reads a 3-column
feats.scp, ``fid path modality``, and decodes each utterance through
``ar_loop(modality=...)``, the input of an ``in_list`` model).
Every generator of the zoo decodes: the chunked-AR loops run the AR ones,
``LoadedModel.inference`` (full utterance; PQMF synthesis for multi-band
models, seeded noise for Parallel WaveGAN and StyleMelGAN) the others.

Writes ``<utt>_gen.wav`` per utterance (``<utt>_<i>_gen.wav`` and
``<utt>_<i>.npy`` per window with ``wsola``, ``<utt>_gen.npy`` for feature
output) and logs the real-time factor (w2a: of the input audio). AR
generators decode chunk by chunk (``ar_loop``), or ``--decode-batch-size``
utterances at a time (``ar_loop_batched``); ``--ar-scan`` runs either
through the captured chunk step (a CUDA graph on a card); ``a2w_mult``
and ``a2w_pcd`` decode sequentially through the eager loop, as in the JAX
package. Others decode in one forward (``--sequence-parallel N``: in N time
tiles, ``parallel/sp.py``).
``--int8-weights`` / ``--bf16-weights`` store the weights as int8 or
bfloat16. Input transforms (``transform`` / ``input_transform``) apply to
the features.

    python -m articulatory_tpu_torch.bin.decode --device cuda \\
        --dumpdir dump/eval/norm --checkpoint exp/x/ckpt.pkl --outdir out \\
        --ar-scan
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np

from articulatory_tpu_torch.data.collate import is_wave_output_mode
from articulatory_tpu_torch.data.datasets import (
    ArtDataset,
    ArtSCPDataset,
    AudioSCPDataset,
    MelSCPDataset,
)
from articulatory_tpu_torch.data.multimodal import ArtSCPMultDataset
from articulatory_tpu_torch.data.transforms import get_transform
from articulatory_tpu_torch.inference import (
    ar_loop,
    ar_loop_batched,
    ar_loop_scan,
    load_model,
)
from articulatory_tpu_torch.utils.io import read_hdf5, write_wav

# decoded one utterance at a time through the eager loop (JAX
# bin/decode.py:211, :244)
_SEQUENTIAL_MODES = ("a2w_mult", "a2w_pcd")
_PHONEME_MODES = ("ph2a", "ph2m")


def _dataset(config: dict, dumpdir: str | None, feats_scp: str | None):
    if (feats_scp is not None) == (dumpdir is not None):
        raise ValueError("Please specify either --dumpdir or --feats-scp.")
    mode = config.get("dataset_mode", "default")
    if mode == "a2w_mult":
        if feats_scp is None:
            raise ValueError("dataset_mode a2w_mult reads a 3-column "
                             "--feats-scp (fid path modality)")
        return ArtSCPMultDataset(feats_scp, return_utt_id=True,
                                 transform=config.get("transform"))
    if mode == "w2a":
        if feats_scp is not None:
            return AudioSCPDataset(feats_scp, return_utt_id=True,
                                   return_sampling_rate=False)
        if config.get("format", "hdf5") == "hdf5":
            return ArtDataset(dumpdir, query="*.h5", return_utt_id=True,
                              load_fn=lambda path: read_hdf5(path, "wave"))
        return ArtDataset(dumpdir, query="*-wave.npy", return_utt_id=True)
    transform = (get_transform(config["transform"])
                 if config.get("transform") else None)
    given = config.get("input_transform")
    transform = get_transform(given) if given is not None else transform
    if mode in ("default", "m2w"):
        transform = None  # mel inputs take no transform
    if feats_scp is not None:
        if mode in ("default", "m2w"):
            return MelSCPDataset(feats_scp, return_utt_id=True)
        return ArtSCPDataset(feats_scp, return_utt_id=True,
                             transform=transform)
    if config.get("format", "hdf5") == "hdf5":
        return ArtDataset(dumpdir, query="*.h5", return_utt_id=True,
                          transform=transform,
                          load_fn=lambda path: read_hdf5(path, "feats"))
    return ArtDataset(dumpdir, query="*-feats.npy", return_utt_id=True,
                      transform=transform)


def decode(config: dict, checkpoint: str, outdir: str, *,
           dumpdir: str | None = None, feats_scp: str | None = None,
           decode_batch_size: int = 1, normalize_before: bool = False,
           bucket_frames: int = 64, ar_scan: bool = False,
           ar_scan_bucket: int = 4, int8_weights: bool = False,
           bf16_weights: bool = False, sequence_parallel: int = 0,
           device=None) -> dict:
    """Decode every utterance of a dump directory or feats.scp into
    ``outdir``; ``sequence_parallel`` N > 1 tiles non-AR forwards N ways.
    Returns ``{"utterances", "seconds_audio", "seconds_elapsed",
    "rtf"}`` (``rtf``: the mean per-utterance RTF, or the batched run's
    effective one)."""
    dataset = _dataset(config, dumpdir, feats_scp)
    logging.info(f"The number of features to be decoded = {len(dataset)}.")
    model = load_model(checkpoint, config, device=device)
    logging.info(f"Loaded model parameters from {checkpoint}.")
    model.remove_weight_norm()
    if int8_weights and not model.quantized:
        model.quantize_int8()
        logging.info("Quantized weights to int8 (per-out-channel symmetric).")
    if bf16_weights:
        model.to_bf16_weights()  # raises on int8 weights
        logging.info("Stored weights as bfloat16 (weight norm folded).")
    os.makedirs(outdir, exist_ok=True)
    mode = config.get("dataset_mode", "default")
    use_ar = config["generator_params"].get("use_ar", False)
    do_wsola = bool(config.get("wsola", False))
    is_wave = is_wave_output_mode(mode)
    w2a = mode == "w2a"
    # the chunked-AR loops: wave decode and w2a inversion
    ar_chunked = use_ar and not do_wsola and (is_wave or w2a)
    if sequence_parallel > 1:
        if use_ar or w2a:
            logging.warning(
                "--sequence-parallel ignored: AR chunked decode is serial "
                "with tiny per-chunk shapes, and inversion models are not "
                "convolutional; SP targets full-utterance (non-AR) "
                "synthesis.")
        else:
            model.enable_sequence_parallel(sequence_parallel)
            logging.info(f"Sequence-parallel inference over "
                         f"{sequence_parallel} time tiles.")
    sr, hop = config["sampling_rate"], config["hop_size"]
    # phoneme ids feed an embedding (reference decode.py:346)
    dtype = np.int32 if mode in _PHONEME_MODES else np.float32
    items = [(item[0], np.asarray(item[1], dtype),
              item[2] if mode == "a2w_mult" else None) for item in dataset]
    total_time = total_len = total_rtf = 0.0
    sequential = mode in _SEQUENTIAL_MODES

    if decode_batch_size > 1 and ar_chunked and not sequential:
        for i in range(0, len(items), decode_batch_size):
            group = [item[:2] for item in items[i:i + decode_batch_size]]
            start = time.perf_counter()
            # --ar-scan: each lane group is one run of the captured step
            outs = ar_loop_batched(model, [c for _, c in group], config,
                                   scan=ar_scan)
            total_time += time.perf_counter() - start
            for (utt_id, c), out in zip(group, outs):
                if w2a:  # trajectories; the input rows are wave samples
                    np.save(os.path.join(outdir, f"{utt_id}_gen.npy"),
                            np.asarray(out, np.float32), allow_pickle=False)
                    total_len += len(c) / sr
                else:
                    write_wav(os.path.join(outdir, f"{utt_id}_gen.wav"), out,
                              sr)
                    total_len += len(out) / sr
        rtf = total_time / max(total_len, 1e-9)
        logging.info(f"Finished batched generation of {len(items)} utterances "
                     f"(batch {decode_batch_size}); throughput = "
                     f"{total_len / max(total_time, 1e-9):.1f}x realtime "
                     f"(effective RTF {rtf:.6f}).")
        return {"utterances": len(items), "seconds_audio": total_len,
                "seconds_elapsed": total_time, "rtf": rtf}

    if ar_scan and (sequential or not ar_chunked):
        logging.warning("--ar-scan ignored: the captured chunk loop covers "
                        "plain chunked-AR wave decode and w2a inversion (no "
                        "wsola/multimodal/non-AR).")
        ar_scan = False
    for utt_id, c, modality in items:
        start = time.perf_counter()
        if ar_scan:
            out = ar_loop_scan(model, c, config, chunk_bucket=ar_scan_bucket)
        elif use_ar:
            out = ar_loop(model, c, config, do_wsola=do_wsola,
                          modality=modality)
        else:
            out = model.inference(c, normalize_before=normalize_before,
                                  bucket_frames=bucket_frames or None)
        elapsed = time.perf_counter() - start
        if not is_wave:  # feature output; w2a inputs are wave samples, the
            # other modes' frames at sr / hop a second
            dur = len(c) / sr if w2a else len(c) * hop / sr
            np.save(os.path.join(outdir, f"{utt_id}_gen.npy"),
                    np.asarray(out, np.float32), allow_pickle=False)
        elif do_wsola and use_ar:
            # 50 %-overlap windows: each window's waveform and its input
            signals, arts = out
            for i, (signal, art) in enumerate(zip(signals, arts)):
                write_wav(os.path.join(outdir, f"{utt_id}_{i}_gen.wav"),
                          signal, sr)
                np.save(os.path.join(outdir, f"{utt_id}_{i}.npy"), art)
            dur = sum(len(signal) for signal in signals) / sr
        else:
            wav = np.asarray(out).reshape(-1)
            write_wav(os.path.join(outdir, f"{utt_id}_gen.wav"), wav, sr)
            dur = len(wav) / sr
        total_rtf += elapsed / max(dur, 1e-9)
        total_time += elapsed
        total_len += dur
    n = max(len(items), 1)
    logging.info(f"Finished generation of {len(items)} utterances (avg time "
                 f"{total_time / n:.3f} s, avg len {total_len / n:.3f} s).")
    logging.info(f"Average RTF = {total_rtf / n:.6f}; throughput = "
                 f"{total_len / max(total_time, 1e-9):.1f}x realtime.")
    return {"utterances": len(items), "seconds_audio": total_len,
            "seconds_elapsed": total_time, "rtf": total_rtf / n}


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        description="Decode dumped features with a trained generator.")
    parser.add_argument("--feats-scp", "--scp", default=None, type=str)
    parser.add_argument("--dumpdir", default=None, type=str)
    parser.add_argument("--outdir", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--config", default=None, type=str)
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--normalize-before", default=False, action="store_true")
    parser.add_argument("--bucket-frames", default=64, type=int,
                        help="pad full-utterance inference lengths to this "
                             "multiple (0 = exact)")
    parser.add_argument("--decode-batch-size", default=1, type=int,
                        help="batch N utterances through the AR loop "
                             "(1 = reference-exact sequential decode)")
    parser.add_argument("--int8-weights", default=False, action="store_true",
                        help="store the weights as int8 (symmetric per "
                             "output channel; folds weight norm first)")
    parser.add_argument("--bf16-weights", default=False, action="store_true",
                        help="store the weights as bfloat16 (folds weight "
                             "norm first; compute dtypes unchanged); "
                             "exclusive with int8 weights")
    parser.add_argument("--ar-scan", default=False, action="store_true",
                        help="run the chunked-AR decode through one captured "
                             "chunk step (a CUDA graph on a card) replayed "
                             "once a chunk; composes with "
                             "--decode-batch-size (each lane group is one "
                             "run). Covers a2w wave decode and w2a "
                             "inversion; ignored for wsola and non-AR "
                             "decodes.")
    parser.add_argument("--ar-scan-bucket", default=4, type=int,
                        help="with --ar-scan, round each utterance's chunk "
                             "count up to this multiple (0 = exact)")
    parser.add_argument("--sequence-parallel", default=0, type=int,
                        help="tile the time axis of full-utterance (non-AR) "
                             "forwards N ways (parallel/sp.py), one tile's "
                             "activations at a time; ignored for AR and "
                             "inversion models. Frame counts not divisible "
                             "by N are zero-padded and trimmed: only the "
                             "last receptive-field window can differ from "
                             "the unsharded forward.")
    parser.add_argument("--verbose", type=int, default=1)
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose > 1 else
        logging.INFO if args.verbose > 0 else logging.WARN,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s")
    exclusive = ("--bf16-weights is exclusive with int8 weights (flag or "
                 "config weight_quant: int8)")
    if args.bf16_weights and args.int8_weights:
        parser.error(exclusive)

    from articulatory_tpu_torch.config import load_config

    config = load_config(args.config or os.path.join(
        os.path.dirname(args.checkpoint), "config.yml"))
    config.update(vars(args))
    if args.bf16_weights and config.get("weight_quant") == "int8":
        parser.error(exclusive)
    decode(config, args.checkpoint, args.outdir, dumpdir=args.dumpdir,
           feats_scp=args.feats_scp, decode_batch_size=args.decode_batch_size,
           normalize_before=args.normalize_before,
           bucket_frames=args.bucket_frames, ar_scan=args.ar_scan,
           ar_scan_bucket=args.ar_scan_bucket, int8_weights=args.int8_weights,
           bf16_weights=args.bf16_weights,
           sequence_parallel=args.sequence_parallel, device=args.device)


if __name__ == "__main__":
    main()
