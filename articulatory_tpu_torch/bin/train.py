#!/usr/bin/env python3
"""Train a GAN vocoder or an inversion model on the GPU (port of
``articulatory_tpu/bin/train.py``): ``SpeechDataset`` + ``SpeechCollater``
random windows for a2w (and the generic x2y modes such as the MRI
recipe's), w2a, ph2a and ph2m, with speaker ids (``use_spk_id``, checked
against ``num_spk``) and phoneme ids (``use_ph``, ``use_ph_loss``, the
ph modes) where the generator asks for them; ``MelArtDataset`` +
``CollaterMelArt`` for art, a2m and m2a; the named input/output
transforms; every generator and discriminator of the zoo; a cascade
(``generator2_type``: a frozen second generator, whose weights and the
discriminator's ``--pretrain2`` loads from a second checkpoint);
``train/gan.py``'s step (its noise and window draws seeded from
``--seed``). The top-level ``time_packing`` key, a TPU layout option, is
accepted and ignored. ``use_pcd`` raises: no collater makes the pitch and
periodicity tracks its step reads (the JAX package's CLI fails on the
missing batch key).

    python -m articulatory_tpu_torch.bin.train --device cuda \\
        --train-dumpdir dump/tr_set/norm --dev-dumpdir dump/dev_set/norm \\
        --outdir exp/x --config conf/e2w_hifigan_car.yaml --data-root data

The data options, as in the JAX package: ``remove_short_samples`` keeps
the utterances of more than ``batch_max_steps // hop_size + 2 *
aux_context_window`` feature frames; ``batch_sampler_type:
SizeAwareSampler`` (``batch_sampler_params``; its seed defaults to
``--seed``) packs batches by the utterances' lengths, read once into
``<train dump>/train_audio_lens.npy`` and read again while the training
set keeps its size; ``use_device_cache`` gathers the training batches from
a corpus cache on the device (``data/device_cache.py``) where the
configuration allows it (random windows, no batch sampler, no aux context
window, cascade, speaker or phoneme inputs or PCD), else warns and keeps
the host loader; ``use_native_loader`` assembles a2w batches in host C++
(``data/native_loader.py``).

``train(config, ...)`` takes the config as a dict (``main`` reads the YAML),
writes ``<outdir>/config.yml`` and the checkpoints, and returns the
``Trainer`` after its run. Distributed training and tensor parallelism are
not ported yet and raise.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from articulatory_tpu_torch.data.collate import (
    CollaterMelArt,
    SpeechCollater,
)
from articulatory_tpu_torch.data.datasets import MelArtDataset, SpeechDataset
from articulatory_tpu_torch.data.loader import DataLoader
from articulatory_tpu_torch.data.samplers import SizeAwareSampler
from articulatory_tpu_torch.data.transforms import (
    ART_ONLY_TRANSFORMS,
    get_transform,
)
from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.train.gan import (
    GANCriterion,
    GANTrainState,
    RandomDraws,
    make_eval_step,
    make_train_step,
)
from articulatory_tpu_torch.train.optimizers import build_optimizer
from articulatory_tpu_torch.train.schedulers import build_scheduler
from articulatory_tpu_torch.train.trainer import Trainer
from articulatory_tpu_torch.utils.checkpoint import (
    discriminator_state_dict,
    generator_state_dict,
    load_checkpoint,
    restore_state,
)
from articulatory_tpu_torch.utils.device import resolve_device
from articulatory_tpu_torch.utils.io import read_hdf5

def _check_config(config: dict) -> None:
    if int(config.get("tensor_parallel", 1)) > 1:
        raise NotImplementedError("config keys not ported yet: "
                                  "['tensor_parallel']")
    if config.get("use_pcd", False):
        raise ValueError(
            "use_pcd: no collater makes the 'pitch' and 'periodicity' batch "
            "keys the PCD discriminator inputs read; build batches with them "
            "and call train/gan.py's step directly")


def _transforms(config: dict) -> dict:
    """``transform``, ``input_transform`` (default ``transform``) and
    ``output_transform`` (default ``transform`` unless that is art-only),
    resolved by name as in the JAX package's ``bin/train.py``."""
    spec = config.get("transform")
    transform = get_transform(spec)
    given = config.get("input_transform")
    output = config.get("output_transform")
    if output is not None:
        output = get_transform(output)
    elif spec not in ART_ONLY_TRANSFORMS:
        output = transform
    return {"transform": transform,
            "input_transform": (get_transform(given) if given is not None
                                else transform),
            "output_transform": output}


def build_datasets(config: dict, train_dumpdir: str, dev_dumpdir: str,
                   data_root: str):
    """Train/dev datasets and their collaters: ``SpeechDataset`` with
    ``SpeechCollater``, or ``MelArtDataset`` with ``CollaterMelArt`` in the
    art, a2m and m2a modes."""
    mode = config.get("dataset_mode", "default")
    if config["format"] == "hdf5":
        kwargs = dict(audio_query="*.h5", mel_query="*.h5",
                      audio_load_fn=lambda p: read_hdf5(p, "wave"))
        mel_load_fn = lambda p: read_hdf5(p, "feats")  # noqa: E731
    elif config["format"] == "npy":
        kwargs = dict(audio_query="*-wave.npy", mel_query="*-feats.npy",
                      audio_load_fn=np.load)
        mel_load_fn = np.load
    else:
        raise ValueError("support only hdf5 or npy format.")
    rng = np.random.default_rng(config.get("seed", 0))
    gp = config["generator_params"]
    threshold = None
    if config.get("remove_short_samples", False):
        threshold = (config["batch_max_steps"] // config["hop_size"]
                     + 2 * gp.get("aux_context_window", 0))
    if mode in ("art", "a2m", "m2a"):
        datasets = [MelArtDataset(
            d, mel_query=kwargs["mel_query"], mel_load_fn=mel_load_fn,
            mel_length_threshold=threshold,
            allow_cache=config.get("allow_cache", False),
            transform=_transforms(config)["transform"], data_root=data_root)
            for d in (train_dumpdir, dev_dumpdir)]
        ar_len = (int(gp["ar_input"] / gp["out_channels"])
                  if gp.get("use_ar", False) else None)
        collater = CollaterMelArt(
            config["batch_max_steps"], config["hop_size"],
            gp.get("aux_context_window", 0), ar_len=ar_len,
            dataset_mode=mode, rng=rng)
        return datasets[0], datasets[1], collater, collater
    use_spk_id = gp.get("use_spk_id", False)
    use_ph = (gp.get("use_ph", False) or gp.get("use_ph_loss", False)
              or mode in ("ph2a", "ph2m"))
    common = dict(data_root=data_root, mel_load_fn=mel_load_fn,
                  mel_length_threshold=threshold,
                  allow_cache=config.get("allow_cache", False),
                  use_spk_id=use_spk_id, use_ph=use_ph, dataset_mode=mode,
                  **_transforms(config), **kwargs)
    train_set = SpeechDataset(root_dir=train_dumpdir, **common)
    if use_spk_id and len(train_set.spks) != gp["num_spk"]:
        raise ValueError(f"{len(train_set.spks)} speakers in the training "
                         f"set but num_spk is {gp['num_spk']}")
    # the dev set numbers its speakers as the training set does
    datasets = [train_set, SpeechDataset(root_dir=dev_dumpdir,
                                         spks=train_set.spks, **common)]

    def collater():
        return SpeechCollater(
            batch_max_steps=config["batch_max_steps"],
            hop_size=config["hop_size"],
            aux_context_window=gp.get("aux_context_window", 0),
            dataset_mode=mode, use_spk_id=use_spk_id, use_ph=use_ph,
            config=config, rng=rng)

    return datasets[0], datasets[1], collater(), collater()


def _batch_sampler(config: dict, train_set, train_dumpdir: str, seed: int
                   ) -> SizeAwareSampler | None:
    """The ``batch_sampler_type`` sampler over the training set, or None;
    the utterances' audio lengths are kept in ``train_audio_lens.npy`` of
    the dump directory, and made again when its count differs from the
    set's (``remove_short_samples`` toggled)."""
    kind = config.get("batch_sampler_type", "None")
    if kind == "None":
        return None
    if kind != "SizeAwareSampler":
        raise ValueError(f"unsupported batch_sampler_type {kind!r}")
    path = os.path.join(train_dumpdir, "train_audio_lens.npy")
    lens = np.load(path) if os.path.exists(path) else None
    if lens is None or len(lens) != len(train_set):
        lens = np.array([len(train_set[i]["audio"])
                         for i in range(len(train_set))])
        tmp = path + f".tmp{os.getpid()}.npy"
        np.save(tmp, lens)
        os.replace(tmp, path)
    params = dict(config.get("batch_sampler_params", {}))
    params.setdefault("seed", seed)
    return SizeAwareSampler(lens, **params)


def _fast_loader(config: dict, train_set, batch_sampler, seed: int, dev):
    """The device cache or the native loader where the config asks for one
    and allows it, else None (the host loader)."""
    gp = config["generator_params"]
    random_window = (config.get("package_mode", "random_window")
                     == "random_window")
    if config.get("use_device_cache", False):
        from articulatory_tpu_torch.data.device_cache import (
            DeviceCachedBatcher,
            canonical_cache_mode,
        )

        # generic x2y modes (the MRI recipe's) ride the cache through the
        # canonical mode their streams resolve to
        mode = canonical_cache_mode(config.get("dataset_mode") or "default")
        if (mode is not None and random_window and batch_sampler is None
                and gp.get("aux_context_window", 0) == 0
                and config.get("generator2_type") is None
                and not gp.get("use_spk_id", False)
                and not gp.get("use_ph", False)
                and not config.get("use_pcd", False)):
            logging.info("using the device-resident corpus cache for the "
                         "training data")
            return DeviceCachedBatcher(
                train_set, dict(config, dataset_mode=mode),
                batch_size=config["batch_size"], seed=seed, device=dev)
        logging.warning("use_device_cache set but unsupported for this "
                        "configuration; falling back to the host loader")
    if (config.get("use_native_loader", False)
            and config.get("dataset_mode") == "a2w" and random_window
            and batch_sampler is None):
        from articulatory_tpu_torch.data.native_loader import NativeDataLoader

        ar_len = (int(gp.get("ar_input", 512) / gp.get("out_channels", 1))
                  if gp.get("use_ar", False) else 0)
        logging.info("using native C++ batch assembly for the training data")
        return NativeDataLoader(
            train_set, batch_size=config["batch_size"],
            batch_max_steps=config["batch_max_steps"],
            hop_size=config["hop_size"], ar_len=ar_len, seed=seed,
            n_threads=max(2, config.get("num_workers", 0) or 4))
    return None


def dump_config(config: dict, outdir: str) -> None:
    import yaml

    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "config.yml"), "w") as f:
        yaml.dump(config, f, Dumper=yaml.Dumper)


def train(config: dict, *, train_dumpdir: str, dev_dumpdir: str, outdir: str,
          data_root: str = "data", pretrain: str = "", pretrain2: str = "",
          resume: str = "", seed: int = 0, device=None) -> Trainer:
    """Train from ``config`` on ``device`` (default cuda; raises without a
    card) until ``train_max_steps``. ``pretrain`` loads the models'
    weights, ``pretrain2`` a cascade's generator2 and the discriminator
    from another checkpoint's generator and discriminator, ``resume`` the
    whole state, in that order."""
    dev = resolve_device(device)
    _check_config(config)
    config = dict(config, train_dumpdir=train_dumpdir, dev_dumpdir=dev_dumpdir,
                  outdir=outdir, data_root=data_root, pretrain=pretrain,
                  pretrain2=pretrain2, resume=resume, seed=seed,
                  version="0.1.0-torch")
    dump_config(config, outdir)

    train_set, dev_set, train_collater, dev_collater = build_datasets(
        config, train_dumpdir, dev_dumpdir, data_root)
    logging.info(f"The number of training files = {len(train_set)}.")
    logging.info(f"The number of development files = {len(dev_set)}.")
    workers = config.get("num_workers", 0)
    batch_sampler = _batch_sampler(config, train_set, train_dumpdir, seed)
    train_loader = (_fast_loader(config, train_set, batch_sampler, seed, dev)
                    or DataLoader(train_set, batch_size=config["batch_size"],
                                  shuffle=True, collate_fn=train_collater,
                                  drop_last=True, batch_sampler=batch_sampler,
                                  num_workers=workers, seed=seed))
    data_loader = {
        "train": train_loader,
        "dev": DataLoader(dev_set, batch_size=min(config["batch_size"],
                                                  max(1, len(dev_set))),
                          shuffle=True, collate_fn=dev_collater,
                          drop_last=True, num_workers=workers, seed=seed),
    }

    criterion = GANCriterion(config)
    generator = build_model(config["generator_type"],
                            config["generator_params"], seed=seed).to(dev)
    discriminator = build_model(config["discriminator_type"],
                                config.get("discriminator_params", {}),
                                seed=seed + 1).to(dev)
    generator2 = None
    if config.get("generator2_type") is not None:
        # frozen: no optimizer holds it (reference train.py:1760-1769)
        generator2 = build_model(config["generator2_type"],
                                 config["generator2_params"],
                                 seed=seed + 2).to(dev).requires_grad_(False)
    logging.info(f"generator params: "
                 f"{sum(p.numel() for p in generator.parameters()):,}")
    logging.info(f"discriminator params: "
                 f"{sum(p.numel() for p in discriminator.parameters()):,}")
    opts, schedulers = {}, {}
    for name, model in (("generator", generator),
                        ("discriminator", discriminator)):
        opt_params = config.get(f"{name}_optimizer_params", {})
        opts[name] = build_optimizer(
            config.get(f"{name}_optimizer_type", "RAdam"), opt_params,
            config.get(f"{name}_grad_norm", -1), model.parameters())
        schedulers[name] = build_scheduler(
            config.get(f"{name}_scheduler_type", "StepLR"),
            opt_params.get("lr", 1e-3),
            config.get(f"{name}_scheduler_params", {}))
    state = GANTrainState(generator=generator, discriminator=discriminator,
                          opt_g=opts["generator"], opt_d=opts["discriminator"],
                          draws=RandomDraws(seed), generator2=generator2)
    epochs = 0
    if pretrain:
        restore_state(state, load_checkpoint(pretrain), config,
                      load_only_params=True)
        logging.info(f"Successfully loaded parameters from {pretrain}.")
    if pretrain2 and generator2 is not None:
        # the second stage and the discriminator from the second
        # checkpoint's generator and discriminator (reference
        # train.py:178-214)
        payload = load_checkpoint(pretrain2)
        generator2.load_state_dict(generator_state_dict(
            payload, "generator", config["generator2_params"],
            config["generator2_type"]))
        discriminator.load_state_dict(discriminator_state_dict(
            payload, config["discriminator_type"],
            config.get("discriminator_params", {})))
        logging.info(f"Successfully loaded stage-2 from {pretrain2}.")
    if resume:
        epochs = restore_state(state, load_checkpoint(resume), config,
                               schedulers=schedulers)
        logging.info(f"Successfully resumed from {resume}.")

    trainer = Trainer(config=config, state=state,
                      train_step=make_train_step(criterion, config),
                      eval_step=make_eval_step(criterion, config),
                      schedulers=schedulers, data_loader=data_loader,
                      outdir=outdir, device=dev, epochs=epochs)
    trainer.data_loader["train"].set_epoch(epochs)
    trainer.run()
    return trainer


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train an articulatory GAN vocoder on the GPU.")
    parser.add_argument("--train-dumpdir", required=True, type=str)
    parser.add_argument("--dev-dumpdir", required=True, type=str)
    parser.add_argument("--outdir", type=str, required=True)
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--data-root", default="data", type=str,
                        help="root holding <stage>/feats.scp maps")
    parser.add_argument("--pretrain", default="", type=str, nargs="?")
    parser.add_argument("--pretrain2", default="", type=str, nargs="?",
                        help="a checkpoint whose generator and discriminator "
                             "become a cascade's frozen generator2 and the "
                             "discriminator")
    parser.add_argument("--resume", default="", type=str, nargs="?")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--verbose", type=int, default=1)
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (default; raises without a card) or cpu")
    for flag, kind in (("--coordinator-address", str),
                       ("--num-processes", int), ("--process-id", int),
                       ("--tensor-parallel", int)):
        parser.add_argument(flag, default=None, type=kind,
                            help="not ported yet (raises)")
    return parser


def main(argv: list[str] | None = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose > 1 else
        logging.INFO if args.verbose > 0 else logging.WARN,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s")
    asked = [f for f in ("coordinator_address", "num_processes", "process_id",
                         "tensor_parallel") if getattr(args, f) is not None]
    if asked:
        parser.error(", ".join("--" + f.replace("_", "-") for f in asked)
                     + " is not yet ported to articulatory_tpu_torch")

    from articulatory_tpu_torch.config import load_config

    train(load_config(args.config), train_dumpdir=args.train_dumpdir,
          dev_dumpdir=args.dev_dumpdir, outdir=args.outdir,
          data_root=args.data_root, pretrain=args.pretrain,
          pretrain2=args.pretrain2, resume=args.resume, seed=args.seed,
          device=args.device)


if __name__ == "__main__":
    main()
