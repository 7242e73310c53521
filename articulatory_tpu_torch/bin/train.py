#!/usr/bin/env python3
"""Train a GAN vocoder or an inversion model on the GPU (port of
``articulatory_tpu/bin/train.py``): ``SpeechDataset`` + ``SpeechCollater``
(``package_mode`` random_window, window or pad) for a2w (and the generic
x2y modes such as the MRI recipe's), m2w, w2a, ph2a and ph2m, with speaker
ids (``use_spk_id``, checked against ``num_spk``) and phoneme ids
(``use_ph``, ``use_ph_loss``, the ph modes) where the generator asks for
them; ``MelArtDataset`` +
``CollaterMelArt`` for art, a2m and m2a; the named input/output
transforms; every generator and discriminator of the zoo; a cascade
(``generator2_type``: a frozen second generator, whose weights and the
discriminator's ``--pretrain2`` loads from a second checkpoint);
``train/gan.py``'s step (its noise and window draws seeded from
``--seed``; ``use_remat``; the models' ``compute_dtype`` and
``hybrid_precision``). The top-level ``time_packing`` key, a TPU layout
option, is accepted and ignored; ``checkpoint_backend: orbax`` is logged,
and the checkpoints are torch pickles. The reference's data flags
(``--train-wav-scp`` and the like) and ``--rank`` are accepted and
ignored, as the JAX package's CLI does. ``use_pcd`` raises: no collater
makes the pitch and periodicity tracks its step reads (the JAX package's
CLI fails on the missing batch key).

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
``Trainer`` after its run.

Several processes (``parallel/mesh.py``): ``--coordinator-address``,
``--num-processes`` and ``--process-id``, or the environment the launcher
sets (``python -m articulatory_tpu_torch.distributed.launch
--nproc_per_node N bin/train.py ...``), start the process group; a rank
asked for ``cuda`` runs on ``cuda:{LOCAL_RANK % device_count}``, and
ranks other than 0 log warnings only. ``batch_size`` is per data-parallel
rank (the global batch is ``batch_size`` x their number); each rank loads
its shard of the training and dev sets (``data/loader.py``, or the native
loader's wrap-padded shard, as JAX draws it). The device cache stays
single-process, as JAX keeps its cache, and warns otherwise.
``tensor_parallel: N`` (or ``--tensor-parallel N``)
splits the generator over N consecutive ranks (``parallel/tp.py``); the
discriminator stays replicated. Checkpoints are written full, by rank 0.
The collater's window draws are seeded per batch from ``--seed``, the epoch
and the rank, and the step's draws per step (``train/gan.py``), so a
``--resume`` continues as the uninterrupted run would, bit for bit.
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
from articulatory_tpu_torch.parallel import mesh
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
    """The device cache (one data-parallel rank) or the native loader (the
    rank's shard) where the config asks for one and allows it, else None
    (the host loader). The ranks of a tensor-parallel group share a
    data-parallel rank, so they take the same shard."""
    gp = config["generator_params"]
    lay = mesh.layout()
    random_window = (config.get("package_mode", "random_window")
                     == "random_window")
    if config.get("use_device_cache", False) and lay.dp > 1:
        logging.warning(f"use_device_cache is single-process; not used on "
                        f"{lay.dp} data-parallel ranks")
    elif config.get("use_device_cache", False):
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
            shard_id=lay.dp_rank, num_shards=lay.dp,
            n_threads=max(2, config.get("num_workers", 0) or 4))
    return None


def dump_config(config: dict, outdir: str) -> None:
    import yaml

    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "config.yml"), "w") as f:
        yaml.dump(config, f, Dumper=yaml.Dumper)


def train(config: dict, *, train_dumpdir: str, dev_dumpdir: str, outdir: str,
          data_root: str = "data", pretrain: str = "", pretrain2: str = "",
          resume: str = "", seed: int = 0, device=None,
          tensor_parallel: int | None = None) -> Trainer:
    """Train from ``config`` on ``device`` (default cuda; raises without a
    card) until ``train_max_steps``. ``pretrain`` loads the models'
    weights, ``pretrain2`` a cascade's generator2 and the discriminator
    from another checkpoint's generator and discriminator, ``resume`` the
    whole state, in that order. In a process group (``main`` starts it)
    the ranks split into ``tensor_parallel`` x data-parallel groups."""
    dev = resolve_device(mesh.rank_device(device))
    _check_config(config)
    tp = int(tensor_parallel or config.get("tensor_parallel", 1) or 1)
    config = dict(config, train_dumpdir=train_dumpdir, dev_dumpdir=dev_dumpdir,
                  outdir=outdir, data_root=data_root, pretrain=pretrain,
                  pretrain2=pretrain2, resume=resume, seed=seed,
                  tensor_parallel=tp, version="0.1.0-torch")
    if tp > 1 and config["generator_type"] != "HiFiGANGenerator":
        raise ValueError(f"tensor_parallel splits HiFiGANGenerator only, "
                         f"not {config['generator_type']}")
    lay = mesh.make_groups(tp) if mesh.world_size() > 1 or tp > 1 else \
        mesh.layout()
    if mesh.is_main():
        dump_config(config, outdir)
    else:
        os.makedirs(outdir, exist_ok=True)

    train_set, dev_set, train_collater, dev_collater = build_datasets(
        config, train_dumpdir, dev_dumpdir, data_root)
    logging.info(f"The number of training files = {len(train_set)}.")
    logging.info(f"The number of development files = {len(dev_set)}.")
    workers = config.get("num_workers", 0)
    shards = dict(shard_id=lay.dp_rank, num_shards=lay.dp, collate_seed=seed)
    batch_sampler = _batch_sampler(config, train_set, train_dumpdir, seed)
    train_loader = (_fast_loader(config, train_set, batch_sampler, seed, dev)
                    or DataLoader(train_set, batch_size=config["batch_size"],
                                  shuffle=True, collate_fn=train_collater,
                                  drop_last=True, batch_sampler=batch_sampler,
                                  num_workers=workers, seed=seed, **shards))
    data_loader = {
        "train": train_loader,
        "dev": DataLoader(dev_set, batch_size=min(
            config["batch_size"], max(1, len(dev_set) // lay.dp)),
            shuffle=True, collate_fn=dev_collater, drop_last=True,
            num_workers=workers, seed=seed, **shards),
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
        opts[name] = _optimizer(config, name, model)
        opt_params = config.get(f"{name}_optimizer_params", {})
        schedulers[name] = build_scheduler(
            config.get(f"{name}_scheduler_type", "StepLR"),
            opt_params.get("lr", 1e-3),
            config.get(f"{name}_scheduler_params", {}))
    state = GANTrainState(generator=generator, discriminator=discriminator,
                          opt_g=opts["generator"], opt_d=opts["discriminator"],
                          draws=RandomDraws(seed, lay.dp_rank, lay.dp),
                          generator2=generator2)
    epochs = epoch_batches = 0
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
        payload = load_checkpoint(resume)
        epochs = restore_state(state, payload, config, schedulers=schedulers)
        epoch_batches = int(payload.get("epoch_batches", 0))
        logging.info(f"Successfully resumed from {resume}.")
    # every rank starts from rank 0's weights
    for model in (generator, discriminator, generator2):
        if model is not None:
            mesh.replicate(model)
    if tp > 1:
        _split_generator(state, config, lay)

    trainer = Trainer(config=config, state=state,
                      train_step=make_train_step(criterion, config),
                      eval_step=make_eval_step(criterion, config),
                      schedulers=schedulers, data_loader=data_loader,
                      outdir=outdir, device=dev, epochs=epochs,
                      epoch_batches=epoch_batches)
    trainer.data_loader["train"].set_epoch(epochs, start=epoch_batches)
    trainer.run()
    return trainer


def _optimizer(config: dict, name: str, model):
    return build_optimizer(
        config.get(f"{name}_optimizer_type", "RAdam"),
        config.get(f"{name}_optimizer_params", {}),
        config.get(f"{name}_grad_norm", -1), model.parameters())


def _split_generator(state: GANTrainState, config: dict,
                     lay: mesh.Layout) -> None:
    """Split the (restored) generator over the TP group, and its optimizer
    state with it: the rank's optimizer holds the rank's parameters and
    clips by the global gradient norm."""
    from articulatory_tpu_torch.parallel import tp

    full_opt = state.opt_g.state_dict()
    tp.shard_generator_(state.generator, lay.tp_group, lay.tp_rank, lay.tp)
    state.opt_g = _optimizer(config, "generator", state.generator)
    tp.load_optimizer_state(state.opt_g, full_opt, state.generator)
    state.opt_g.norm_fn = tp.clip_norm_fn(state.generator)
    held = sum(p.numel() for p in state.generator.parameters())
    plan = state.generator.tp
    full = sum(int(np.prod(plan.full_shapes[n])) for n in plan.full_names)
    logging.warning(f"tensor parallel rank {lay.tp_rank} of {lay.tp}: "
                    f"{held:,} of the generator's {full:,} parameters")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train an articulatory GAN vocoder on the GPU.")
    # the reference's data flags, parsed and ignored as the JAX package's
    # CLI does, so its command lines stay valid; the dump directories are
    # what the datasets read
    for stage in ("train", "dev"):
        for what in ("wav-scp", "feats-scp", "segments", "dumpdirs"):
            parser.add_argument(f"--{stage}-{what}", default=None, type=str,
                                help="accepted and ignored")
        parser.add_argument(f"--{stage}-dumpdir", default=None, type=str,
                            help="required")
    parser.add_argument("--rank", "--local_rank", default=0, type=int,
                        help="accepted and ignored")
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
    parser.add_argument("--coordinator-address", default=None, type=str,
                        help="host:port (or a file:// URL) of the process "
                             "group's rendezvous; default the launcher's "
                             "environment")
    parser.add_argument("--num-processes", default=None, type=int)
    parser.add_argument("--process-id", default=None, type=int)
    parser.add_argument("--tensor-parallel", default=None, type=int,
                        help="split the generator over N consecutive ranks "
                             "(overrides the config's tensor_parallel)")
    return parser


def _distributed(args) -> bool:
    env = os.environ
    return (args.coordinator_address is not None
            or "JAX_COORDINATOR_ADDRESS" in env
            or ("MASTER_ADDR" in env and "RANK" in env))


def main(argv: list[str] | None = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose > 1 else
        logging.INFO if args.verbose > 0 else logging.WARN,
        format="%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s")
    for stage in ("train", "dev"):
        if getattr(args, f"{stage}_dumpdir") is None:
            parser.error(f"--{stage}-dumpdir is required")

    from articulatory_tpu_torch.config import load_config

    config = load_config(args.config)
    if _distributed(args):
        mesh.init_distributed(args.coordinator_address, args.num_processes,
                              args.process_id,
                              device=mesh.rank_device(args.device))
        if not mesh.is_main() and args.verbose <= 1:
            # the reference's non-rank-0 squelch (train.py:1461-1463)
            logging.getLogger().setLevel(logging.WARNING)
    try:
        train(config, train_dumpdir=args.train_dumpdir,
              dev_dumpdir=args.dev_dumpdir, outdir=args.outdir,
              data_root=args.data_root, pretrain=args.pretrain,
              pretrain2=args.pretrain2, resume=args.resume, seed=args.seed,
              device=args.device, tensor_parallel=args.tensor_parallel)
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    main()
