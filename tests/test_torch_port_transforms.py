"""The port's copy of the named transforms (``data/transforms.py``) against
the JAX package's at 1e-6, and where they apply: the training datasets'
``transform`` / ``input_transform`` / ``output_transform`` (both packages'
``build_datasets`` on one dump) and decode's input transform."""

import types

import numpy as np
import pytest
import torch

from articulatory_tpu.bin import train as jax_train
from articulatory_tpu.data import transforms as jax_transforms
from articulatory_tpu.data.datasets import ArtDataset as JaxArtDataset
from articulatory_tpu_torch.bin import decode as decode_cli
from articulatory_tpu_torch.bin import train as train_cli
from articulatory_tpu_torch.data import transforms

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-6)


def _input(name, rng):
    if name == "preprocess_emg":  # EMG channels at 1 kHz
        return rng.standard_normal((3000, 2))
    if name == "resample_16_22":  # 16 kHz audio
        return 0.5 * rng.standard_normal(1600)
    return rng.standard_normal((50, 13))  # features, log-f0 first


@pytest.mark.parametrize("name", sorted(jax_transforms._TRANSFORMS))
def test_named_transforms_match_jax(name):
    x = _input(name, np.random.default_rng(0))
    want = jax_transforms.get_transform(name)(x.copy())
    got = transforms.get_transform(name)(x.copy())
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_transform_names_and_rules_match_jax():
    assert sorted(transforms._TRANSFORMS) == sorted(jax_transforms._TRANSFORMS)
    assert transforms.ART_ONLY_TRANSFORMS == jax_transforms.ART_ONLY_TRANSFORMS
    assert transforms.get_transform(None) is None
    with pytest.raises(KeyError):
        transforms.get_transform("nope")


def _dump(root):
    rng = np.random.default_rng(1)
    for stage in ("tr", "dev"):
        dump, data = root / "dump" / stage / "norm", root / "data" / stage
        dump.mkdir(parents=True)
        data.mkdir(parents=True)
        lines = []
        for i in range(2):
            np.save(dump / f"u{i}-wave.npy",
                    (0.3 * rng.standard_normal(40 * 80)).astype(np.float32))
            np.save(dump / f"u{i}-feats.npy", np.zeros((40, 13), np.float32))
            art = data / f"u{i}.npy"
            np.save(art, rng.standard_normal((40, 13)).astype(np.float32))
            lines.append(f"u{i} {art}\n")
        (data / "feats.scp").write_text("".join(lines))


@pytest.mark.parametrize("keys", [
    {"transform": "10*f0"},  # art-only: the audio keeps no transform
    {"transform": "resample_16_22"},  # both streams
    {"input_transform": "10*f0", "output_transform": "resample_16_22"},
], ids=["art_only", "both", "apart"])
def test_training_transforms_match_jax(tmp_path, keys):
    _dump(tmp_path)
    config = {"format": "npy", "batch_max_steps": 800, "hop_size": 80,
              "dataset_mode": "a2w", **keys,
              "generator_params": {"use_ar": True, "ar_input": 64}}
    dirs = dict(train_dumpdir=str(tmp_path / "dump/tr/norm"),
                dev_dumpdir=str(tmp_path / "dump/dev/norm"),
                data_root=str(tmp_path / "data"))
    ours = train_cli.build_datasets(config, **dirs)
    theirs = jax_train.build_datasets(types.SimpleNamespace(**dirs), config)
    raw = np.load(tmp_path / "data/tr/u0.npy")
    for i in range(2):
        for key in ("art", "audio"):
            np.testing.assert_allclose(ours[0][i][key], theirs[0][i][key],
                                       **TOL)
    art = ours[0][0]["art"]
    if "10*f0" in keys.values():
        np.testing.assert_allclose(art[:, 0], 10 * raw[:, 0], **TOL)
    batch, want = ours[2]([ours[0][0], ours[0][1]]), theirs[2](
        [theirs[0][0], theirs[0][1]])
    for key in ("y", "ar"):
        np.testing.assert_allclose(batch[key], want[key], **TOL)


def test_decode_input_transform_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((30, 13)).astype(np.float32)
    np.save(tmp_path / "u-feats.npy", x)
    config = {"format": "npy", "dataset_mode": "a2w", "transform": "resample_16_22",
              "input_transform": "10*f0"}
    ours = decode_cli._dataset(config, str(tmp_path), None)
    theirs = JaxArtDataset(str(tmp_path), query="*-feats.npy",
                           load_fn=np.load, return_utt_id=True,
                           transform=jax_transforms.get_transform("10*f0"))
    (uid, got), (want_uid, want) = ours[0], theirs[0]
    assert uid == want_uid == "u"
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[:, 0], 10 * x[:, 0], **TOL)
