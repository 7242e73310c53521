"""The default direction of checkpoint conversion against the JAX package's,
on the CPU:

- ``utils/weights.py::GENERATOR_TO_JAX`` / ``DISCRIMINATOR_TO_JAX`` against
  JAX's ``GENERATOR_IMPORTERS`` / ``DISCRIMINATOR_IMPORTERS`` on the same
  reference-layout state dict (a port model's, every entry drawn from a
  seed), leaf for leaf and bit for bit, for every family JAX imports; and
  each inverse round-trips with the port's forward converter
  (``generator_to_state_dict`` / ``discriminator_to_state_dict``): JAX tree
  -> state dict -> JAX tree is the tree, bit for bit but for Parallel
  WaveGAN's upsampling kernels, which JAX keeps folded (``w`` -> ``v = w``,
  ``g = ||w||`` -> ``g v / ||v||``, a rounding off: rtol 1e-6);
- ``utils/checkpoint.py::save_msgpack`` writes the bytes of flax's
  ``msgpack_serialize`` (sorted keys, numpy scalars, None, and arrays
  chunked past ``MAX_CHUNK_SIZE``, lowered on both sides);
- ``bin/convert_checkpoint.py`` (no ``--to-torch``) writes the very file
  the JAX package's CLI writes from a reference pickle, for the HiFi-CAR
  with its MSMPD and for the BiGRU; a discriminator whose layout does not
  match is left out on both sides; and the JAX package's ``load_model``
  decodes the port's file as it decodes its own."""

import sys

import numpy as np
import pytest
import torch
import yaml

import flax.serialization

from articulatory_tpu.bin import convert_checkpoint as jax_convert
from articulatory_tpu.utils.torch_import import (
    DISCRIMINATOR_IMPORTERS,
    GENERATOR_IMPORTERS,
)
from articulatory_tpu_torch.bin import convert_checkpoint
from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.utils import checkpoint as port_ckpt
from articulatory_tpu_torch.utils.weights import (
    DISCRIMINATOR_TO_JAX,
    GENERATOR_TO_JAX,
    discriminator_to_state_dict,
    generator_to_state_dict,
)

torch.set_num_threads(1)

HIFI_CAR = dict(in_channels=13 + 8, out_channels=1, channels=16,
                kernel_size=7, upsample_scales=[5, 4],
                upsample_kernel_sizes=[10, 8], resblock_kernel_sizes=[3, 5],
                resblock_dilations=[[1, 3], [1, 3]], use_ar=True,
                ar_input=64, ar_hidden=8, ar_output=8)
GENERATORS = {
    "hifi_car": ("HiFiGANGenerator", HIFI_CAR),
    "hifi_cond": ("HiFiGANGenerator", dict(
        HIFI_CAR, in_channels=13 + 8, use_spk_id=True, num_spk=3,
        use_ph=True, num_ph=5, ph_emb_size=4, use_ph_loss=True)),
    "multiband": ("HiFiGANGenerator", dict(
        in_channels=13, out_channels=4, channels=16, kernel_size=7,
        upsample_scales=[5, 2], upsample_kernel_sizes=[10, 4],
        resblock_kernel_sizes=[3], resblock_dilations=[[1, 3]])),
    "melgan": ("MelGANGenerator", dict(in_channels=13, channels=32,
                                       upsample_scales=[4, 4], stacks=2)),
    "pwg": ("ParallelWaveGANGenerator", dict(
        layers=4, stacks=2, residual_channels=8, gate_channels=16,
        skip_channels=8, aux_channels=13, aux_context_window=2,
        upsample_params={"upsample_scales": [4, 4]})),
    "style_melgan": ("StyleMelGANGenerator", dict(
        in_channels=8, aux_channels=10, channels=16,
        noise_upsample_scales=[4, 4], upsample_scales=[2, 2, 2])),
    "gblock": ("GBlockGenerator", dict(in_channels=13, channels=16,
                                       g_scales=[4, 1], g_kernel_sizes=[3, 3],
                                       use_ar=True, ar_input=32,
                                       ar_hidden=8, ar_output=8)),
    "bigru": ("BiGRU", dict(in_channels=5 + 8, hidden_size=8,
                            out_channels=4, use_ar=True, ar_input=16,
                            ar_hidden=8, ar_output=8)),
    "transformer": ("Transformer", dict(in_channels=5, out_channels=4,
                                        hidden_dim=16, elayers=1,
                                        dropout=0.0)),
}
MSMPD = dict(scales=1, scale_discriminator_params=dict(
    channels=16, max_downsample_channels=32, max_groups=4,
    downsample_scales=[4, 1]), periods=[2], period_discriminator_params=dict(
        channels=4, max_downsample_channels=8, downsample_scales=[3, 1]))
DISCRIMINATORS = {
    "msmpd": ("HiFiGANMultiScaleMultiPeriodDiscriminator", MSMPD),
    "melgan_msd": ("MelGANMultiScaleDiscriminator", dict(
        scales=2, channels=8, max_downsample_channels=32,
        downsample_scales=[2, 2])),
    "style_melgan": ("StyleMelGANDiscriminator", dict(
        repeats=1, window_sizes=[64, 128], pqmf_params=[
            [1, None, None, None], [2, 62, 0.26700, 9.0]],
        discriminator_params=dict(channels=8, max_downsample_channels=16,
                                  downsample_scales=[2, 2]))),
    "pwg": ("ParallelWaveGANDiscriminator", dict(layers=3, conv_channels=8)),
}


def _random_state_dict(model_type: str, params: dict, seed: int) -> dict:
    """A port model's state dict in the reference's keys and layouts, every
    floating entry drawn from ``seed``. The port keeps a PWG upsampling
    Conv2d's effective weight (``weight``); the reference its weight norm
    (``weight_v``, ``weight_g``), which this state dict holds instead."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in build_model(model_type, params).state_dict().items():
        if ".up_layers." in k and k.endswith(".weight"):
            sd[k + "_v"] = v
            sd[k + "_g"] = torch.ones(v.shape[0], 1, 1, 1)
        else:
            sd[k] = v
    return {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(
                np.float32)) if v.is_floating_point() else v
            for k, v in sd.items()}


def _assert_tree_equal(got, want, where="", rtol=0.0, folded=()):
    assert type(got) is type(want) or (isinstance(want, np.ndarray)
                                       and isinstance(got, np.ndarray)), where
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{where}.{k}", rtol, folded)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, where
    if any(where.endswith(f) for f in folded):
        np.testing.assert_allclose(got, want, rtol=rtol, err_msg=where)
    else:
        np.testing.assert_array_equal(got, want, err_msg=where)


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_to_jax_matches_jax_importer(name):
    gen_type, gp = GENERATORS[name]
    sd = _random_state_dict(gen_type, gp, len(name))
    got_params, got_mutables = GENERATOR_TO_JAX[gen_type](sd, gp)
    want_params, want_mutables = GENERATOR_IMPORTERS[gen_type](
        {k: v.clone() for k, v in sd.items()}, gp)
    _assert_tree_equal(got_params, want_params, name)
    _assert_tree_equal(got_mutables, want_mutables, f"{name}/mutables")
    # the round trip through the port's forward converter
    back = generator_to_state_dict(gen_type, got_params, got_mutables, gp,
                                   steps=5)
    again, again_mutables = GENERATOR_TO_JAX[gen_type](back, gp)
    _assert_tree_equal(again, got_params, name, rtol=1e-6, folded=("_w",))
    _assert_tree_equal(again_mutables, got_mutables, f"{name}/mutables")
    if gen_type != "ParallelWaveGANGenerator":
        for k, v in sd.items():
            if k.endswith("num_batches_tracked"):
                assert int(back[k]) == 5, k
            else:
                torch.testing.assert_close(back[k], v, rtol=0, atol=0,
                                           msg=k)


@pytest.mark.parametrize("name", sorted(DISCRIMINATORS))
def test_discriminator_to_jax_matches_jax_importer(name):
    disc_type, dp = DISCRIMINATORS[name]
    sd = _random_state_dict(disc_type, dp, len(name) + 100)
    got = DISCRIMINATOR_TO_JAX[disc_type](sd, dp)
    _assert_tree_equal(got, DISCRIMINATOR_IMPORTERS[disc_type](
        {k: v.clone() for k, v in sd.items()}, dp), name)
    back = discriminator_to_state_dict(disc_type, got, dp)
    _assert_tree_equal(DISCRIMINATOR_TO_JAX[disc_type](back, dp), got, name)
    assert sorted(k for k in sd if not k.startswith("pqmf")) == sorted(back)


@pytest.mark.parametrize("chunk", [None, 64], ids=["whole", "chunked"])
def test_save_msgpack_writes_flax_bytes(chunk, tmp_path, monkeypatch):
    if chunk is not None:
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(port_ckpt, "MAX_CHUNK_SIZE", chunk)
    rng = np.random.default_rng(0)
    tree = {"model": {"generator": {
                "z_conv": {"w": rng.standard_normal((3, 4, 5)).astype(
                    np.float32), "b": np.arange(5, dtype=np.int32)},
                "a_fc": {"w": rng.standard_normal((2, 50))}}},
            "steps": 7, "epochs": np.int64(2), "optimizer": {},
            "mutables": {"generator": {}}, "scheduler": {"gamma": 0.5},
            "note": None, "lr": np.float32(1e-4)}
    path = tmp_path / "ckpt.pkl"
    port_ckpt.save_msgpack(str(path), tree)
    assert path.read_bytes() == flax.serialization.msgpack_serialize(tree)
    loaded = port_ckpt.load_msgpack(str(path))
    np.testing.assert_array_equal(loaded["model"]["generator"]["a_fc"]["w"],
                                  tree["model"]["generator"]["a_fc"]["w"])


CONVERT = {
    "hifi_car_msmpd": ("HiFiGANGenerator", HIFI_CAR,
                       "HiFiGANMultiScaleMultiPeriodDiscriminator", MSMPD),
    "bigru": ("BiGRU", GENERATORS["bigru"][1], None, None),
    # a discriminator whose keys do not match its type: left out, logged
    "hifi_car_bad_disc": ("HiFiGANGenerator", HIFI_CAR,
                          "MelGANMultiScaleDiscriminator",
                          DISCRIMINATORS["melgan_msd"][1]),
}


def _reference_pickle(tmp_path, name):
    gen_type, gp, disc_type, dp = CONVERT[name]
    model = {"generator": _random_state_dict(gen_type, gp, 1)}
    if disc_type is not None:
        model["discriminator"] = _random_state_dict(
            "HiFiGANMultiScaleMultiPeriodDiscriminator", MSMPD, 2)
    config = {"generator_type": gen_type, "generator_params": gp,
              "sampling_rate": 16000, "hop_size": 20, "batch_max_steps": 200,
              "format": "npy",
              "dataset_mode": "w2a" if gen_type == "BiGRU" else "a2w"}
    if gen_type == "BiGRU":
        config.update(hop_size=16, batch_max_steps=160)
    if disc_type is not None:
        config.update(discriminator_type=disc_type, discriminator_params=dp)
    (tmp_path / "config.yml").write_text(yaml.dump(config))
    ref = tmp_path / "checkpoint-40steps.pkl"
    torch.save({"model": model, "optimizer": {}, "scheduler": {},
                "steps": 40, "epochs": 3}, ref)
    return ref, config


@pytest.mark.parametrize("name", sorted(CONVERT))
def test_convert_checkpoint_writes_jax_packages_file(name, tmp_path,
                                                     monkeypatch, capsys):
    ref, config = _reference_pickle(tmp_path, name)
    mine, theirs = tmp_path / "port.ckpt", tmp_path / "jax.ckpt"
    convert_checkpoint.main(["--checkpoint", str(ref), "--out", str(mine)])
    assert "converted generator" in capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", [
        "convert_checkpoint", "--checkpoint", str(ref), "--out", str(theirs)])
    jax_convert.main()
    assert mine.read_bytes() == theirs.read_bytes()
    payload = flax.serialization.msgpack_restore(mine.read_bytes())
    assert payload["steps"] == 40 and payload["epochs"] == 3
    assert ("discriminator" in payload["model"]) == (name == "hifi_car_msmpd")
    if name != "hifi_car_msmpd":
        return
    # the JAX package decodes the port's file as its own
    from articulatory_tpu.inference import ar_loop, load_model

    x = np.random.default_rng(3).standard_normal((25, 13)).astype(np.float32)
    outs = [ar_loop(load_model(str(p), config), x, config)
            for p in (mine, theirs)]
    assert np.isfinite(outs[0]).all() and outs[0].shape == (25 * 20,)
    np.testing.assert_array_equal(outs[0], outs[1])
