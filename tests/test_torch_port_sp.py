"""Sequence parallelism: the port's time-tiled forward
(``LoadedModel.enable_sequence_parallel``, ``parallel/sp.py``) against the
JAX package's ``enable_sequence_parallel(4)`` on the 8 CPU devices conftest
provides (float64, 1e-10, the padded tail included), against the port's
unsharded forward of the padded input at a length where the tiles are
narrower than the halo and one where they are wider, and
``bin/decode.py --sequence-parallel 4`` against the unsharded decode (to 1
lsb of 16-bit PCM, as the JAX package's test allows). The widths are
``tests/test_sequence_parallel.py``'s."""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from articulatory_tpu.inference import LoadedModel as JaxLoadedModel
from articulatory_tpu.models import HiFiGANGenerator as JaxGenerator
from articulatory_tpu_torch.bin import decode as decode_cli
from articulatory_tpu_torch.inference import LoadedModel
from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.parallel.sp import receptive_field_frames
from articulatory_tpu_torch.utils.weights import jax_params_to_state_dict

torch.set_num_threads(1)

GP = dict(in_channels=13, out_channels=1, channels=16, kernel_size=7,
          upsample_scales=[5, 4], upsample_kernel_sizes=[10, 8],
          resblock_kernel_sizes=[3, 7], resblock_dilations=[[1, 3], [1, 3]])


def _jax_kwargs(gp):
    return {k: tuple(map(tuple, v)) if k == "resblock_dilations"
            else tuple(v) if isinstance(v, list) else v for k, v in gp.items()}


@functools.cache
def _params():
    jm = JaxGenerator(**_jax_kwargs(GP))
    return jm, jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 10, 13)))["params"])


def _models():
    jm, params = _params()
    port = build_model("HiFiGANGenerator", GP)
    port.load_state_dict(jax_params_to_state_dict(params, GP))
    return jm, params, port.double().eval()


def test_sp_forward_matches_jax_sequence_parallel():
    jm, params, port = _models()
    c = np.random.default_rng(0).standard_normal((2, 37, 13))  # 37 % 4 != 0
    with jax.enable_x64(True):
        theirs = JaxLoadedModel(
            model=jm, params=jax.tree.map(
                lambda a: jnp.asarray(a, jnp.float64), params),
            config={"generator_params": {"out_channels": 1}}, mutables={})
        theirs.enable_sequence_parallel(4)
        want = np.asarray(theirs(jnp.asarray(c)))
    ours = LoadedModel(model=port, config={"generator_params": GP},
                       device=torch.device("cpu"))
    ours.enable_sequence_parallel(4)
    got = ours(c).numpy()
    assert got.shape == want.shape == (2, 37 * 20, 1)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("frames", [37, 203])
def test_sp_forward_is_the_padded_forward(frames):
    """Tile for tile the unsharded forward of the zero-padded input: at 37
    frames the halo covers a tile, at 203 the tiles are wider."""
    _, _, port = _models()
    halo = receptive_field_frames(GP)
    c = torch.tensor(np.random.default_rng(1).standard_normal((1, frames, 13)))
    model = LoadedModel(model=port, config={"generator_params": GP},
                        device=torch.device("cpu"))
    model.enable_sequence_parallel(4)
    pad = -frames % 4
    with torch.no_grad():
        full = port(F.pad(c.transpose(1, 2), (0, pad)).transpose(1, 2))
    full = full[:, : frames * 20]
    got = model(c)
    if frames // 4 > halo:
        assert model.sp.halo == halo < frames // 4
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-10,
                               atol=1e-10)


def test_decode_cli_sequence_parallel(tmp_path):
    config = {
        "sampling_rate": 16000, "hop_size": 80, "batch_max_steps": 800,
        "dataset_mode": "a2w", "format": "npy",
        "generator_type": "HiFiGANGenerator",
        "generator_params": dict(GP, upsample_scales=[5, 4, 2, 2],
                                 upsample_kernel_sizes=[10, 8, 4, 4])}
    model = build_model("HiFiGANGenerator", config["generator_params"])
    torch.save({"model": {"generator": model.state_dict()}},
               tmp_path / "ckpt.pkl")
    (tmp_path / "config.yml").write_text(yaml.dump(config))
    rng = np.random.default_rng(2)
    lines = []
    for utt, frames in (("u0", 96), ("u1", 64)):
        np.save(tmp_path / f"{utt}.npy",
                rng.standard_normal((frames, 13)).astype(np.float32))
        lines.append(f"{utt} {tmp_path / f'{utt}.npy'}\n")
    (tmp_path / "feats.scp").write_text("".join(lines))
    base = ["--feats-scp", str(tmp_path / "feats.scp"), "--checkpoint",
            str(tmp_path / "ckpt.pkl"), "--verbose", "0", "--device", "cpu",
            "--bucket-frames", "32"]
    decode_cli.main(base + ["--outdir", str(tmp_path / "ref")])
    decode_cli.main(base + ["--outdir", str(tmp_path / "sp"),
                            "--sequence-parallel", "4"])
    for utt in ("u0", "u1"):
        _, ref = wavfile.read(tmp_path / "ref" / f"{utt}_gen.wav")
        _, sp = wavfile.read(tmp_path / "sp" / f"{utt}_gen.wav")
        assert ref.dtype == np.int16 and len(ref) == len(sp) > 0
        # wav files are 16-bit PCM; tile boundaries can flip an lsb
        np.testing.assert_allclose(sp.astype(np.int32),
                                   ref.astype(np.int32), atol=1)
