"""HuBERT (``_h2``) inversion of the port (``bin/predict_ema.py``) against
the JAX recipe script ``egs/ema/voc1/local/predict_ema.py``, on the CPU,
with a tiny random-init ``transformers`` HuBERT saved to a temporary
directory (``ARTICULATORY_HUBERT_MODEL``), as ``tests/test_ssl_inversion.py``
does; nothing is fetched.

The interpolated features equal JAX's ``hubert_features`` (1e-6) at both
factors, and ``interpolate_states`` alone is torch's linear
``align_corners=False`` interpolation. The ``_h2`` predict of an ``hprc*``
experiment (x2) and of another (x4) writes JAX's files: per chunk with the
carry shared (the port's chunk forward from JAX's previous output, rtol
1e-4 / atol 1e-5), and end to end at the same tolerance; with
``--ar-scan --batch 2`` too."""

import functools
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch
import yaml

import flax.serialization
import jax
import jax.numpy as jnp

from articulatory_tpu.models import BiGRU as JaxBiGRU
from articulatory_tpu_torch import inference
from articulatory_tpu_torch.bin import predict_ema
from articulatory_tpu_torch.utils.io import read_wav, write_wav

torch.set_num_threads(1)
# JAX's programs compiled at XLA's lowest backend optimisation level, as
# in tests/test_torch_port_cond_train.py
_jit = functools.partial(jax.jit, compiler_options={
    "xla_backend_optimization_level": 0,
    "xla_llvm_disable_expensive_passes": True})
TOL = dict(rtol=1e-4, atol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN, OUT, AR_INPUT, CHUNK = 32, 12, 48, 100
GP = dict(in_channels=HIDDEN + 8, hidden_size=16, out_channels=OUT,
          use_ar=True, ar_input=AR_INPUT, ar_hidden=8, ar_output=8)
CONFIG = {"dataset_mode": "w2a", "batch_max_steps": CHUNK, "hop_size": 80,
          "sampling_rate": 16000, "format": "npy", "generator_type": "BiGRU",
          "generator_params": GP}


def _jax_script():
    path = os.path.join(ROOT, "egs", "ema", "voc1", "local", "predict_ema.py")
    spec = importlib.util.spec_from_file_location("jax_predict_ema_h2", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def hubert_dir(tmp_path_factory):
    from transformers import HubertConfig, HubertModel

    torch.manual_seed(0)
    model = HubertModel(HubertConfig(
        hidden_size=HIDDEN, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, conv_dim=(16,) * 7, vocab_size=10))
    path = str(tmp_path_factory.mktemp("hubert") / "tiny_hubert")
    model.save_pretrained(path)
    return path


@pytest.fixture
def hubert(hubert_dir, monkeypatch):
    monkeypatch.setenv("ARTICULATORY_HUBERT_MODEL", hubert_dir)
    monkeypatch.setattr(predict_ema, "_HUBERT", None)
    return hubert_dir


@functools.cache
def _variables():
    model = JaxBiGRU(**GP)
    v = jax.device_get(_jit(functools.partial(
        model.init, ar=jnp.zeros((1, AR_INPUT // OUT, OUT))))(
            jax.random.PRNGKey(5), jnp.zeros((1, CHUNK, HIDDEN))))
    rng = np.random.default_rng(5)
    stats = {"mean": rng.standard_normal(128).astype(np.float32) * 0.3,
             "var": rng.uniform(0.2, 2.0, 128).astype(np.float32)}
    return v["params"], {"batch_stats": {"bn": stats}}


def _experiment(root, exp_id):
    exp = root / "exp" / exp_id
    exp.mkdir(parents=True)
    (exp / "config.yml").write_text(yaml.dump(CONFIG))
    params, mutables = _variables()
    with open(exp / "best_mel_ckpt.pkl", "wb") as f:
        f.write(flax.serialization.msgpack_serialize(
            {"model": {"generator": params},
             "mutables": {"generator": mutables}, "steps": 1}))
    wav_dir = root / "wavs"
    wav_dir.mkdir()
    rng = np.random.default_rng(9)
    for i, n in enumerate((32000, 33600)):
        write_wav(str(wav_dir / f"utt{i}.wav"),
                  rng.standard_normal(n).astype(np.float32) * 0.1, 16000)
    return exp, wav_dir


@pytest.mark.parametrize("factor", [2, 4])
def test_hubert_features_match_jax(hubert, factor):
    audio = np.random.default_rng(factor).standard_normal(16000).astype(
        np.float32) * 0.1
    want = _jax_script().hubert_features(audio, interp_factor=factor)
    got = predict_ema.hubert_features(audio, factor, "cpu")
    states = predict_ema.hubert_states(audio, "cpu")
    assert got.shape == want.shape == (states.shape[1] * factor, HIDDEN)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the part after HuBERT alone: torch's linear interpolation
    ref = torch.nn.functional.interpolate(
        states.transpose(1, 2), scale_factor=factor, mode="linear",
        align_corners=False).transpose(1, 2)[0]
    torch.testing.assert_close(predict_ema.interpolate_states(states, factor),
                               ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("exp_id,flags", [
    ("hprc_w2a_h2", []), ("mngu0_w2a_h2", []),
    ("mngu0_w2a_h2", ["--ar-scan", "--batch", "2"])],
    ids=["hprc", "mngu0", "mngu0_scan_batch2"])
def test_h2_predict_matches_jax_script(hubert, tmp_path, monkeypatch,
                                       exp_id, flags):
    exp, wav_dir = _experiment(tmp_path, exp_id)
    monkeypatch.setattr(sys, "argv", ["predict_ema.py", str(exp),
                                      str(wav_dir), str(tmp_path / "jax"),
                                      *flags])
    _jax_script().main()
    written = predict_ema.predict(
        str(exp), str(wav_dir), str(tmp_path / "port"), device="cpu",
        ar_scan="--ar-scan" in flags, batch=2 if flags else 1)
    assert written == ["utt0", "utt1"]
    model = inference.load_model(str(exp / "best_mel_ckpt.pkl"), CONFIG,
                                 device="cpu")
    factor = predict_ema.interp_factor_of(exp_id)
    carry = AR_INPUT // OUT
    for i in range(2):
        want = np.load(tmp_path / "jax" / f"utt{i}.npy")
        got = np.load(tmp_path / "port" / f"utt{i}.npy")
        assert got.shape == want.shape and want.shape[1] == OUT
        np.testing.assert_allclose(got, want, **TOL)
        if flags:
            continue
        # per chunk, each from JAX's previous output
        feats = predict_ema.hubert_features(
            read_wav(str(wav_dir / f"utt{i}.wav"))[0], factor, "cpu")
        assert len(feats) >= len(want) > CHUNK
        prev = np.zeros((1, carry, OUT), np.float32)
        for start in range(0, len(want), CHUNK):
            rows = want[start:start + CHUNK]
            out = model(feats[None, start:start + len(rows)], prev)
            np.testing.assert_allclose(out[0].numpy(), rows, **TOL,
                                       err_msg=f"utt{i} chunk at {start}")
            prev = want[None, start + len(rows) - carry:start + len(rows)]
