"""The port's BiGRU inversion model, its weights and checkpoint loading, and
its MFCC features against the JAX package, on the CPU: the same params and
inputs through JAX's ``models/rnn.py::BiGRU`` and the port's, f32 at rtol
1e-4 / atol 1e-5 and f64 at 1e-10; ``jax_bigru_to_state_dict`` key for key
and array for array against ``torch_export.export_bigru``; ``mfcc_np``
against JAX's at 1e-10."""

import numpy as np
import pytest
import torch

import flax.serialization
import jax
import jax.numpy as jnp

from articulatory_tpu import inference as jax_inference
from articulatory_tpu.models import BiGRU as JaxBiGRU
from articulatory_tpu.ops import mfcc as jax_mfcc
from articulatory_tpu.utils.torch_export import export_bigru
from articulatory_tpu_torch import inference
from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.ops import mfcc
from articulatory_tpu_torch.utils.weights import jax_bigru_to_state_dict

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
F64_TOL = dict(rtol=1e-10, atol=1e-10)
FEATS = 5

# (generator params, AR carry frames x channels, speaker embedding width)
CASES = {
    "plain": dict(out_channels=4),
    # ar_input 16 over 3 channels: a carry of 5 frames, 15 encoder inputs
    "ar_ragged": dict(out_channels=3, use_ar=True, ar_input=16, ar_hidden=8,
                      ar_output=6),
    "tanh_spk": dict(out_channels=2, use_tanh=True, use_spk_emb=True,
                     spk_emb_size=3, spk_emb_hidden=4),
}


def _gp(case):
    gp = dict(hidden_size=8, **CASES[case])
    gp["in_channels"] = (FEATS + gp.get("ar_output", 0) * gp.get("use_ar", 0)
                         + gp.get("spk_emb_hidden", 0)
                         * gp.get("use_spk_emb", 0))
    return gp


def _inputs(gp, seed=0, b=2, t=23):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, FEATS)).astype(np.float32)
    kwargs = {}
    if gp.get("use_ar"):
        frames = gp["ar_input"] // gp["out_channels"]
        kwargs["ar"] = rng.standard_normal(
            (b, frames, gp["out_channels"])).astype(np.float32)
    if gp.get("use_spk_emb"):
        kwargs["spk"] = rng.standard_normal(
            (b, gp["spk_emb_size"])).astype(np.float32)
    return x, kwargs


def _jax(gp, seed=0):
    """JAX BiGRU variables with random BatchNorm statistics."""
    model = JaxBiGRU(**gp)
    x, kwargs = _inputs(gp)
    variables = jax.device_get(model.init(
        jax.random.PRNGKey(seed), jnp.asarray(x),
        **{k: jnp.asarray(v) for k, v in kwargs.items()}))
    rng = np.random.default_rng(seed + 100)
    stats = {"mean": rng.standard_normal(128).astype(np.float32) * 0.3,
             "var": rng.uniform(0.2, 2.0, 128).astype(np.float32)}
    params = dict(variables["params"])
    params["bn"] = {"scale": rng.uniform(0.5, 1.5, 128).astype(np.float32),
                    "bias": rng.standard_normal(128).astype(np.float32) * 0.1}
    return model, params, {"batch_stats": {"bn": stats}}


def _port(gp, params, mutables):
    model = build_model("BiGRU", gp)
    model.load_state_dict(jax_bigru_to_state_dict(params, mutables, gp))
    return model.eval()


@pytest.mark.parametrize("case", sorted(CASES))
def test_bigru_matches_jax_f32(case):
    gp = _gp(case)
    jmodel, params, mutables = _jax(gp)
    x, kwargs = _inputs(gp, seed=1)
    want = np.asarray(jmodel.apply({"params": params, **mutables},
                                   jnp.asarray(x), **kwargs))
    with torch.no_grad():
        got = _port(gp, params, mutables)(
            torch.from_numpy(x), **{k: torch.from_numpy(v)
                                    for k, v in kwargs.items()})
    assert got.shape == want.shape == (2, 23, gp["out_channels"])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bigru_matches_jax_f64(case):
    gp = _gp(case)
    jmodel, params, mutables = _jax(gp)
    x, kwargs = _inputs(gp, seed=2)
    to64 = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float64),
                                     tree)
    with jax.enable_x64(True):
        want = np.asarray(jmodel.apply(
            {"params": to64(params), **to64(mutables)},
            jnp.asarray(x, jnp.float64),
            **{k: jnp.asarray(v, jnp.float64) for k, v in kwargs.items()}))
    model = _port(gp, params, mutables).double()
    with torch.no_grad():
        got = model(torch.from_numpy(x).double(),
                    **{k: torch.from_numpy(v).double()
                       for k, v in kwargs.items()})
    assert got.dtype == torch.float64 and want.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want, **F64_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_dict_matches_export_bigru(case):
    gp = _gp(case)
    _, params, mutables = _jax(gp)
    want = export_bigru(params, mutables, gp)
    got = jax_bigru_to_state_dict(params, mutables, gp)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    # and the port's module has exactly these keys and shapes
    port = build_model("BiGRU", gp).state_dict()
    assert sorted(port) == sorted(got)
    for key, value in port.items():
        assert value.shape == got[key].shape, key


def _w2a_config(gp):
    return {"dataset_mode": "w2a", "batch_max_steps": 100, "hop_size": 80,
            "sampling_rate": 16000, "format": "npy",
            "generator_type": "BiGRU", "generator_params": gp}


def _save(path, params, mutables):
    with open(path, "wb") as f:  # the JAX package's checkpoint format
        f.write(flax.serialization.msgpack_serialize(
            {"model": {"generator": params},
             "mutables": {"generator": mutables}, "steps": 1}))
    return str(path)


def test_full_width_carry_checkpoint_loads(tmp_path):
    """ar_input 512 over 12 EMA channels: the encoder reads 42 x 12 = 504
    values; a JAX msgpack checkpoint (BatchNorm statistics in its
    mutables) loads through load_model, whose full-utterance inference
    equals JAX's (bucketed and trimmed alike)."""
    gp = dict(in_channels=FEATS + 16, hidden_size=8, out_channels=12,
              use_ar=True, ar_input=512, ar_hidden=8, ar_output=16)
    jmodel, params, mutables = _jax(gp)
    assert params["ar_model"]["fc0"]["w"].shape == (504, 8)
    config = _w2a_config(gp)
    path = _save(tmp_path / "ckpt.pkl", params, mutables)
    model = inference.load_model(path, config, device="cpu")
    assert model.model.ar_model.model[0].weight.shape == (8, 504)
    torch.testing.assert_close(
        model.model.bn.running_var,
        torch.from_numpy(mutables["batch_stats"]["bn"]["var"]))
    ref = jax_inference.load_model(path, config)
    x, kwargs = _inputs(gp, seed=3, b=1, t=37)
    carry = kwargs["ar"]
    np.testing.assert_allclose(model(x, ar=carry).numpy(),
                               np.asarray(ref(jnp.asarray(x), ar=carry)),
                               **TOL)


def test_non_ar_inference_matches_jax(tmp_path):
    gp = _gp("plain")
    _, params, mutables = _jax(gp)
    config = _w2a_config(gp)
    path = _save(tmp_path / "ckpt.pkl", params, mutables)
    model = inference.load_model(path, config, device="cpu")
    ref = jax_inference.load_model(path, config)
    x, _ = _inputs(gp, seed=4, b=1, t=45)
    for bucket in (None, 16):
        want = ref.inference(x[0], bucket_frames=bucket)
        got = model.inference(x[0], bucket_frames=bucket)
        assert got.shape == want.shape == (45, 4)
        np.testing.assert_allclose(got, want, **TOL)


def test_load_model_names_both_widths(tmp_path):
    gp = _gp("ar_ragged")
    _, params, mutables = _jax(gp)
    path = _save(tmp_path / "ckpt.pkl", params, mutables)
    wrong = dict(gp, in_channels=FEATS)  # the JAX package ignores it
    with pytest.raises(ValueError, match=rf"reads {gp['in_channels']} "
                       rf"inputs.*in_channels is {FEATS}"):
        inference.load_model(path, _w2a_config(wrong), device="cpu")


def test_bigru_weight_storage_and_training_raise(tmp_path):
    gp = _gp("plain")
    _, params, mutables = _jax(gp)
    path = _save(tmp_path / "ckpt.pkl", params, mutables)
    model = inference.load_model(path, _w2a_config(gp), device="cpu")
    # int8 and bf16 storage run since the zoo's rest (held against JAX's in
    # tests/test_torch_port_storage_zoo.py); the two schemes still exclude
    # each other, as in the JAX package
    quantized = inference.load_model(
        path, dict(_w2a_config(gp), weight_quant="int8"), device="cpu")
    assert quantized.quantized
    with pytest.raises(ValueError, match="pick one"):
        quantized.to_bf16_weights()
    model.to_bf16_weights()
    assert model.model.fc1[0].weight.dtype == torch.bfloat16
    # training runs since the zoo's port (batch statistics; held against
    # JAX's step in tests/test_torch_port_zoo_train.py)
    model = inference.load_model(path, _w2a_config(gp), device="cpu")
    model.model.train()
    with torch.no_grad():
        out = model.model(torch.randn(2, 4, FEATS))
    assert out.shape == (2, 4, gp["out_channels"])
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("sr,hop", [(16000, 80), (16000, 160), (22050, 80)])
def test_mfcc_matches_jax(sr, hop):
    rng = np.random.default_rng(hop)
    wav = rng.standard_normal(sr // 4).astype(np.float32) * 0.1
    want = jax_mfcc.mfcc_np(wav, sr, n_mfcc=13, n_fft=320, hop_length=hop,
                            n_mels=40)
    got = mfcc.mfcc_np(wav, sr, n_mfcc=13, n_fft=320, hop_length=hop,
                       n_mels=40)
    assert got.shape == want.shape == (13, len(wav) // hop + 1)
    np.testing.assert_allclose(got, want, **F64_TOL)
    mel = jax_mfcc.melspectrogram_np(wav, sr, n_fft=512, hop_length=hop,
                                     win_length=400, n_mels=64, fmin=50.0,
                                     fmax=7000.0)
    np.testing.assert_allclose(
        mfcc.melspectrogram_np(wav, sr, n_fft=512, hop_length=hop,
                               win_length=400, n_mels=64, fmin=50.0,
                               fmax=7000.0), mel, **F64_TOL)
    np.testing.assert_allclose(mfcc.power_to_db(mel, top_db=None),
                               jax_mfcc.power_to_db(mel, top_db=None),
                               **F64_TOL)
