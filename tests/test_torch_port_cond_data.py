"""The conditioning's data and decode paths of the port against the JAX
package's, on the CPU:

- ``SpeechDataset`` with speakers (``utt2spk``, the training set's speaker
  ids shared with the dev set) and phonemes (``ph.scp``), and the mel
  stream of ph2m; ``SpeechCollater`` on their items with ``spk_id``,
  ``ph``, the cascade's ``ar2`` and the ph2a / ph2m streams, fed the same
  ``np.random.Generator`` seed: every array equal;
- the multimodal classes (``WavArtMultDataset``, ``ArtSCPMultDataset``,
  ``SpeechCollaterMult``) on ``tests/test_multimodal.py``'s cases, and
  ``ar_loop(modality=...)`` with an in-list callable: the shift-register
  case of that file, and a linear model of the interpolated chunk and the
  carry in float64 (1e-8, at a modality whose positions are exact) and
  float32 (rtol 1e-4 / atol 1e-5, at an inexact ratio);
- the decode loops on a phoneme-head (``use_ph_loss``) HiFi-CAR: ``ar_loop``
  in float64 against JAX's (1e-8), and in float32 each chunk against JAX's
  forward from the same carry (rtol 1e-4 / atol 1e-5), then the port's
  eager, batched and scan loops each chunk bit for bit against its own
  forward from the loop's carry.
"""

import functools

import numpy as np
import pytest
import torch

import flax.serialization
import jax
import jax.numpy as jnp

from articulatory_tpu import inference as jax_inference
from articulatory_tpu.data import collate as jax_collate
from articulatory_tpu.data import datasets as jax_datasets
from articulatory_tpu.data import multimodal as jax_mult
from articulatory_tpu.models import HiFiGANGenerator as JaxGenerator
from articulatory_tpu.utils.io import write_hdf5
from articulatory_tpu_torch import inference
from articulatory_tpu_torch.data import collate, datasets, multimodal

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
F64_TOL = dict(rtol=1e-8, atol=1e-8)
HOP, FRAMES = 8, 10  # batch_max_steps 80


def _corpus(root, n_feats=5, n_mel=4):
    """An npy dump of 5 training and 3 dev utterances with utt2spk (3
    speakers, one only in training), ph.scp and mels in ``-feats.npy``."""
    rng = np.random.default_rng(0)
    speakers = {"tr": ["b", "a", "c", "a", "b"], "dev": ["a", "b", "a"]}
    for stage, spks in speakers.items():
        dump, data = root / "dump" / stage / "norm", root / "data" / stage
        dump.mkdir(parents=True)
        data.mkdir(parents=True)
        feats, utt2spk, phs = [], [], []
        for i, spk in enumerate(spks):
            utt = f"{stage}{i}"
            n = 30 + 5 * i
            np.save(dump / f"{utt}-wave.npy",
                    (0.3 * rng.standard_normal(n * HOP + 3)).astype(np.float32))
            np.save(dump / f"{utt}-feats.npy",
                    rng.standard_normal((n + 2, n_mel)).astype(np.float32))
            np.save(data / f"{utt}.npy",
                    rng.standard_normal((n, n_feats)).astype(np.float32))
            np.save(data / f"{utt}-ph.npy", rng.integers(0, 7, n))
            feats.append(f"{utt} {data / f'{utt}.npy'}\n")
            utt2spk.append(f"{utt} {spk}\n")
            phs.append(f"{utt} {data / f'{utt}-ph.npy'}\n")
        (data / "feats.scp").write_text("".join(feats))
        (data / "utt2spk").write_text("".join(utt2spk))
        (data / "ph.scp").write_text("".join(phs))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    _corpus(root)
    return root


def _dataset(module, root, stage, **kwargs):
    return module.SpeechDataset(
        str(root / "dump" / stage / "norm"), audio_query="*-wave.npy",
        mel_query="*-feats.npy", audio_load_fn=np.load, mel_load_fn=np.load,
        data_root=str(root / "data"), **kwargs)


def _same(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = got[key], want[key]
        if key == "x":
            g, w = g[0], w[0]
        if w is None:
            assert g is None, key
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)


# (dataset mode, generator params and cascade keys, speakers, phonemes)
COLLATE = {
    "a2w_spk_ph_ar": ("a2w", {"generator_params": {"use_ar": True,
                                                   "ar_input": 40}},
                      True, True),
    "a2w_cascade_ar2": ("a2w", {"generator_params": {
        "use_ar": True, "ar_input": 40, "out_channels": 5},
        "generator2_type": "HiFiGANGenerator",
        "generator2_params": {"ar_input": 24}}, True, False),
    "w2a_cascade_ar2": ("w2a", {"generator_params": {
        "use_ar": True, "ar_input": 20, "out_channels": 5},
        "generator2_type": "HiFiGANGenerator",
        "generator2_params": {"ar_input": 24}}, False, False),
    "ph2a": ("ph2a", {"generator_params": {}}, False, True),
    "ph2m": ("ph2m", {"generator_params": {}}, True, True),
}


@pytest.mark.parametrize("name", sorted(COLLATE))
def test_dataset_and_collater_match_jax(corpus, name):
    mode, config, use_spk, use_ph = COLLATE[name]
    kwargs = dict(use_spk_id=use_spk, use_ph=use_ph, dataset_mode=mode)
    want_tr = _dataset(jax_datasets, corpus, "tr", **kwargs)
    got_tr = _dataset(datasets, corpus, "tr", **kwargs)
    assert got_tr.spks == want_tr.spks == ["a", "b", "c"]
    # the dev set numbers its speakers as the training set does
    want_dev = _dataset(jax_datasets, corpus, "dev", spks=want_tr.spks,
                        **kwargs)
    got_dev = _dataset(datasets, corpus, "dev", spks=got_tr.spks, **kwargs)
    for got, want in ((got_tr, want_tr), (got_dev, want_dev)):
        items = [got[i] for i in range(len(got))]
        for i, item in enumerate(items):
            _same(item, want[i])
        batches = [c(items) for c in (
            collate.SpeechCollater(FRAMES * HOP, HOP, dataset_mode=mode,
                                   use_spk_id=use_spk, use_ph=use_ph,
                                   config=config,
                                   rng=np.random.default_rng(7)),
            jax_collate.SpeechCollater(FRAMES * HOP, HOP, dataset_mode=mode,
                                       use_spk_id=use_spk, use_ph=use_ph,
                                       config=config,
                                       rng=np.random.default_rng(7)))]
        _same(*batches)
    batch = batches[0]
    if use_spk:
        assert batch["spk_id"].tolist() == [0, 1, 0]  # a, b, a
    if "generator2_type" in config:
        assert batch["ar2"].shape == (3, 24, 1)
    if mode.startswith("ph2"):
        assert batch["x"][0].dtype == np.int32
        assert batch["x"][0].shape == (3, FRAMES)


def test_dataset_needs_its_maps(tmp_path):
    (tmp_path / "data" / "tr").mkdir(parents=True)
    dump = tmp_path / "dump" / "tr" / "norm"
    dump.mkdir(parents=True)
    np.save(dump / "u-wave.npy", np.zeros(80, np.float32))
    np.save(dump / "u-feats.npy", np.zeros((10, 4), np.float32))
    (tmp_path / "data" / "tr" / "feats.scp").write_text("u x.npy\n")
    for flag, missing in (("use_spk_id", "utt2spk"), ("use_ph", "ph.scp")):
        with pytest.raises(FileNotFoundError, match=missing):
            _dataset(datasets, tmp_path, "tr", **{flag: True})


# -------------------------------------------------------------- multimodal

def _mult_batch(rng):
    return [(rng.standard_normal(4000).astype(np.float32),
             rng.standard_normal((50, 8)).astype(np.float32), 0),
            (rng.standard_normal(4005).astype(np.float32),
             rng.standard_normal((21, 12)).astype(np.float32), 1),
            (rng.standard_normal(4800).astype(np.float32),
             rng.standard_normal((60, 8)).astype(np.float32), 0)]


@pytest.mark.parametrize("absent", [False, True])
def test_speech_collater_mult_matches_jax(absent):
    """The two-modality case (EMA-like hop 80 at 16 kHz, MRI-like hop 240 at
    20 kHz) and an absent modality."""
    batch = _mult_batch(np.random.default_rng(0))
    if absent:
        batch = batch[:1]
    kwargs = dict(batch_max_steps=800, hop_size=80, hop_sizes=[80, 240],
                  sampling_rate=16000, sampling_rates=[16000, 20000],
                  ar_len=None if absent else 64)
    got = multimodal.SpeechCollaterMult(rng=np.random.default_rng(1),
                                        **kwargs)(batch)
    want = jax_mult.SpeechCollaterMult(rng=np.random.default_rng(1),
                                       **kwargs)(batch)
    assert sorted(got) == sorted(want)
    (x_got,), (x_want,) = got["x"], want["x"]
    assert len(x_got) == len(x_want) == 2
    for g, w in zip(x_got, x_want):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_array_equal(g, w)
    for key in set(got) - {"x"}:
        np.testing.assert_array_equal(got[key], want[key])
    if absent:
        assert x_got[1] is None
    else:
        assert x_got[0].shape == (2, 10, 8) and x_got[1].shape == (1, 10, 12)
        assert got["y"].shape == (3, 800, 1) and got["ar"].shape == (3, 64, 1)


def test_mult_datasets_match_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    monkeypatch.chdir(tmp_path)
    roots = []
    for mod, (stage, sr, n_art) in enumerate(
            [("ema_train", 16000, 8), ("mri_train", 20000, 12)]):
        dump = tmp_path / "dump" / stage / "norm"
        data = tmp_path / "data" / stage
        data.mkdir(parents=True)
        lines = []
        for u in range(2):
            fid = f"{stage}_utt{u}"
            write_hdf5(str(dump / f"{fid}.h5"), "wave",
                       rng.standard_normal(sr // 4).astype(np.float32))
            np.save(data / f"{fid}.npy",
                    rng.standard_normal((50, n_art)).astype(np.float32))
            lines.append(f"{fid} {data / f'{fid}.npy'} {mod}\n")
        (data / "feats.scp").write_text(
            "".join(" ".join(line.split()[:2]) + "\n" for line in lines))
        (tmp_path / f"{stage}.scp").write_text("".join(lines))
        roots.append(str(dump))
    kwargs = dict(sampling_rate=16000, sampling_rates=[16000, 20000],
                  data_root=str(tmp_path / "data"), transform="10*f0")
    got = multimodal.WavArtMultDataset(roots, **kwargs)
    want = jax_mult.WavArtMultDataset(roots, **kwargs)
    assert len(got) == len(want) == 4
    for i in range(4):
        (a, art, m), (wa, wart, wm) = got[i], want[i]
        assert m == wm and len(a) == 4000  # 20 kHz resampled to 16 kHz
        np.testing.assert_allclose(a, wa, rtol=1e-8, atol=1e-8)
        np.testing.assert_array_equal(art, wart)
    scp = str(tmp_path / "mri_train.scp")
    got = multimodal.ArtSCPMultDataset(scp, return_utt_id=True)
    want = jax_mult.ArtSCPMultDataset(scp, return_utt_id=True)
    assert len(got) == len(want) == 2
    for i in range(2):
        (uid, art, mod), (wuid, wart, wmod) = got[i], want[i]
        assert (uid, mod) == (wuid, wmod) == (f"mri_train_utt{i}", 1)
        np.testing.assert_array_equal(art, wart)


class _Ramp:
    """tests/test_multimodal.py's in-list stub: a ramp whatever the input,
    recording the carries it sees."""

    device = torch.device("cpu")

    def __init__(self, hop, array):
        self.hop, self.array, self.seen = hop, array, []

    def __call__(self, cin_list, ar=None):
        self.seen.append(np.asarray(ar))
        t_in = cin_list[0].shape[1]
        ramp = np.arange(1, t_in * self.hop + 1, dtype=np.float32)
        return self.array(np.broadcast_to(ramp[None, :, None],
                                          (1, t_in * self.hop, 1)).copy())


def _mult_config(hop, chunk, ar_input, hop_sizes, rates):
    return {"dataset_mode": "a2w_mult", "batch_max_steps": chunk,
            "hop_size": hop, "sampling_rate": 16000, "hop_sizes": hop_sizes,
            "sampling_rates": rates, "generator_params": {
                "out_channels": 1, "use_ar": True, "ar_input": ar_input,
                "in_list": ["ema", "mri"][:len(hop_sizes)]}}


def test_ar_loop_modality_shift_register_matches_jax():
    """The shift register of ``ar_input`` > a chunk moves in the modality
    branch (reference decode.py:77-81), as JAX's."""
    config = _mult_config(4, 16, 32, [4], [16000])
    x = np.random.default_rng(3).standard_normal((12, 3)).astype(np.float32)
    port, ref = _Ramp(4, torch.from_numpy), _Ramp(4, jnp.asarray)
    out = inference.ar_loop(port, x, config, modality=0)
    want = np.asarray(jax_inference.ar_loop(ref, x, config, modality=0))
    assert out.shape == want.shape == (48,)
    np.testing.assert_array_equal(out, want)
    assert len(port.seen) == len(ref.seen) == 3
    for g, w in zip(port.seen, ref.seen):
        np.testing.assert_array_equal(g, w)
    assert np.all(port.seen[0] == 0) and np.any(port.seen[1] != 0)


class _Linear:
    """An in-list model: a fixed linear map of the present modality's
    interpolated chunk, repeated to the hop, plus the carry's mean."""

    def __init__(self, hop, w, lib):
        self.hop, self.w, self.lib = hop, w, lib
        self.device = torch.device("cpu")

    def __call__(self, cin_list, ar):
        c = next(c for c in cin_list if c is not None)
        if self.lib == "torch":
            y = torch.tanh(c @ torch.as_tensor(self.w, dtype=c.dtype))
            y = y.repeat_interleave(self.hop, dim=1)
            return y + ar.mean(dim=1, keepdim=True)
        y = jnp.tanh(c @ jnp.asarray(self.w, c.dtype))
        return jnp.repeat(y, self.hop, axis=1) + ar.mean(axis=1,
                                                         keepdims=True)


@pytest.mark.parametrize("dtype,modality", [(np.float64, 1),
                                            (np.float32, 2)])
def test_ar_loop_modality_matches_jax(dtype, modality):
    """Modality 1 (hop 8 at 16 kHz) interpolates by exactly 2; modality 2
    (hop 240 at 20 kHz) by 2.4, whose positions are rounded."""
    config = _mult_config(4, 40, 24, [4, 8, 240], [16000, 16000, 20000])
    config["generator_params"]["in_list"] = ["a", "b", "c"]
    rng = np.random.default_rng(4)
    w = rng.standard_normal((3, 1))
    x = rng.standard_normal((27, 3)).astype(dtype)
    out = inference.ar_loop(_Linear(4, w, "torch"), x, config,
                            modality=modality)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jax_inference.ar_loop(_Linear(4, w, "jax"), x,
                                                config, modality=modality))
    assert out.dtype == want.dtype == dtype
    assert out.shape == want.shape
    np.testing.assert_allclose(out, want,
                               **(F64_TOL if dtype == np.float64 else TOL))


# ------------------------------------------- decoding a phoneme-head model

CHUNK = 10
PH_GP = dict(in_channels=13 + 8, out_channels=1, channels=16,
             upsample_scales=[10, 8], upsample_kernel_sizes=[20, 16],
             resblock_kernel_sizes=[3], resblock_dilations=[[1, 3]],
             use_ar=True, ar_input=64, ar_hidden=8, ar_output=8,
             use_ph_loss=True, num_ph=6)
PH_CONFIG = {"dataset_mode": "a2w", "batch_max_steps": CHUNK * 80,
             "hop_size": 80, "sampling_rate": 16000, "format": "npy",
             "generator_type": "HiFiGANGenerator", "generator_params": PH_GP}


@pytest.fixture(scope="module")
def ph_ckpt(tmp_path_factory):
    model = JaxGenerator(**{k: tuple(map(tuple, v))
                            if k == "resblock_dilations" else tuple(v)
                            if isinstance(v, list) else v
                            for k, v in PH_GP.items()})
    # compiled at XLA's lowest backend optimisation level: random weights
    # either way, in a fraction of the compile time
    init = jax.jit(model.init, compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})
    params = jax.device_get(init(
        jax.random.PRNGKey(5), jnp.zeros((1, CHUNK, 13)),
        ar=jnp.zeros((1, 64, 1)))["params"])
    path = tmp_path_factory.mktemp("ph") / "ckpt.pkl"
    path.write_bytes(flax.serialization.msgpack_serialize(
        {"model": {"generator": params}, "steps": 1}))
    return str(path)


@functools.cache
def _ph_models(path):
    return (jax_inference.load_model(path, PH_CONFIG),
            inference.load_model(path, PH_CONFIG, device="cpu"))


def test_ph_loss_model_ar_loop_float64_matches_jax(ph_ckpt):
    jax_model, _ = _ph_models(ph_ckpt)
    model = inference.load_model(ph_ckpt, PH_CONFIG, device="cpu")
    model.model.double()
    x = np.random.default_rng(6).standard_normal((37, 13))
    with jax.enable_x64(True):
        want = np.asarray(jax_inference.ar_loop(jax_model, x, PH_CONFIG))
    out = inference.ar_loop(model, x, PH_CONFIG)
    assert out.dtype == want.dtype == np.float64
    assert out.shape == want.shape == (37 * 80,)
    np.testing.assert_allclose(out, want, **F64_TOL)


def test_ph_loss_model_loops_match_jax_per_chunk(ph_ckpt):
    """Each chunk against JAX's forward from the same carry; the port's
    eager, batched and scan loops each chunk bit for bit against its own
    forward (the phoneme logits dropped) from the loop's carry."""
    jax_model, model = _ph_models(ph_ckpt)
    xs = [np.random.default_rng(7 + i).standard_normal(
        (3 * CHUNK, 13)).astype(np.float32) for i in range(2)]
    prev = np.zeros((2, 64, 1), np.float32)
    for i in range(3):
        cin = np.stack([x[i * CHUNK:(i + 1) * CHUNK] for x in xs])
        want = np.asarray(jax_model(jnp.asarray(cin), ar=jnp.asarray(prev)))
        got = model(cin, ar=prev).numpy()
        assert got.shape == want.shape == (2, CHUNK * 80, 1)
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"chunk {i}")
        prev = want[:, -64:]
    # (outputs, lanes a forward): the reference forwards take the loop's
    # batch, as a convolution's sums follow its batch size
    runs = {"eager": ([inference.ar_loop(model, x, PH_CONFIG) for x in xs],
                      1),
            "scan_one": ([inference.ar_loop_scan(model, x, PH_CONFIG)
                          for x in xs], 1),
            "batched": (inference.ar_loop_batched(model, xs, PH_CONFIG), 2),
            "scan": (inference.ar_loop_batched(model, xs, PH_CONFIG,
                                               scan=True), 2)}
    n = CHUNK * 80
    for name, (outs, lanes) in runs.items():
        assert all(out.shape == (3 * n,) for out in outs), name
        for group in range(0, 2, lanes):
            part = slice(group, group + lanes)
            out = np.stack(outs[part])
            prev = np.zeros((lanes, 64, 1), np.float32)
            for i in range(3):
                cin = np.stack([x[i * CHUNK:(i + 1) * CHUNK]
                                for x in xs[part]])
                chunk = model(cin, ar=prev).numpy()[..., 0]
                np.testing.assert_array_equal(
                    out[:, i * n:(i + 1) * n], chunk,
                    err_msg=f"{name} chunk {i}")
                prev = out[:, (i + 1) * n - 64:(i + 1) * n, None]
