"""The port's w2a (inversion) decode against the JAX package on the CPU:
``ar_loop`` per chunk under a shared carry in both carry regimes and end to
end (f32 rtol 1e-4 / atol 1e-5, f64 1e-8), ``ar_loop_batched`` eager and
``scan=True`` (the captured step's plain version here), ``ar_loop_scan``
with a ragged tail, a sub-hop tail, no whole chunk and a chunk bucket, the
decode CLI in ``dataset_mode: w2a`` and the MFCC path of ``predict_ema``
against the JAX recipe script on the same synthetic wavs.

Chunks are 32 rows with ``hop_size`` 8, so a tail of 8-31 rows is kept and
one of 1-7 dropped; a BiGRU with 4 output channels, ``ar_input`` 16 (a
carry of 4 frames, the last window) or 200 (50 frames > 32 rows, the shift
register)."""

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

from articulatory_tpu import inference as jax_inference
from articulatory_tpu.models import BiGRU as JaxBiGRU
from articulatory_tpu_torch import inference
from articulatory_tpu_torch.bin import decode as decode_cli
from articulatory_tpu_torch.bin import predict_ema
from articulatory_tpu_torch.utils.io import read_wav, write_wav

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
F64_TOL = dict(rtol=1e-8, atol=1e-8)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK, HOP, OUT = 32, 8, 4


def _gp(ar_input, feats=5):
    return dict(in_channels=feats + 8, hidden_size=8, out_channels=OUT,
                use_ar=True, ar_input=ar_input, ar_hidden=8, ar_output=8)


def _config(ar_input, feats=5):
    return {"dataset_mode": "w2a", "batch_max_steps": CHUNK, "hop_size": HOP,
            "sampling_rate": 16000, "format": "npy",
            "generator_type": "BiGRU",
            "generator_params": _gp(ar_input, feats)}


@functools.cache
def _variables(ar_input, feats=5):
    model = JaxBiGRU(**_gp(ar_input, feats))
    v = jax.device_get(model.init(
        jax.random.PRNGKey(ar_input), jnp.zeros((1, CHUNK, feats)),
        ar=jnp.zeros((1, ar_input // OUT, OUT))))
    rng = np.random.default_rng(ar_input)
    stats = {"mean": rng.standard_normal(128).astype(np.float32) * 0.3,
             "var": rng.uniform(0.2, 2.0, 128).astype(np.float32)}
    return v["params"], {"batch_stats": {"bn": stats}}


def _write_ckpt(path, ar_input, feats=5):
    params, mutables = _variables(ar_input, feats)
    with open(path, "wb") as f:  # the JAX package's checkpoint format
        f.write(flax.serialization.msgpack_serialize(
            {"model": {"generator": params},
             "mutables": {"generator": mutables}, "steps": 1}))
    return str(path)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("w2a")
    return {ar: _write_ckpt(root / f"ckpt_{ar}.pkl", ar) for ar in (16, 200)}


@functools.cache
def _jax_model(path, ar_input):
    return jax_inference.load_model(path, _config(ar_input))


def _models(ckpts, ar_input):
    config = _config(ar_input)
    return (_jax_model(ckpts[ar_input], ar_input),
            inference.load_model(ckpts[ar_input], config, device="cpu"),
            config)


def _feats(seed, lengths, feats=5):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((t, feats)).astype(np.float32)
            for t in lengths]


@pytest.mark.parametrize("ar_input", [16, 200])
def test_chunks_match_jax_with_shared_carry(ckpts, ar_input):
    jax_model, model, config = _models(ckpts, ar_input)
    carry = ar_input // OUT
    assert (carry <= CHUNK) == (ar_input == 16)
    (x,) = _feats(ar_input, [4 * CHUNK])
    prev = np.zeros((2, carry, OUT), np.float32)
    for i in range(4):
        cin = np.stack([x[i * CHUNK:(i + 1) * CHUNK],
                        x[::-1][i * CHUNK:(i + 1) * CHUNK]])
        ref = np.asarray(jax_model(jnp.asarray(cin), ar=jnp.asarray(prev)))
        out = model(cin, ar=prev).numpy()
        assert out.shape == ref.shape == (2, CHUNK, OUT)
        np.testing.assert_allclose(out, ref, **TOL, err_msg=f"chunk {i}")
        # JAX's rule: the tail, or the register slid by the input rows
        prev = (ref[:, -carry:] if carry <= CHUNK else
                np.concatenate([prev[:, CHUNK:], ref], axis=1))


@pytest.mark.parametrize("ar_input", [16, 200])
@pytest.mark.parametrize("rows", [96, 77, 69], ids=["whole", "tail", "subhop"])
def test_ar_loop_matches_jax(ckpts, ar_input, rows):
    jax_model, model, config = _models(ckpts, ar_input)
    (x,) = _feats(rows, [rows])
    ref = np.asarray(jax_inference.ar_loop(jax_model, x, config))
    out = inference.ar_loop(model, x, config)
    kept = 64 if rows == 69 else rows  # a 5-row tail is under a hop
    assert out.shape == ref.shape == (kept, OUT)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("ar_input", [16, 200])
def test_ar_loop_float64_matches_jax(ckpts, ar_input):
    jax_model, model, config = _models(ckpts, ar_input)
    model.model.double()
    (x,) = _feats(7, [109])
    x = x.astype(np.float64)
    # JAX's BiGRU keeps f32 params' arithmetic in places: give it f64 ones
    to64 = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float64),
                                     tree)
    params, mutables = _variables(ar_input)
    with jax.enable_x64(True):
        jax_model = jax_inference.LoadedModel(
            model=jax_model.model, params=to64(params), config=config,
            mutables=to64(mutables))
        ref = np.asarray(jax_inference.ar_loop(jax_model, x, config))
    out = inference.ar_loop(model, x, config)
    assert out.dtype == ref.dtype == np.float64
    assert out.shape == ref.shape == (109, OUT)
    np.testing.assert_allclose(out, ref, **F64_TOL)


@pytest.mark.parametrize("ar_input", [16, 200])
def test_ar_loop_batched_matches_jax(ckpts, ar_input):
    """Eager and scan lanes against JAX's, the lanes' tails dropped or
    trimmed as JAX's; whole chunks equal the sequential loop's."""
    jax_model, model, config = _models(ckpts, ar_input)
    xs = _feats(8, [96, 70, 45, 5])
    for scan in (False, True):
        ref = jax_inference.ar_loop_batched(jax_model, xs, config, scan=scan)
        outs = inference.ar_loop_batched(model, xs, config, scan=scan)
        for x, out, r in zip(xs, outs, ref):
            assert out.shape == np.asarray(r).shape
            np.testing.assert_allclose(out, r, **TOL)
    assert [o.shape[0] for o in outs] == [96, 64, 45, 0]
    eager = inference.ar_loop_batched(model, xs, config)
    for x, out, e in zip(xs, outs, eager):
        np.testing.assert_array_equal(out, e)
        whole = len(x) // CHUNK * CHUNK
        np.testing.assert_allclose(out[:whole], inference.ar_loop(
            model, x, config)[:whole], **TOL)


def test_ar_loop_batched_all_empty(ckpts):
    _, model, config = _models(ckpts, 16)
    for scan in (False, True):
        outs = inference.ar_loop_batched(
            model, _feats(9, [5, 0]), config, scan=scan)
        assert [o.shape for o in outs] == [(0, OUT), (0, OUT)]


@pytest.mark.parametrize("ar_input", [16, 200])
@pytest.mark.parametrize("rows,bucket", [(77, 0), (69, 0), (20, 0), (77, 4),
                                         (5, 0)],
                         ids=["ragged", "subhop", "no_whole_chunk",
                              "bucket4", "nothing"])
def test_ar_loop_scan_matches_jax(ckpts, ar_input, rows, bucket):
    """Whole chunks through the scan, an exact tail forward after them:
    equal to JAX's scan and to the sequential loop (the tail included)."""
    jax_model, model, config = _models(ckpts, ar_input)
    (x,) = _feats(rows + ar_input, [rows])
    ref = np.asarray(jax_inference.ar_loop_scan(jax_model, x, config,
                                                chunk_bucket=bucket))
    out = inference.ar_loop_scan(model, x, config, chunk_bucket=bucket)
    assert out.shape == ref.shape == (config_rows(rows), OUT)
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, inference.ar_loop(model, x, config),
                               **TOL)


def config_rows(rows):
    rem = rows % CHUNK
    return rows - rem if 0 < rem < HOP else rows


def _wav_corpus(tmp_path, lengths, seed=0):
    rng = np.random.default_rng(seed)
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    lines = []
    for i, n in enumerate(lengths):
        path = wav_dir / f"utt{i}.wav"
        write_wav(str(path), rng.standard_normal(n).astype(np.float32) * 0.2,
                  16000)
        lines.append(f"utt{i} {path}")
    scp = tmp_path / "wav.scp"
    scp.write_text("\n".join(lines) + "\n")
    return wav_dir, str(scp)


def test_decode_cli_w2a(tmp_path):
    """Raw waves of a wav.scp (input width 1 + 8 AR) into <utt>_gen.npy:
    eager against JAX's ar_loop; --ar-scan and --decode-batch-size 4
    --ar-scan against the port's scan loops (held to JAX's above)."""
    config = _config(16, feats=1)
    ckpt = _write_ckpt(tmp_path / "ckpt.pkl", 16, feats=1)
    cfg_path = tmp_path / "config.yml"
    cfg_path.write_text(yaml.dump(config))
    _, scp = _wav_corpus(tmp_path, [100, 77, 69])
    jax_model = jax_inference.load_model(ckpt, config)
    model = inference.load_model(ckpt, config, device="cpu")
    waves = [read_wav(line.split()[1])[0]
             for line in open(scp).read().splitlines()]
    runs = {"eager": [], "scan": ["--ar-scan"],
            "batch": ["--decode-batch-size", "4", "--ar-scan"]}
    for name, flags in runs.items():
        out = tmp_path / name
        decode_cli.main(["--feats-scp", scp, "--checkpoint", ckpt,
                         "--config", str(cfg_path), "--outdir", str(out),
                         "--device", "cpu", "--verbose", "0", *flags])
        want = {"eager": lambda: [np.asarray(jax_inference.ar_loop(
                    jax_model, w, config)) for w in waves],
                "scan": lambda: [inference.ar_loop_scan(
                    model, w, config, chunk_bucket=4) for w in waves],
                "batch": lambda: inference.ar_loop_batched(
                    model, waves, config, scan=True)}[name]()
        for i, ref in enumerate(want):
            got = np.load(out / f"utt{i}_gen.npy")
            assert got.shape == ref.shape == (config_rows(len(waves[i])), OUT)
            np.testing.assert_allclose(got, ref, **TOL)


def test_decode_cli_w2a_needs_a_wav_scp(ckpts, tmp_path):
    # a wav.scp or, since the zoo's port, a dump directory's input stream
    # (<utt>-wave.npy; tests/test_torch_port_zoo_train.py); not neither
    with pytest.raises(ValueError, match="either --dumpdir or --feats-scp"):
        decode_cli.decode(_config(16), ckpts[16], str(tmp_path / "o"),
                          device="cpu")
    # w2a decodes in lanes and through the captured loop, not one
    # utterance at a time
    assert "w2a" not in decode_cli._SEQUENTIAL_MODES


def _jax_script():
    path = os.path.join(ROOT, "egs", "ema", "voc1", "local",
                        "predict_ema.py")
    spec = importlib.util.spec_from_file_location("jax_predict_ema", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("flags", [[], ["--ar-scan", "--batch", "4"]],
                         ids=["loop", "scan_batch4"])
def test_predict_ema_matches_jax_script(tmp_path, monkeypatch, flags):
    """MFCC-13 inversion of a wav directory: the port's entry point against
    the JAX recipe script with the same arguments."""
    exp = tmp_path / "exp" / "mngu0_w2a_mfcc"
    exp.mkdir(parents=True)
    config = dict(_config(16, feats=13), batch_max_steps=100, hop_size=80)
    (exp / "config.yml").write_text(yaml.dump(config))
    _write_ckpt(exp / "best_mel_ckpt.pkl", 16, feats=13)
    wav_dir, _ = _wav_corpus(tmp_path, [16000, 9000, 12345])
    feats = predict_ema.wav2mfcc(read_wav(str(wav_dir / "utt0.wav"))[0],
                                 16000, hop_length=80)
    np.testing.assert_allclose(feats, _jax_script().wav2mfcc(
        read_wav(str(wav_dir / "utt0.wav"))[0], 16000, hop_length=80),
        rtol=1e-10, atol=1e-10)
    monkeypatch.setattr(sys, "argv", ["predict_ema.py", str(exp),
                                      str(wav_dir), str(tmp_path / "jax"),
                                      *flags])
    _jax_script().main()
    predict_ema.main([str(exp), str(wav_dir), str(tmp_path / "port"),
                      *flags, "--device", "cpu"])
    for i in range(3):
        want = np.load(tmp_path / "jax" / f"utt{i}.npy")
        got = np.load(tmp_path / "port" / f"utt{i}.npy")
        assert got.shape == want.shape and got.shape[1] == OUT
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("argv", [["--batch"], ["--batch", "x"],
                                  ["--batch", "0"], ["--ar_scan"],
                                  ["--device"]])
def test_predict_ema_rejects_malformed_flags(argv):
    with pytest.raises(SystemExit, match="predict_ema"):
        predict_ema.main(["exp", "wavs", "out", *argv])


def test_predict_ema_hubert_raises(monkeypatch):
    """HuBERT ('_h2') inversion runs since the zoo's rest
    (tests/test_torch_port_ssl.py); without the transformers package it
    raises and says so, never switching to MFCCs."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setattr(predict_ema, "_HUBERT", None)
    with pytest.raises(ImportError, match="transformers"):
        predict_ema.hubert_features(np.zeros(16000, np.float32), 4)


def test_wav_scp_pipes_and_segments_match_jax(tmp_path):
    """wav.scp paths, piped commands and kaldi segments read as the JAX
    package's ``AudioSCPDataset`` reads them."""
    from articulatory_tpu.data.datasets import AudioSCPDataset as JaxAudio
    from articulatory_tpu_torch.data.datasets import AudioSCPDataset

    wav_dir, _ = _wav_corpus(tmp_path, [16000, 8000])
    scp = tmp_path / "piped.scp"
    scp.write_text(f"rec0 {wav_dir / 'utt0.wav'}\n"
                   f"rec1 cat {wav_dir / 'utt1.wav'} |\n")
    segments = tmp_path / "segments"
    segments.write_text("a rec0 0.0 0.5\nb rec0 0.25 1.0\nc rec1 0.1 0.4\n")
    for kwargs in ({}, {"segments": str(segments)}):
        ours = AudioSCPDataset(str(scp), return_utt_id=True, **kwargs)
        ref = JaxAudio(str(scp), return_utt_id=True, **kwargs)
        assert len(ours) == len(ref) == (3 if kwargs else 2)
        for i in range(len(ref)):
            (u, a, sr), (ru, ra, rsr) = ours[i], ref[i]
            assert (u, sr) == (ru, rsr)
            np.testing.assert_array_equal(a, ra)
    only = AudioSCPDataset(str(scp), return_sampling_rate=False)
    assert only[1].shape == (8000,)
