"""The port's scan decode (``ar_loop_scan``, ``ar_loop_batched(scan=True)``),
its float64 ``ar_loop`` and its WSOLA branch against the JAX package's, on
the CPU, where the scan runs the eager per-chunk loop (the CUDA graph's
plain version) with the same chunking, bucketing and trimming; and the
decode CLI's ``--ar-scan`` / ``--ar-scan-bucket``.

End to end is compared over at most 4 chunks at this small width, where the
two f32 decodes stay within rtol 1e-4 / atol 1e-5 (the summation-order
difference of one forward); float64 within 1e-8."""

import functools

import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

import flax.serialization
import jax
import jax.numpy as jnp

from articulatory_tpu import inference as jax_inference
from articulatory_tpu.models import HiFiGANGenerator as JaxGenerator
from articulatory_tpu_torch import inference
from articulatory_tpu_torch.bin import decode as decode_cli

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
F64_TOL = dict(rtol=1e-8, atol=1e-8)
HOP, CHUNK = 80, 10  # batch_max_steps 800: 10-frame chunks


def _gp(ar_input, extra_art=False):
    return dict(in_channels=13 + 8, out_channels=1, channels=16,
                upsample_scales=[5, 4, 2, 2], upsample_kernel_sizes=[10, 8, 4, 4],
                resblock_kernel_sizes=[3], resblock_dilations=[[1, 3]],
                use_ar=True, ar_input=ar_input, ar_hidden=8, ar_output=8,
                extra_art=extra_art)


def _config(ar_input, **gp):
    # ar_input 64 keeps the last-window carry; 2000 > 800 the multi-chunk
    # shift register
    return {"dataset_mode": "a2w", "batch_max_steps": CHUNK * HOP,
            "hop_size": HOP, "sampling_rate": 16000, "format": "npy",
            "generator_type": "HiFiGANGenerator",
            "generator_params": _gp(ar_input, **gp)}


@functools.cache
def _params(ar_input):
    gp = _gp(ar_input)
    model = JaxGenerator(**{k: tuple(map(tuple, v)) if k == "resblock_dilations"
                            else tuple(v) if isinstance(v, list) else v
                            for k, v in gp.items()})
    variables = jax.jit(model.init)(jax.random.PRNGKey(ar_input),
                                    jnp.zeros((1, CHUNK, 13)),
                                    ar=jnp.zeros((1, ar_input, 1)))
    return jax.device_get(variables["params"])


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("scan")
    paths = {}
    for ar_input in (64, 2000):
        paths[ar_input] = str(root / f"ckpt_{ar_input}.pkl")
        with open(paths[ar_input], "wb") as f:
            f.write(flax.serialization.msgpack_serialize(
                {"model": {"generator": _params(ar_input)}, "steps": 1}))
    return paths


@functools.cache
def _jax_model(path, ar_input):
    return jax_inference.load_model(path, _config(ar_input))


def _models(ckpts, ar_input, **gp):
    config = _config(ar_input, **gp)
    return (_jax_model(ckpts[ar_input], ar_input),
            inference.load_model(ckpts[ar_input], config, device="cpu"), config)


def _feats(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((t, 13)).astype(np.float32) for t in lengths]


@pytest.mark.parametrize("ar_input", [64, 2000])
@pytest.mark.parametrize("frames,bucket", [(27, 0), (27, 4), (6, 0)],
                         ids=["ragged", "bucket4", "sub_chunk"])
def test_ar_loop_scan_matches_jax(ckpts, ar_input, frames, bucket):
    jax_model, model, config = _models(ckpts, ar_input)
    (x,) = _feats(frames, [frames])
    ref = np.asarray(jax_inference.ar_loop_scan(jax_model, x, config,
                                                chunk_bucket=bucket))
    out = inference.ar_loop_scan(model, x, config, chunk_bucket=bucket)
    assert out.shape == ref.shape == (frames * HOP,)
    np.testing.assert_allclose(out, ref, **TOL)
    # whole chunks equal the sequential loop's
    n = frames // CHUNK * CHUNK * HOP
    np.testing.assert_allclose(out[:n], inference.ar_loop(model, x, config)[:n],
                               **TOL)


@pytest.mark.parametrize("ar_input", [64, 2000])
def test_ar_loop_batched_scan_matches_jax_and_eager(ckpts, ar_input):
    jax_model, model, config = _models(ckpts, ar_input)
    xs = _feats(2, [30, 20, 27, 6])
    ref = jax_inference.ar_loop_batched(jax_model, xs, config, scan=True)
    outs = inference.ar_loop_batched(model, xs, config, scan=True)
    eager = inference.ar_loop_batched(model, xs, config)
    for x, out, r, e in zip(xs, outs, ref, eager):
        assert out.shape == r.shape == (len(x) * HOP,)
        np.testing.assert_allclose(out, r, **TOL)
        np.testing.assert_array_equal(out, e)


@pytest.mark.parametrize("ar_input", [64, 2000])
def test_ar_loop_float64_matches_jax(ckpts, ar_input):
    """C1: float64 features decode in float64 over four chunks, the last
    ragged, in both carry regimes."""
    jax_model, model, config = _models(ckpts, ar_input)
    model.model.double()
    (x,) = _feats(3, [37])
    x = x.astype(np.float64)
    with jax.enable_x64(True):
        ref = np.asarray(jax_inference.ar_loop(jax_model, x, config))
    out = inference.ar_loop(model, x, config)
    assert out.dtype == ref.dtype == np.float64
    assert out.shape == ref.shape == (37 * HOP,)
    np.testing.assert_allclose(out, ref, **F64_TOL)


@pytest.mark.parametrize("extra_art", [False, True])
def test_wsola_matches_jax(ckpts, extra_art):
    jax_model, model, config = _models(ckpts, 64, extra_art=extra_art)
    (x,) = _feats(4, [27])
    ref_outs, ref_ins = jax_inference.ar_loop(jax_model, x, config,
                                              do_wsola=True)
    outs, ins = inference.ar_loop(model, x, config, do_wsola=True)
    assert len(outs) == len(ref_outs) == 6  # a window every half chunk
    for i, (out, r, cin, rin) in enumerate(zip(outs, ref_outs, ins, ref_ins)):
        np.testing.assert_array_equal(cin, rin)
        assert len(cin) == min(CHUNK + extra_art, 27 - i * CHUNK // 2)
        assert out.shape == np.asarray(r).shape == (len(cin) * HOP,)
        np.testing.assert_allclose(out, np.asarray(r), **TOL)


def test_decode_cli_ar_scan(ckpts, tmp_path):
    """``--ar-scan`` with one stream (``ar_loop_scan``, bucket 0 and 4) and
    with ``--decode-batch-size 2`` (``ar_loop_batched(scan=True)``)."""
    config = _config(64)
    cfg = tmp_path / "config.yml"
    cfg.write_text(yaml.dump(config))
    dump = tmp_path / "dump"
    dump.mkdir()
    xs = _feats(5, [30, 17])
    for name, x in zip(("utt1", "utt2"), xs):
        np.save(dump / f"{name}-feats.npy", x)
    model = inference.load_model(ckpts[64], config, device="cpu")
    for extra in (["--ar-scan-bucket", "0"], ["--ar-scan-bucket", "4"],
                  ["--decode-batch-size", "2"]):
        out = tmp_path / "out"
        decode_cli.main(["--dumpdir", str(dump), "--checkpoint", ckpts[64],
                         "--config", str(cfg), "--outdir", str(out),
                         "--device", "cpu", "--ar-scan", "--verbose", "0",
                         *extra])
        bucket = int(extra[1]) if extra[0] == "--ar-scan-bucket" else 0
        for name, x in zip(("utt1", "utt2"), xs):
            sr, wav = wavfile.read(out / f"{name}_gen.wav")
            assert sr == 16000 and wav.shape == (len(x) * HOP,)
            ref = (np.clip(inference.ar_loop_scan(model, x, config,
                                                  chunk_bucket=bucket),
                           -1, 1) * 32767).astype(np.int16)
            np.testing.assert_allclose(wav, ref, atol=1)
