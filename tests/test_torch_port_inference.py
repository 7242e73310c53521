"""The port's load_model / ar_loop / ar_loop_batched / decode against the JAX
package on the same weights, on the CPU.

The chunked-AR loop is chaotic (a 1-ulp change moves an f32 decode by
2.93 dB MCD at full width), so the gate is per chunk with the carry shared:
both sides get the same previous output. End to end is compared over at most
3 chunks at this small width, where the two f32 decodes stay within
rtol 1e-4 / atol 1e-5 (the summation-order difference of one forward)."""

import functools
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import flax.serialization
import jax
import jax.numpy as jnp

from articulatory_tpu.inference import ar_loop as jax_ar_loop
from articulatory_tpu.inference import ar_loop_batched as jax_ar_loop_batched
from articulatory_tpu.models import HiFiGANGenerator as JaxGenerator
from articulatory_tpu_torch.bin import decode as decode_cli
from articulatory_tpu_torch.inference import ar_loop, ar_loop_batched, load_model
from articulatory_tpu_torch.utils.checkpoint import load_checkpoint
from articulatory_tpu_torch.utils.weights import jax_params_to_state_dict

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)


def _gp(ar_input):
    return dict(in_channels=13 + 8, out_channels=1, channels=16,
                upsample_scales=[5, 4, 2, 2], upsample_kernel_sizes=[10, 8, 4, 4],
                resblock_kernel_sizes=[3], resblock_dilations=[[1, 3]],
                use_ar=True, ar_input=ar_input, ar_hidden=8, ar_output=8)


def _config(ar_input):
    # batch_max_steps 800 / hop 80: 10-frame chunks; ar_input 64 keeps the
    # last-window carry, 2000 > 800 the multi-chunk shift register
    return {"dataset_mode": "a2w", "batch_max_steps": 800, "hop_size": 80,
            "sampling_rate": 16000, "format": "npy",
            "generator_type": "HiFiGANGenerator",
            "generator_params": _gp(ar_input)}


class _JaxShim:
    """The JAX package's LoadedModel interface over a jitted apply."""

    def __init__(self, model, params):
        self.params = params
        self._fwd = jax.jit(lambda p, c, ar: model.apply({"params": p}, c,
                                                         ar=ar))

    def __call__(self, c, ar=None):
        return self._fwd(self.params, c, ar)


@functools.cache
def _jax(ar_input):
    gp = _gp(ar_input)
    model = JaxGenerator(**{k: tuple(map(tuple, v)) if k == "resblock_dilations"
                            else tuple(v) if isinstance(v, list) else v
                            for k, v in gp.items()})
    variables = jax.jit(model.init)(jax.random.PRNGKey(ar_input),
                                    jnp.zeros((1, 10, 13)),
                                    ar=jnp.zeros((1, ar_input, 1)))
    return _JaxShim(model, jax.device_get(variables["params"]))


def _save_msgpack(path, params):
    with open(path, "wb") as f:  # the JAX package's checkpoint format
        f.write(flax.serialization.msgpack_serialize(
            {"model": {"generator": params}, "steps": 3}))


@functools.cache
def _checkpoint(tmp_root, ar_input):
    path = os.path.join(tmp_root, f"ckpt_{ar_input}.pkl")
    _save_msgpack(path, _jax(ar_input).params)
    return path


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ckpt"))


def _feats(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((t, 13)).astype(np.float32) for t in lengths]


@pytest.mark.parametrize("ar_input", [64, 2000])
def test_chunks_match_jax_with_shared_carry(ckpt_dir, ar_input):
    shim = _jax(ar_input)
    model = load_model(_checkpoint(ckpt_dir, ar_input), _config(ar_input),
                       device="cpu")
    (x,) = _feats(ar_input, [40])
    prev = jnp.zeros((2, ar_input, 1))
    for i in range(4):
        cin = np.stack([x[i * 10:(i + 1) * 10], x[::-1][i * 10:(i + 1) * 10]])
        ref = np.asarray(shim(jnp.asarray(cin), ar=prev))
        out = model(cin, ar=np.array(prev)).numpy()
        np.testing.assert_allclose(out, ref, **TOL, err_msg=f"chunk {i}")
        prev = (jnp.asarray(ref)[:, -ar_input:] if ar_input <= 800 else
                jnp.concatenate([prev[:, ref.shape[1]:], jnp.asarray(ref)], 1))


@pytest.mark.parametrize("ar_input", [64, 2000])
def test_ar_loop_matches_jax(ckpt_dir, ar_input):
    model = load_model(_checkpoint(ckpt_dir, ar_input), _config(ar_input),
                       device="cpu")
    (x,) = _feats(1, [27])  # 3 chunks, the last one short
    ref = np.asarray(jax_ar_loop(_jax(ar_input), x, _config(ar_input)))
    out = ar_loop(model, x, _config(ar_input))
    assert out.shape == ref.shape == (27 * 80,)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("ar_input", [64, 2000])
def test_ar_loop_batched_matches_jax_and_sequential(ckpt_dir, ar_input):
    model = load_model(_checkpoint(ckpt_dir, ar_input), _config(ar_input),
                       device="cpu")
    xs = _feats(2, [30, 20, 27])
    ref = jax_ar_loop_batched(_jax(ar_input), xs, _config(ar_input))
    outs = ar_loop_batched(model, xs, _config(ar_input))
    for x, out, r in zip(xs, outs, ref):
        assert out.shape == r.shape == (len(x) * 80,)
        np.testing.assert_allclose(out, r, **TOL)
        seq = ar_loop(model, x, _config(ar_input))
        n_full = (len(x) // 10) * 800
        np.testing.assert_allclose(out[:n_full], seq[:n_full], **TOL)


def test_batched_all_empty_inputs(ckpt_dir):
    model = load_model(_checkpoint(ckpt_dir, 64), _config(64), device="cpu")
    outs = ar_loop_batched(model, [np.zeros((0, 13), np.float32)] * 2,
                           _config(64))
    assert [o.shape for o in outs] == [(0,), (0,)]


def test_torch_pickle_loads_like_msgpack(ckpt_dir, tmp_path):
    """A reference-style torch pickle with the same weights gives the same
    model as the JAX package's msgpack checkpoint."""
    gp = _gp(64)
    path = str(tmp_path / "ref.pth")
    torch.save({"model": {"generator": jax_params_to_state_dict(
        _jax(64).params, gp)}}, path)
    a = load_model(path, _config(64), device="cpu")
    b = load_model(_checkpoint(ckpt_dir, 64), _config(64), device="cpu")
    for (ka, va), (kb, vb) in zip(sorted(a.model.state_dict().items()),
                                  sorted(b.model.state_dict().items())):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)


def test_msgpack_reader_matches_flax(tmp_path, monkeypatch):
    """Arrays of several dtypes (bfloat16 included), numpy scalars, nested
    dicts, and arrays flax splits into chunks."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(0)
    tree = {"model": {"generator": {
        "a": rng.standard_normal((3, 40)).astype(np.float32),
        "b": np.arange(7, dtype=np.int32),
        "c": jnp.asarray(rng.standard_normal((5,)), jnp.bfloat16)}},
        "steps": np.int64(12), "epochs": 2, "name": "x"}
    path = str(tmp_path / "ckpt.pkl")
    with open(path, "wb") as f:
        f.write(flax.serialization.msgpack_serialize(tree))
    ours = load_checkpoint(path)
    ref = flax.serialization.msgpack_restore(open(path, "rb").read())
    gen = ours["model"]["generator"]
    np.testing.assert_array_equal(gen["a"], ref["model"]["generator"]["a"])
    np.testing.assert_array_equal(gen["b"], ref["model"]["generator"]["b"])
    np.testing.assert_array_equal(
        gen["c"], np.asarray(ref["model"]["generator"]["c"], np.float32))
    assert ours["steps"] == 12 and ours["epochs"] == 2 and ours["name"] == "x"


def test_decode_cli_writes_wavs(ckpt_dir, tmp_path):
    import yaml

    config = _config(64)
    cfg_path = tmp_path / "config.yml"
    cfg_path.write_text(yaml.dump(config))
    dump = tmp_path / "dump"
    dump.mkdir()
    xs = _feats(5, [30, 17])
    for name, x in zip(("utt1", "utt2"), xs):
        np.save(dump / f"{name}-feats.npy", x)
    for batch in ("1", "2"):
        out = tmp_path / f"out{batch}"
        decode_cli.main(["--dumpdir", str(dump), "--checkpoint",
                         _checkpoint(ckpt_dir, 64), "--config", str(cfg_path),
                         "--outdir", str(out), "--device", "cpu",
                         "--decode-batch-size", batch, "--verbose", "0"])
        model = load_model(_checkpoint(ckpt_dir, 64), config, device="cpu")
        for name, x in zip(("utt1", "utt2"), xs):
            sr, wav = wavfile.read(out / f"{name}_gen.wav")
            assert sr == 16000 and wav.dtype == np.int16
            assert wav.shape == (len(x) * 80,)
            ref = (np.clip(ar_loop(model, x, config), -1, 1) * 32767
                   ).astype(np.int16)
            # batched lanes zero-pad a short last chunk, which the tiled AR
            # features see: compare its complete chunks only
            n = len(wav) if batch == "1" else (len(x) // 10) * 800
            np.testing.assert_allclose(wav[:n], ref[:n], atol=1)


@pytest.mark.parametrize("flag", [["--int8-weights"], ["--bf16-weights"],
                                  ["--ar-scan"], ["--sequence-parallel", "2"]])
def test_decode_cli_unported_flags_raise(flag, tmp_path):
    with pytest.raises(SystemExit):
        decode_cli.main(["--dumpdir", str(tmp_path), "--checkpoint", "x",
                         "--outdir", str(tmp_path), *flag])


def test_unported_decode_modes_raise(ckpt_dir):
    model = load_model(_checkpoint(ckpt_dir, 64), _config(64), device="cpu")
    x = np.zeros((10, 13), np.float32)
    with pytest.raises(NotImplementedError):
        ar_loop(model, x, _config(64), do_wsola=True)
    with pytest.raises(NotImplementedError):
        ar_loop(model, x, dict(_config(64), dataset_mode="w2a"))
    with pytest.raises(NotImplementedError):
        ar_loop_batched(model, [x], _config(64), scan=True)
