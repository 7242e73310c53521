"""The port's packages export every public name of the JAX package's
``layers``, ``data``, ``ops`` and ``models`` packages, and the tensor
log-mel and framing (``ops/stft.py``) agree with JAX's in float32 and
float64 (to 1e-5 and 1e-12 of max |y|; JAX's float64 under
``jax.enable_x64``). ``AudioDataset`` and ``MelDataset`` read what JAX's
read."""

import importlib
import inspect
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

PACKAGES = ("layers", "data", "ops", "models")


def _public(package: str) -> list[str]:
    module = importlib.import_module(f"articulatory_tpu.{package}")
    return sorted(name for name, value in vars(module).items()
                  if not name.startswith("_")
                  and not isinstance(value, types.ModuleType)
                  and getattr(value, "__module__", module.__name__) != "typing")


@pytest.mark.parametrize("package,name", [
    (package, name) for package in PACKAGES for name in _public(package)])
def test_jax_public_name_resolves_in_the_port(package, name):
    theirs = getattr(importlib.import_module(f"articulatory_tpu.{package}"),
                     name)
    ours = getattr(importlib.import_module(
        f"articulatory_tpu_torch.{package}"), name)
    assert not isinstance(ours, types.ModuleType)
    if inspect.isclass(theirs):
        assert inspect.isclass(ours)
    elif callable(theirs):
        assert callable(ours)
    else:
        assert ours == theirs


def test_lazy_packages_list_their_names():
    for package in PACKAGES[:3]:
        port = importlib.import_module(f"articulatory_tpu_torch.{package}")
        assert set(port.__all__) == set(_public(package))
        with pytest.raises(AttributeError):
            getattr(port, "no_such_name")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_logmelfilterbank_and_frame_signal_match_jax(dtype, tol):
    from articulatory_tpu.ops import frame_signal as jax_frames
    from articulatory_tpu.ops import logmelfilterbank as jax_logmel
    from articulatory_tpu_torch.ops import frame_signal, logmelfilterbank

    x = 0.3 * np.random.default_rng(0).standard_normal((2, 3, 2400))
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    kwargs = dict(fft_size=512, hop_size=80, win_length=400, num_mels=40,
                  fmin=80, fmax=7600)
    with jax.enable_x64(dtype == torch.float64):
        xj = jnp.asarray(x, np_dtype)
        want = {10.0: np.asarray(jax_logmel(xj, 16000, **kwargs)),
                None: np.asarray(jax_logmel(xj, 16000, log_base=None,
                                            **kwargs))}
        want_frames = np.asarray(jax_frames(xj, 400, 160))
    xt = torch.tensor(x, dtype=dtype)
    for log_base, ref in want.items():
        got = logmelfilterbank(xt, 16000, log_base=log_base, **kwargs)
        assert got.dtype == dtype and got.shape == ref.shape == (2, 3, 31, 40)
        err = float(np.abs(got.numpy() - ref).max())
        assert err <= tol * float(np.abs(ref).max()), (log_base, err)
    one = logmelfilterbank(xt[1, 2], 16000, **kwargs)
    assert torch.equal(one, logmelfilterbank(xt, 16000, **kwargs)[1, 2])
    frames = frame_signal(xt, 400, 160)
    assert frames.shape == want_frames.shape == (2, 3, 13, 400)
    np.testing.assert_array_equal(frames.numpy(), want_frames)


def test_audio_and_mel_datasets_match_jax(tmp_path):
    from articulatory_tpu.data import AudioDataset as JaxAudio
    from articulatory_tpu.data import MelDataset as JaxMel
    from articulatory_tpu_torch.data import AudioDataset, MelDataset

    rng = np.random.default_rng(1)
    for i, frames in enumerate([12, 30, 7, 25]):
        np.save(tmp_path / f"u{i}-wave.npy",
                rng.standard_normal(frames * 10).astype(np.float32))
        np.save(tmp_path / f"u{i}-feats.npy",
                rng.standard_normal((frames, 4)).astype(np.float32))
    for ours, theirs, kind, threshold in (
            (AudioDataset, JaxAudio, "audio", 100),
            (MelDataset, JaxMel, "mel", 10)):
        kwargs = {f"{kind}_length_threshold": threshold,
                  "return_utt_id": True}
        a = ours(str(tmp_path), allow_cache=True, **kwargs)
        b = theirs(str(tmp_path), **kwargs)
        assert len(a) == len(b) == 3 and a.utt_ids == b.utt_ids
        for i in range(len(a)):
            assert a[i][0] == b[i][0]
            np.testing.assert_array_equal(a[i][1], b[i][1])
        assert a[0] is a[0]  # cached
