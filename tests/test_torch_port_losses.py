"""The port's training losses against the JAX package's, on the same
numpy inputs: the mel L1 loss (the e2w config's, fmax 11025 above Nyquist,
natural log), the multi-resolution STFT loss, the adversarial losses (mse
and hinge) and feature matching, in float64 (1e-10, with the mel loss's
gradient) and float32 (1e-5)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulatory_tpu import losses as jl
from articulatory_tpu.ops.mel import mel_filterbank as jax_mel_filterbank
from articulatory_tpu_torch import losses as pl
from articulatory_tpu_torch.ops.mel import mel_filterbank

torch.set_num_threads(1)

MEL = dict(fs=16000, fft_size=1024, hop_size=256, win_length=None,
           window="hann", num_mels=80, fmin=0, fmax=11025, log_base=None)


def _signals(t=4000, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, t)) * 0.3, rng.standard_normal((2, t)) * 0.3


def test_mel_filterbank_is_the_jax_packages():
    np.testing.assert_array_equal(mel_filterbank(16000, 1024, 80, 0, 11025),
                                  jax_mel_filterbank(16000, 1024, 80, 0, 11025))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("name,kwargs", [
    ("mel", MEL), ("mel_log10", dict(MEL, log_base=10.0, fmax=7600)),
    ("stft", {}), ("stft_2res", dict(fft_sizes=(512, 256), hop_sizes=(50, 30),
                                     win_lengths=(240, 120)))])
def test_spectral_losses_match_jax(name, kwargs, dtype, tol):
    y_hat, y = _signals()
    jcls, pcls = ((jl.MelSpectrogramLoss, pl.MelSpectrogramLoss)
                  if name.startswith("mel") else
                  (jl.MultiResolutionSTFTLoss, pl.MultiResolutionSTFTLoss))
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    with jax.enable_x64(dtype == torch.float64):
        want = jcls(**kwargs)(jnp.asarray(y_hat, np_dtype),
                              jnp.asarray(y, np_dtype))
        want = np.asarray(want)
    got = pcls(**kwargs)(torch.tensor(y_hat, dtype=dtype),
                         torch.tensor(y, dtype=dtype))
    if isinstance(got, tuple):
        got = torch.stack(got)
        want = np.stack(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_mel_loss_gradient_matches_jax_f64():
    y_hat, y = _signals(3000, seed=1)
    with jax.enable_x64(True):
        loss = jl.MelSpectrogramLoss(**MEL)
        want = np.asarray(jax.grad(lambda a: loss(a, jnp.asarray(y)))(
            jnp.asarray(y_hat)))
    x = torch.tensor(y_hat, requires_grad=True)
    pl.MelSpectrogramLoss(**MEL)(x, torch.tensor(y)).backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-9, atol=1e-12)


def _disc_outputs(seed):
    """Two discriminators' feature maps, the last of each the logits."""
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal((2, 30, 4)), rng.standard_normal((2, 10, 1))],
            [rng.standard_normal((2, 5, 3, 2)), rng.standard_normal((2, 7)),
             rng.standard_normal((2, 12))]]


def _to(tree, fn):
    return [[fn(a) for a in maps] for maps in tree]


@pytest.mark.parametrize("loss_type", ["mse", "hinge"])
@pytest.mark.parametrize("average", [True, False])
def test_adversarial_losses_match_jax(loss_type, average):
    fake, real = _disc_outputs(0), _disc_outputs(1)
    kwargs = dict(average_by_discriminators=average, loss_type=loss_type)
    with jax.enable_x64(True):
        jfake, jreal = _to(fake, jnp.asarray), _to(real, jnp.asarray)
        want_g = float(jl.GeneratorAdversarialLoss(**kwargs)(jfake))
        want_d = [float(v) for v in
                  jl.DiscriminatorAdversarialLoss(**kwargs)(jfake, jreal)]
    pfake, preal = _to(fake, torch.tensor), _to(real, torch.tensor)
    got_g = float(pl.GeneratorAdversarialLoss(**kwargs)(pfake))
    got_d = [float(v) for v in
             pl.DiscriminatorAdversarialLoss(**kwargs)(pfake, preal)]
    np.testing.assert_allclose([got_g, *got_d], [want_g, *want_d],
                               rtol=1e-12)


@pytest.mark.parametrize("layers,discs,final", [(False, False, False),
                                                (True, True, False),
                                                (True, False, True)])
def test_feature_matching_matches_jax(layers, discs, final):
    fake, real = _disc_outputs(2), _disc_outputs(3)
    kwargs = dict(average_by_layers=layers, average_by_discriminators=discs,
                  include_final_outputs=final)
    with jax.enable_x64(True):
        want = float(jl.FeatureMatchLoss(**kwargs)(_to(fake, jnp.asarray),
                                                   _to(real, jnp.asarray)))
    pfake = _to(fake, lambda a: torch.tensor(a, requires_grad=True))
    preal = _to(real, lambda a: torch.tensor(a, requires_grad=True))
    got = pl.FeatureMatchLoss(**kwargs)(pfake, preal)
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-12)
    got.backward()  # the groundtruth maps are constants
    assert all(a.grad is None for maps in preal for a in maps)
