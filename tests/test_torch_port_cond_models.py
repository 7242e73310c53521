"""The conditioning modules of the port against the JAX package's, on the
same weights and inputs: the speaker, phoneme-input and phoneme-head hooks
of ``HiFiGANGenerator`` (both outputs) and the speaker ids of
``GBlockGenerator``, their converters against the JAX exporters key for
key and array for array, the scale-1 upsampling of a cascade's second
stage, linear interpolation (``ops/interp.py``) and the ``linear`` modes it
serves (``UpsampleNetwork``, the TADE layers), and ``ops/audio.py``.

Narrow models (channels 16, two stages, one MRF block of dilations (1, 3),
AR 32 -> 8 -> 8, 3 speakers of embedding 4, 5 phonemes of embedding 3),
initialised in JAX. Outputs agree in float64 under ``jax.enable_x64`` to
1e-8 and in float32 to rtol 1e-4 / atol 1e-5; the hybrid-bf16 generator
to 3e-2 (bf16 rounding points differ, as in
``test_torch_port_generator.py``)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulatory_tpu.layers.tade import TADELayer as JaxTADE
from articulatory_tpu.layers.tade import TADEResBlock as JaxTADEResBlock
from articulatory_tpu.layers.upsample import UpsampleNetwork as JaxUpsample
from articulatory_tpu.models import GBlockGenerator as JaxGBlock
from articulatory_tpu.models import HiFiGANGenerator as JaxHiFiGAN
from articulatory_tpu.ops import audio as jax_audio
from articulatory_tpu.ops import interp as jax_interp
from articulatory_tpu.utils.torch_export import (
    export_gblock_generator,
    export_hifigan_generator,
)
from articulatory_tpu_torch.layers.tade import TADELayer, TADEResBlock
from articulatory_tpu_torch.layers.upsample import UpsampleNetwork
from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.ops import audio, interp
from articulatory_tpu_torch.utils import weights

torch.set_num_threads(1)

TOL = {torch.float64: dict(rtol=1e-8, atol=1e-8),
       torch.float32: dict(rtol=1e-4, atol=1e-5)}
DTYPES = [torch.float64, torch.float32]
# the JAX models' inits compiled at XLA's lowest backend optimisation level:
# random weights either way, in a fraction of the compile time
_init_jit = functools.partial(jax.jit, compiler_options={
    "xla_backend_optimization_level": 0,
    "xla_llvm_disable_expensive_passes": True})
BASE = dict(out_channels=1, channels=16, kernel_size=7,
            upsample_scales=[4, 2], upsample_kernel_sizes=[8, 4],
            resblock_kernel_sizes=[3], resblock_dilations=[[1, 3]])
# (generator params, the forward's inputs): every hook on an AR model; the
# phoneme head alone; a cascade's second stage (12 -> 13 at scale 1)
CASES = {
    "spk_ph_ph_loss": (dict(
        BASE, in_channels=13 + 8, use_ar=True, ar_input=32, ar_hidden=8,
        ar_output=8, use_spk_id=True, num_spk=3, spk_emb_size=4, use_ph=True,
        num_ph=5, ph_emb_size=3, use_ph_loss=True), ("c", "ar", "spk", "ph")),
    "ph_loss": (dict(BASE, in_channels=13, use_ph_loss=True, num_ph=5),
                ("c",)),
    "scale_one": (dict(in_channels=12, out_channels=13, channels=16,
                       upsample_scales=[1], upsample_kernel_sizes=[2],
                       resblock_kernel_sizes=[3, 5],
                       resblock_dilations=[[1], [1, 3]]), ("c12",)),
}


def _np(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def _jax_kwargs(gp):
    return {k: tuple(map(tuple, v)) if k == "resblock_dilations"
            else tuple(v) if isinstance(v, list) else v for k, v in gp.items()}


def _inputs(names):
    rng = np.random.default_rng(0)
    made = {"c": rng.standard_normal((2, 10, 13)),
            "c12": rng.standard_normal((2, 10, 12)),
            "ar": 0.3 * rng.standard_normal((2, 32, 1)),
            "spk": np.array([0, 2], np.int32),
            "ph": rng.integers(0, 5, (2, 10)).astype(np.int32)}
    return [made[n] for n in names]


_KW = {"c": None, "c12": None, "ar": "ar", "spk": "spk_id", "ph": "ph"}


def _split(names, arrays, as_x):
    """Positional features and the keyword inputs (ids stay integers)."""
    args, kwargs = [], {}
    for name, a in zip(names, arrays):
        v = as_x(a) if a.dtype.kind == "f" else a
        if _KW[name] is None:
            args.append(v)
        else:
            kwargs[_KW[name]] = v
    return args, kwargs


@functools.cache
def _jax_model(case):
    gp, names = CASES[case]
    model = JaxHiFiGAN(**_jax_kwargs(gp))
    args, kwargs = _split(names, _inputs(names),
                          lambda a: jnp.asarray(a, jnp.float32))
    kwargs = {k: jnp.asarray(v) for k, v in kwargs.items()}
    params = _init_jit(model.init)(jax.random.PRNGKey(0), *args,
                                   **kwargs)["params"]
    return model, jax.device_get(params)


def _run_jax(model, params, names, dtype):
    np_dtype = _np(dtype)
    with jax.enable_x64(dtype == torch.float64):
        p = jax.tree.map(lambda a: jnp.asarray(a, np_dtype), params)
        args, kwargs = _split(names, _inputs(names),
                              lambda a: jnp.asarray(a, np_dtype))
        kwargs = {k: jnp.asarray(v) for k, v in kwargs.items()}
        out = jax.jit(model.apply)({"params": p}, *args, **kwargs)
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else
                                    (out,))]


def _run_port(port, names, dtype):
    args, kwargs = _split(names, _inputs(names),
                          lambda a: torch.tensor(a, dtype=dtype))
    kwargs = {k: torch.as_tensor(v) for k, v in kwargs.items()}
    with torch.no_grad():
        out = port(*args, **kwargs)
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


def _assert_same(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value),
                                      err_msg=key)


@pytest.mark.parametrize("case", sorted(CASES))
def test_hifigan_converter_matches_exporter(case):
    gp = CASES[case][0]
    _, params = _jax_model(case)
    _assert_same(weights.jax_params_to_state_dict(params, gp),
                 export_hifigan_generator(params, gp))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_hifigan_conditioning_matches_jax(case, dtype):
    """Both outputs (the wave and, with the phoneme head, its logits at the
    frame rate)."""
    gp, names = CASES[case]
    model, params = _jax_model(case)
    want = _run_jax(model, params, names, dtype)
    cast = jax.tree.map(lambda a: np.asarray(a, _np(dtype)), params)
    port = build_model("HiFiGANGenerator", gp).to(dtype)
    port.load_state_dict(weights.jax_params_to_state_dict(cast, gp))
    got = _run_port(port, names, dtype)
    assert len(got) == len(want) == (2 if gp.get("use_ph_loss") else 1)
    if gp.get("use_ph_loss"):
        assert got[1].shape == (2, 10, gp["num_ph"])
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, **TOL[dtype])


def test_hifigan_conditioning_hybrid_bf16_matches_jax():
    """Hybrid bf16: the conditioning and the phoneme head stay f32; both
    outputs f32, within the bf16 generator test's 3e-2."""
    gp, names = CASES["spk_ph_ph_loss"]
    gp = dict(gp, compute_dtype="bfloat16", hybrid_precision=True)
    model, params = _jax_model("spk_ph_ph_loss")
    hybrid = JaxHiFiGAN(**_jax_kwargs(dict(gp, compute_dtype=jnp.bfloat16)))
    want = _run_jax(hybrid, params, names, torch.float32)
    port = build_model("HiFiGANGenerator", gp)
    port.load_state_dict(weights.jax_params_to_state_dict(params, gp))
    got = _run_port(port, names, torch.float32)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=3e-2)


def test_conditioning_needs_its_sizes():
    with pytest.raises(ValueError, match="num_spk"):
        build_model("HiFiGANGenerator", dict(BASE, use_spk_id=True))
    with pytest.raises(ValueError, match="num_ph"):
        build_model("HiFiGANGenerator", dict(BASE, use_ph_loss=True))
    with pytest.raises(ValueError, match="even"):
        build_model("HiFiGANGenerator", dict(
            BASE, upsample_scales=[5], upsample_kernel_sizes=[10],
            use_ph_loss=True, num_ph=4))


GBLOCK = dict(in_channels=13, channels=16, g_scales=[4, 2],
              g_kernel_sizes=[9, 5], use_spk_id=True, num_spk=3,
              spk_emb_size=4)


@functools.cache
def _gblock():
    model = JaxGBlock(**_jax_kwargs(GBLOCK))
    c, spk = _inputs(("c", "spk"))
    return model, jax.device_get(_init_jit(model.init)(
        jax.random.PRNGKey(1), jnp.asarray(c, jnp.float32),
        jnp.asarray(spk))["params"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_gblock_speaker_ids_match_jax(dtype):
    model, params = _gblock()
    c, spk = _inputs(("c", "spk"))
    sd = weights.jax_gblock_generator_to_state_dict(params, GBLOCK)
    _assert_same(sd, export_gblock_generator(params, GBLOCK))
    np_dtype = _np(dtype)
    with jax.enable_x64(dtype == torch.float64):
        p = jax.tree.map(lambda a: jnp.asarray(a, np_dtype), params)
        want = np.asarray(jax.jit(model.apply)(
            {"params": p}, jnp.asarray(c, np_dtype), jnp.asarray(spk)))
    port = build_model("GBlockGenerator", GBLOCK).to(dtype)
    port.load_state_dict(weights.jax_gblock_generator_to_state_dict(
        jax.tree.map(lambda a: np.asarray(a, np_dtype), params), GBLOCK))
    with torch.no_grad():
        got = port(torch.tensor(c, dtype=dtype), spk_id=torch.tensor(spk))
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("t_in,size", [(10, 800), (7, 3), (13, 13),
                                       (100, 240), (1, 5), (33, 97)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_interpolate_linear_matches_jax(t_in, size, dtype):
    """Positions and weights in float32 for either dtype, each position
    rounded once, as the JAX package's jitted programs compute them."""
    x = np.random.default_rng(t_in).standard_normal((2, t_in, 3))
    np_dtype = _np(dtype)
    with jax.enable_x64(dtype == torch.float64):
        want = np.asarray(jax.jit(jax_interp.interpolate_linear,
                                  static_argnums=1)(
            jnp.asarray(x, np_dtype), size))
        want_scale = np.asarray(jax.jit(jax_interp.interpolate_linear_scale,
                                        static_argnums=1)(
            jnp.asarray(x, np_dtype), size / t_in))
    got = interp.interpolate_linear(torch.tensor(x, dtype=dtype), size)
    got_scale = interp.interpolate_linear_scale(torch.tensor(x, dtype=dtype),
                                                size / t_in)
    for g, w in ((got, want), (got_scale, want_scale)):
        assert g.shape == w.shape and g.numpy().dtype == w.dtype
        np.testing.assert_allclose(g.numpy(), w, **TOL[dtype])


def _tade_sd(p, block: bool) -> dict:
    """The port's keys of a JAX TADE layer's or residual block's convs."""
    sd = {}
    for prefix, layer in ((("tade1.", p["tade1"]), ("tade2.", p["tade2"]))
                          if block else (("", p),)):
        for conv in ("aux_conv", "gated_conv"):
            weights._conv1d(sd, f"{prefix}{conv}.0", layer[conv])
    if block:
        for conv in ("gated_conv1", "gated_conv2"):
            weights._conv1d(sd, conv, p[conv])
    return sd


@functools.cache
def _linear_modes():
    """The inputs, and each JAX module with its params: the PWG upsampling,
    the TADE layer and residual block."""
    rng = np.random.default_rng(3)
    c = rng.standard_normal((2, 7, 5))
    x, aux = rng.standard_normal((2, 6, 4)), rng.standard_normal((2, 6, 3))
    net = JaxUpsample(upsample_scales=(3, 2), interpolate_mode="linear")
    tade = JaxTADE(in_channels=4, aux_channels=3, kernel_size=3,
                   upsample_factor=2, upsample_mode="linear")
    block = JaxTADEResBlock(in_channels=4, aux_channels=3, kernel_size=3,
                            upsample_factor=2, upsample_mode="linear")
    mods = [(net, jax.device_get(_init_jit(net.init)(
        jax.random.PRNGKey(0), jnp.asarray(c, jnp.float32))["params"]))]
    for mod in (tade, block):
        mods.append((mod, jax.device_get(_init_jit(mod.init)(
            jax.random.PRNGKey(4), jnp.asarray(x, jnp.float32),
            jnp.asarray(aux, jnp.float32))["params"])))
    return (c, x, aux), mods


@pytest.mark.parametrize("dtype", DTYPES)
def test_linear_modes_match_jax(dtype):
    """``interpolate_mode: linear`` of the PWG upsampling and
    ``upsample_mode: linear`` of the TADE layer and residual block."""
    np_dtype = _np(dtype)
    (c, x, aux), [(net, params), *tades] = _linear_modes()
    sd = {f"up_layers.{1 + 2 * i}.weight": torch.tensor(np.transpose(
        np.asarray(params[f"conv_{i}_w"], np_dtype), (3, 2, 0, 1)))
        for i in range(2)}
    port = UpsampleNetwork((3, 2), interpolate_mode="linear").to(dtype)
    port.load_state_dict(sd)
    runs = [(net, params, port, (c,))]
    for (jax_mod, p), port_mod, is_block in zip(tades, (
            TADELayer(4, 3, 3, upsample_factor=2, upsample_mode="linear"),
            TADEResBlock(4, 3, 3, upsample_factor=2,
                         upsample_mode="linear")), (False, True)):
        cast = jax.tree.map(lambda a: np.asarray(a, np_dtype), p)
        port_mod.to(dtype).load_state_dict(_tade_sd(cast, is_block))
        runs.append((jax_mod, p, port_mod, (x, aux)))
    for jax_mod, p, port_mod, inputs in runs:
        with jax.enable_x64(dtype == torch.float64):
            q = jax.tree.map(lambda a: jnp.asarray(a, np_dtype), p)
            want = jax.jit(jax_mod.apply)(
                {"params": q}, *[jnp.asarray(a, np_dtype) for a in inputs])
        with torch.no_grad():
            got = port_mod(*[torch.tensor(a, dtype=dtype) for a in inputs])
        got = [got] if torch.is_tensor(got) else list(got)
        want = [np.asarray(w) for w in jax.tree.leaves(want)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, **TOL[dtype])


def test_audio_ops_match_jax():
    rng = np.random.default_rng(5)
    wave = np.concatenate([1e-5 * rng.standard_normal(3000),
                           rng.standard_normal(8000),
                           1e-5 * rng.standard_normal(2500)]
                          ).astype(np.float32)
    for kwargs in ({}, {"top_db": 30, "frame_length": 512,
                        "hop_length": 128}):
        got, span = audio.trim_silence(wave, **kwargs)
        want, want_span = jax_audio.trim_silence(wave, **kwargs)
        assert span == want_span and 0 < span[0] < span[1] < len(wave)
        np.testing.assert_array_equal(got, want)
    assert audio.trim_silence(np.zeros(100, np.float32))[1] == \
        jax_audio.trim_silence(np.zeros(100, np.float32))[1]
    for orig, target in ((20000, 16000), (16000, 22050), (8000, 8000)):
        np.testing.assert_allclose(audio.resample(wave, orig, target),
                                   jax_audio.resample(wave, orig, target),
                                   rtol=1e-8, atol=1e-8)
