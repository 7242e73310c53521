"""The port's ``StreamingSynthesizer`` and ``StreamingServer`` against the
JAX package's on the CPU (where each chunk step runs eagerly, the captured
step's plain version), in both directions: the cases of
``tests/test_streaming.py`` (chunked streams against ``ar_loop``, the shift
register, ``synthesize_all``, pipeline depths, server churn against solo
serves, stalls, partial tails, 1-D chunks), each also held against JAX's
classes on the same weights (rtol 1e-4 / atol 1e-5); and the two repairs:
a NaN left in a lane does not reach its next client, and a chunk after a
short (final) chunk raises."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulatory_tpu import inference as jax_inference
from articulatory_tpu import streaming as jax_streaming
from articulatory_tpu.models import BiGRU as JaxBiGRU
from articulatory_tpu.models import HiFiGANGenerator as JaxGenerator
from articulatory_tpu_torch import inference
from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.streaming import StreamingServer, StreamingSynthesizer
from articulatory_tpu_torch.utils.weights import (
    jax_bigru_to_state_dict,
    jax_params_to_state_dict,
)

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)


@functools.cache
def _a2w(ar_input=64):
    """(JAX LoadedModel, port LoadedModel, config): a narrow HiFi-CAR
    generator, 10-frame chunks of 800 samples."""
    gp = dict(in_channels=13 + 8, channels=16, upsample_scales=(5, 4, 2, 2),
              upsample_kernel_sizes=(10, 8, 4, 4), resblock_kernel_sizes=(3,),
              resblock_dilations=((1, 3),), use_ar=True, ar_input=ar_input,
              ar_hidden=8, ar_output=8)
    config = {"dataset_mode": "a2w", "batch_max_steps": 800, "hop_size": 80,
              "generator_params": dict(gp, out_channels=1)}
    jmodel = JaxGenerator(**gp)
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 10, 13)),
        ar=jnp.zeros((1, ar_input, 1)))["params"])
    port = build_model("HiFiGANGenerator", gp)
    port.load_state_dict(jax_params_to_state_dict(params, gp))
    return (jax_inference.LoadedModel(model=jmodel, params=params,
                                      config=config, mutables={}),
            inference.LoadedModel(model=port.eval(), config=config,
                                  device=torch.device("cpu")), config)


@functools.cache
def _w2a(out_ch=4, ar_input=16, feats=5):
    """The same for a narrow AR BiGRU, 100-row chunks, hop 80."""
    gp = dict(in_channels=feats + 8, hidden_size=8, out_channels=out_ch,
              use_ar=True, ar_input=ar_input, ar_hidden=8, ar_output=8)
    config = {"dataset_mode": "w2a", "batch_max_steps": 100, "hop_size": 80,
              "generator_params": gp}
    jmodel = JaxBiGRU(**gp)
    v = jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 20, feats)),
        ar=jnp.zeros((1, ar_input // out_ch, out_ch))))
    mutables = {k: x for k, x in v.items() if k != "params"}
    port = build_model("BiGRU", gp)
    port.load_state_dict(jax_bigru_to_state_dict(v["params"], mutables, gp))
    return (jax_inference.LoadedModel(model=jmodel, params=v["params"],
                                      config=config, mutables=mutables),
            inference.LoadedModel(model=port.eval(), config=config,
                                  device=torch.device("cpu")), config)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _stream(cls, model, config, x, **kwargs):
    return np.concatenate(list(cls(model, config).synthesize(x, **kwargs)))


@pytest.mark.parametrize("ar_input", [64, 2000], ids=["window", "register"])
def test_streaming_matches_ar_loop_and_jax(ar_input):
    jmodel, model, config = _a2w(ar_input)
    x = _x(0, (30 if ar_input == 64 else 50, 13))  # 3 or 5 whole chunks
    stream = StreamingSynthesizer(model, config)
    assert stream.shift_register == (ar_input == 2000)
    streamed = np.concatenate(list(stream.synthesize(x)))[:, 0]
    np.testing.assert_allclose(streamed, inference.ar_loop(model, x, config),
                               **TOL)
    np.testing.assert_allclose(
        streamed, _stream(jax_streaming.StreamingSynthesizer, jmodel, config,
                          x)[:, 0], **TOL)
    stream.reset()  # a fresh stream, identical to the first
    np.testing.assert_array_equal(
        np.concatenate(list(stream.synthesize(x)))[:, 0], streamed)


def test_synthesize_all_matches_chunked_and_jax():
    jmodel, model, config = _a2w()
    x = _x(1, (27, 13))  # a ragged tail
    stream = StreamingSynthesizer(model, config)
    chunked = np.concatenate(list(stream.synthesize(x)))[:, 0]
    stream.reset()
    whole = stream.synthesize_all(x)
    assert whole.shape == chunked.shape == (27 * 80,)
    np.testing.assert_allclose(whole, chunked, **TOL)
    np.testing.assert_allclose(whole, np.asarray(
        jax_streaming.StreamingSynthesizer(jmodel, config).synthesize_all(x)),
        **TOL)


def test_pipeline_depths_identical():
    _, model, config = _a2w()
    x = _x(2, (30, 13))
    outs = [_stream(StreamingSynthesizer, model, config, x,
                    pipeline_depth=d) for d in (1, 2, 4)]
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])


@pytest.mark.parametrize("t,ref_len,full", [(300, 300, 300), (290, 290, 200),
                                            (250, 200, 200)])
def test_streaming_w2a_matches_ar_loop_and_jax(t, ref_len, full):
    """A >= hop remainder is kept (zero-padded through the step, so only the
    whole-chunk prefix equals the host loop's short chunk), a sub-hop one
    dropped; the whole stream equals JAX's streaming."""
    jmodel, model, config = _w2a()
    x = _x(t, (t, 5))
    offline = inference.ar_loop(model, x, config)
    assert offline.shape == (ref_len, 4)
    streamed = _stream(StreamingSynthesizer, model, config, x)
    assert streamed.shape == offline.shape
    np.testing.assert_allclose(streamed[:full], offline[:full], **TOL)
    np.testing.assert_allclose(streamed, _stream(
        jax_streaming.StreamingSynthesizer, jmodel, config, x), **TOL)
    # synthesize_all: whole chunks scanned, the tail exact (= ar_loop)
    whole = StreamingSynthesizer(model, config).synthesize_all(x)
    np.testing.assert_allclose(whole, offline, **TOL)
    np.testing.assert_allclose(whole, np.asarray(
        jax_streaming.StreamingSynthesizer(jmodel, config).synthesize_all(x)),
        **TOL)


def test_streaming_w2a_shift_register_matches_ar_loop():
    jmodel, model, config = _w2a(out_ch=2, ar_input=300)  # 150 > 100 rows
    x = _x(3, (500, 5))
    stream = StreamingSynthesizer(model, config)
    assert stream.shift_register
    streamed = np.concatenate(list(stream.synthesize(x)))
    np.testing.assert_allclose(streamed, inference.ar_loop(model, x, config),
                               **TOL)
    np.testing.assert_allclose(streamed, _stream(
        jax_streaming.StreamingSynthesizer, jmodel, config, x), **TOL)


def _serve(server_cls, model, config, lanes, plan, joins, leaves):
    """Run ``plan`` (a list of {client: chunk} rounds) with joins and leaves
    before the rounds named; returns each client's outputs concatenated."""
    server = server_cls(model, config, max_lanes=lanes)
    got = {}
    for rnd, subs in enumerate(plan):
        for cid in leaves.get(rnd, ()):
            server.leave(cid)
        for cid in joins.get(rnd, ()):
            server.join(cid)
        for cid, y in server.step(subs).items():
            got.setdefault(cid, []).append(y)
    return {cid: np.concatenate(ys) for cid, ys in got.items()}


def _solo(model, config, lanes, x, chunk):
    server = StreamingServer(model, config, max_lanes=lanes)
    server.join("s")
    return np.concatenate([server.step({"s": x[i:i + chunk]})["s"]
                           for i in range(0, len(x), chunk)])


def test_server_churn_bit_identical_to_solo_and_jax():
    """a joins, b joins in round 2 and stalls in round 4, a leaves after 6
    chunks and c takes its lane: each stream equals its solo serve bit for
    bit, JAX's server within tolerance and ar_loop within tolerance."""
    jmodel, model, config = _a2w()
    streams = {c: _x(i, (n * 10, 13))
               for i, (c, n) in enumerate((("a", 6), ("b", 4), ("c", 2)))}
    chunk = lambda c, i: streams[c][i * 10:(i + 1) * 10]
    order = [{"a": 0}, {"a": 1}, {"a": 2, "b": 0}, {"a": 3, "b": 1},
             {"a": 4}, {"a": 5, "b": 2}, {"c": 0, "b": 3}, {"c": 1}]
    plan = [{c: chunk(c, i) for c, i in subs.items()} for subs in order]
    joins, leaves = {0: ["a"], 2: ["b"], 6: ["c"]}, {6: ["a"]}
    got = _serve(StreamingServer, model, config, 2, plan, joins, leaves)
    want = _serve(jax_streaming.StreamingServer, jmodel, config, 2, plan,
                  joins, leaves)
    for c, x in streams.items():
        np.testing.assert_array_equal(got[c], _solo(model, config, 2, x, 10))
        np.testing.assert_allclose(got[c], want[c], **TOL)
        np.testing.assert_allclose(got[c][:, 0],
                                   inference.ar_loop(model, x, config), **TOL)


def test_server_partial_tail_and_errors():
    _, model, config = _a2w()
    server = StreamingServer(model, config, max_lanes=2)
    x = _x(4, (17, 13))
    assert server.join("a") == 0
    y0 = server.step({"a": x[:10]})["a"]
    y1 = server.step({"a": x[10:]})["a"]  # a 7-frame tail -> 560 samples
    assert y0.shape == (800, 1) and y1.shape == (560, 1)
    offline = inference.ar_loop(model, x, config)
    np.testing.assert_allclose(np.concatenate([y0, y1])[:800, 0],
                               offline[:800], **TOL)
    with pytest.raises(ValueError):
        server.join("a")  # double join
    with pytest.raises(KeyError):
        server.step({"zz": x[:10]})  # not joined
    with pytest.raises(ValueError):
        server.step({"a": x[:11]})  # longer than a chunk
    server.join("b")
    with pytest.raises(RuntimeError):
        server.join("overflow")  # full
    server.leave("b")
    assert server.join("d") == 1  # the lane is free again
    assert server.active == ["a", "d"]


def test_server_rejects_a_chunk_after_a_short_chunk():
    _, model, config = _a2w()
    server = StreamingServer(model, config, max_lanes=2)
    x = _x(5, (30, 13))
    server.join("a")
    server.join("b")
    server.step({"a": x[:10], "b": x[:4]})  # b's stream ends here
    with pytest.raises(ValueError, match="short"):
        server.step({"a": x[10:20], "b": x[4:14]})
    server.step({"a": x[10:20]})  # the others go on
    server.leave("b")
    server.join("b")  # a new stream may start over
    assert server.step({"b": x[:10]})["b"].shape == (800, 1)


def test_join_zeroes_a_nan_left_in_the_lane():
    """A client whose input put NaN into its carry leaves; the next client
    on that lane gets its solo outputs (a multiply by 0 would keep the
    NaN)."""
    _, model, config = _a2w()
    server = StreamingServer(model, config, max_lanes=2)
    server.join("bad")
    bad = np.full((10, 13), np.nan, np.float32)
    assert np.isnan(server.step({"bad": bad})["bad"]).all()
    assert torch.isnan(server.syn._prev[0]).all()
    server.leave("bad")
    assert server.join("good") == 0
    x = _x(6, (30, 13))
    got = np.concatenate([server.step({"good": x[i:i + 10]})["good"]
                          for i in range(0, 30, 10)])
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, _solo(model, config, 2, x, 10))


def test_server_w2a_churn_matches_solo_and_jax():
    jmodel, model, config = _w2a()
    xa, xb = _x(7, (300, 5)), _x(8, (200, 5))
    plan = [{"a": xa[:100]}, {"a": xa[100:200], "b": xb[:100]},
            {"a": xa[200:], "b": xb[100:]}]
    joins = {0: ["a"], 1: ["b"]}
    got = _serve(StreamingServer, model, config, 3, plan, joins, {})
    want = _serve(jax_streaming.StreamingServer, jmodel, config, 3, plan,
                  joins, {})
    for cid, x in (("a", xa), ("b", xb)):
        np.testing.assert_array_equal(got[cid], _solo(model, config, 3, x,
                                                      100))
        np.testing.assert_allclose(got[cid], want[cid], **TOL)


def test_server_shift_register_churn_matches_solo():
    jmodel, model, config = _a2w(ar_input=2000)
    xa, xb = _x(9, (50, 13)), _x(10, (30, 13))
    plan = [{"a": xa[:10]}] + [
        {"a": xa[i * 10:(i + 1) * 10],
         **({"b": xb[(i - 1) * 10:i * 10]} if i <= 3 else {})}
        for i in range(1, 5)]
    joins = {0: ["a"], 1: ["b"]}
    got = _serve(StreamingServer, model, config, 2, plan, joins, {})
    assert StreamingServer(model, config, max_lanes=2).syn.shift_register
    for cid, x in (("a", xa), ("b", xb)):
        np.testing.assert_array_equal(got[cid], _solo(model, config, 2, x,
                                                      10))
    np.testing.assert_allclose(got["a"][:, 0],
                               inference.ar_loop(model, xa, config), **TOL)
    want = _serve(jax_streaming.StreamingServer, jmodel, config, 2, plan,
                  joins, {})
    np.testing.assert_allclose(got["b"], want["b"], **TOL)


def test_server_1d_chunks_match_2d():
    """Raw 1-D wave chunks into a w2a server are (t, 1) chunks."""
    _, model, config = _w2a(feats=1)
    wav = _x(11, (200,))
    outs = []
    for shape in ((-1,), (-1, 1)):
        server = StreamingServer(model, config, max_lanes=2)
        server.join("a")
        outs.append(np.concatenate([
            server.step({"a": wav[i:i + 100].reshape(shape)})["a"]
            for i in (0, 100)]))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].shape == (200, 4)
