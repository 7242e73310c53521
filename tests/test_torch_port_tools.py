"""The port's quality tools (``articulatory_tpu_torch/tools/``) against the
JAX package's ``tools/``, on the CPU: ``make_synth_corpus`` writes the same
corpus for a seed (every wav and feature file byte for byte, the same scp
entries) in both profiles, and ``perturb_ckpt`` writes the very msgpack
file the JAX tool writes; on a torch pickle it keeps the format and scales
exactly the generator's floating tensors."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import flax.serialization

from articulatory_tpu_torch.tools import make_synth_corpus, perturb_ckpt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("profile", ["ema", "mri"])
def test_synth_corpus_matches_jax(profile, tmp_path, monkeypatch):
    args = ["--n-utts", "3", "--dev-utts", "1", "--seed", "5",
            "--min-seconds", "0.4", "--max-seconds", "0.7",
            "--profile", profile]
    make_synth_corpus.main(["--root", str(tmp_path / "port"), *args])
    monkeypatch.setattr(sys, "argv", ["make_synth_corpus.py", "--root",
                                      str(tmp_path / "jax"), *args])
    _jax_tool("make_synth_corpus").main()
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax") and len(files) == 3 * 2 + 4
    for f in files:
        got = (tmp_path / "port" / f).read_bytes()
        want = (tmp_path / "jax" / f).read_bytes()
        if f.endswith(".scp"):
            got = got.replace(str(tmp_path / "port").encode(), b"ROOT")
            want = want.replace(str(tmp_path / "jax").encode(), b"ROOT")
        assert got == want, f
    feats = np.load(tmp_path / "port" / "feats" / "synth0000.npy")
    assert feats.shape[1] == (230 if profile == "mri" else 13)


def _tree(rng):
    return {"model": {
                "generator": {"conv": {"w": rng.standard_normal((3, 4, 5)
                                                                ).astype(
                                           np.float32),
                                       "b": rng.standard_normal(5)},
                              "ids": np.arange(4, dtype=np.int32)},
                "discriminator": {"w": np.ones((2, 2), np.float32)}},
            "steps": 9, "epochs": 1, "optimizer": {}, "scheduler": {},
            "mutables": {"generator": {}}}


def test_perturb_msgpack_matches_jax(tmp_path, monkeypatch):
    src = tmp_path / "ckpt.ckpt"
    src.write_bytes(flax.serialization.msgpack_serialize(
        _tree(np.random.default_rng(0))))
    perturb_ckpt.main([str(src), str(tmp_path / "port.ckpt")])
    monkeypatch.setattr(sys, "argv", ["perturb_ckpt.py", str(src),
                                      str(tmp_path / "jax.ckpt")])
    _jax_tool("perturb_ckpt").main()
    got = (tmp_path / "port.ckpt").read_bytes()
    assert got == (tmp_path / "jax.ckpt").read_bytes()
    tree = flax.serialization.msgpack_restore(got)
    w0 = _tree(np.random.default_rng(0))["model"]["generator"]["conv"]["w"]
    w1 = tree["model"]["generator"]["conv"]["w"]
    assert (w1 != w0).any()
    np.testing.assert_array_equal(w1, w0 * np.float32(1 + 2.0 ** -23))


def test_perturb_pickle_keeps_the_format(tmp_path):
    sd = {"conv.weight": torch.randn(4, 3, 5,
                                     generator=torch.Generator().manual_seed(0)),
          "bn.num_batches_tracked": torch.tensor(7)}
    disc = {"w": torch.ones(2)}
    torch.save({"model": {"generator": sd, "discriminator": disc},
                "steps": 3}, tmp_path / "in.pkl")
    perturb_ckpt.main([str(tmp_path / "in.pkl"), str(tmp_path / "out.pkl"),
                       "--scale", str(2.0 ** -20)])
    with open(tmp_path / "out.pkl", "rb") as f:
        assert f.read(2) == b"PK"  # torch's zip format
    out = torch.load(tmp_path / "out.pkl", weights_only=True)
    factor = torch.tensor(1 + 2.0 ** -20, dtype=torch.float32)
    torch.testing.assert_close(out["model"]["generator"]["conv.weight"],
                               sd["conv.weight"] * factor, rtol=0, atol=0)
    assert out["model"]["generator"]["bn.num_batches_tracked"] == 7
    assert torch.equal(out["model"]["discriminator"]["w"], disc["w"])
    assert out["steps"] == 3
