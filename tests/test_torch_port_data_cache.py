"""The training data options against the JAX package's: ``SizeAwareSampler``
packings, ``DataLoader(batch_sampler=...)``, the ``remove_short_samples``
filter, the corpus cache (``data/device_cache.py``, here on the CPU) and
the native loader (``data/native_loader.py``). Batches are compared bit for
bit for the same draws and seeds."""

import os
import subprocess

import numpy as np
import pytest
import torch

from articulatory_tpu.data import native_loader as jax_native
from articulatory_tpu.data.collate import SpeechCollater as JaxCollater
from articulatory_tpu.data.datasets import SpeechDataset as JaxDataset
from articulatory_tpu.data.device_cache import (
    DeviceCachedBatcher as JaxBatcher,
)
from articulatory_tpu.data.loader import DataLoader as JaxLoader
from articulatory_tpu.data.samplers import SizeAwareSampler as JaxSampler
from articulatory_tpu_torch.bin import train as train_cli
from articulatory_tpu_torch.data.collate import CollaterMelArt, SpeechCollater
from articulatory_tpu_torch.data.datasets import SpeechDataset
from articulatory_tpu_torch.data.device_cache import (
    DeviceCachedBatcher,
    canonical_cache_mode,
)
from articulatory_tpu_torch.data.loader import DataLoader
from articulatory_tpu_torch.data.native_loader import NativeDataLoader
from articulatory_tpu_torch.data.samplers import SizeAwareSampler

torch.set_num_threads(1)

HOP = 80
FRAMES = 25  # batch_max_steps 2000 / hop 80


class _ListDataset:
    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class _FixedStarts:
    """A generator stand-in that hands the collater prescribed starts."""

    def __init__(self, starts):
        self.starts = list(starts)

    def integers(self, lo, hi):
        s = int(self.starts.pop(0))
        assert lo <= s < hi
        return s


def _speech_items(seed, n=6, dim=13):
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(n):
        frames = int(rng.integers(30, 80))
        items.append({"audio": rng.standard_normal(frames * HOP).astype(
                          np.float32),
                      "art": rng.standard_normal((frames + 5, dim)).astype(
                          np.float32)})
    return items


def _melart_items(seed, n=5):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((f, 20)).astype(np.float32),
             rng.standard_normal((f, 13)).astype(np.float32))
            for f in rng.integers(30, 80, n)]


def _config(mode, use_ar):
    return {"dataset_mode": mode, "hop_size": HOP,
            "batch_max_steps": FRAMES * HOP,
            "generator_params": {"out_channels": 1 if mode == "a2w" else 13,
                                 "use_ar": use_ar, "ar_input": 512}}


def _numpy(batch):
    return {k: tuple(np.asarray(a) for a in v) if k == "x" else np.asarray(v)
            for k, v in batch.items()}


def _assert_batches_equal(ours, theirs, keys=("x", "y", "ar")):
    ours, theirs = _numpy(ours), _numpy(theirs)
    assert sorted(k for k in ours if k in keys) == sorted(
        k for k in theirs if k in keys)
    for key in keys:
        if key in ours:
            for a, b in zip(*(((d[key],) if key != "x" else d[key])
                              for d in (ours, theirs))):
                assert a.dtype == b.dtype and a.shape == b.shape, key
                np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("mode,use_ar", [("a2w", True), ("a2w", False),
                                         ("w2a", True)])
def test_cache_matches_jax_and_the_collater(mode, use_ar):
    items = _speech_items(0)
    config = _config(mode, use_ar)
    ours = DeviceCachedBatcher(_ListDataset(items), config, batch_size=4,
                               device="cpu")
    theirs = JaxBatcher(_ListDataset(items), config, batch_size=4)
    utts = np.array([0, 2, 5, 2], np.int32)
    starts = np.array([0, 3, 17, 1], np.int32)  # 0: an AR past of zeros
    got = ours.batch_at(utts, starts)
    assert all(t.device.type == "cpu" for t in (got["y"], *got["x"]))
    _assert_batches_equal(got, theirs.batch_at(utts, starts))
    collater = SpeechCollater(batch_max_steps=FRAMES * HOP, hop_size=HOP,
                              dataset_mode=mode, config=config,
                              rng=_FixedStarts(starts))
    _assert_batches_equal(got, collater([items[u] for u in utts]))
    assert ("ar" in got) == use_ar


@pytest.mark.parametrize("mode", ["a2m", "m2a"])
def test_melart_cache_matches_jax_and_the_collater(mode):
    items = _melart_items(1)
    config = dict(_config(mode, False), generator_params={})
    ours = DeviceCachedBatcher(_ListDataset(items), config, batch_size=3,
                               device="cpu")
    theirs = JaxBatcher(_ListDataset(items), config, batch_size=3)
    utts, starts = np.array([4, 0, 2], np.int32), np.array([2, 0, 9],
                                                           np.int32)
    got = ours.batch_at(utts, starts)
    _assert_batches_equal(got, theirs.batch_at(utts, starts))
    collater = CollaterMelArt(batch_max_steps=FRAMES * HOP, hop_size=HOP,
                              aux_context_window=0, dataset_mode=mode,
                              rng=_FixedStarts(starts))
    _assert_batches_equal(got, collater([items[u] for u in utts]))


def test_cache_iterations_match_jax():
    items = _speech_items(2, n=9)
    config = _config("a2w", True)
    ours = DeviceCachedBatcher(_ListDataset(items), config, batch_size=3,
                               seed=5, device="cpu")
    theirs = JaxBatcher(_ListDataset(items), config, batch_size=3, seed=5)
    assert len(ours) == len(theirs) == 3
    assert ours.resident_bytes > 0
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        pairs = list(zip(ours, theirs))
        assert len(pairs) == 3
        for a, b in pairs:
            _assert_batches_equal(a, b)


def test_cache_refuses_what_it_cannot_serve():
    items = _speech_items(3, n=3)
    base = _config("a2w", False)
    for extra, match in (({"generator2_type": "HiFiGANGenerator"},
                          "generator2"), ({"use_pcd": True}, "PCD")):
        with pytest.raises(ValueError, match=match):
            DeviceCachedBatcher(_ListDataset(items), dict(base, **extra),
                                batch_size=2, device="cpu")
    for mode, canon in (("a2w", "a2w"), ("m2a", "m2a"), ("default", "a2w"),
                        ("tracks_npy_minc_punc2wav_adobe_0p9_punc", "a2w"),
                        ("ph2a", None), ("m2w", None), ("a2w_mult", None)):
        assert canonical_cache_mode(mode) == canon


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_size_aware_sampler_matches_jax(seed):
    lens = np.random.default_rng(seed).integers(200, 900, 40)
    ours = SizeAwareSampler(lens, max_len=2000, seed=seed)
    theirs = JaxSampler(lens, max_len=2000, seed=seed)
    for epoch in range(3):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        packing = list(ours)
        assert packing == list(theirs) == list(ours)  # idempotent
        assert all(sum(lens[i] for i in b) <= 2000 for b in packing)


def _dump(root, lengths, dim=13):
    """npy dump ``dump/tr/norm`` and ``data/tr/feats.scp`` of utterances of
    the given frame counts."""
    rng = np.random.default_rng(4)
    dump, data = root / "dump" / "tr" / "norm", root / "data" / "tr"
    dump.mkdir(parents=True)
    data.mkdir(parents=True)
    lines = []
    for i, frames in enumerate(lengths):
        np.save(dump / f"u{i:02d}-wave.npy",
                (0.3 * rng.standard_normal(frames * HOP)).astype(np.float32))
        np.save(dump / f"u{i:02d}-feats.npy",
                rng.standard_normal((frames, 20)).astype(np.float32))
        art = data / f"u{i:02d}.npy"
        np.save(art, rng.standard_normal((frames + 3, dim)).astype(np.float32))
        lines.append(f"u{i:02d} {art}\n")
    (data / "feats.scp").write_text("".join(lines))
    return dict(root_dir=str(dump), audio_query="*-wave.npy",
                mel_query="*-feats.npy", audio_load_fn=np.load,
                mel_load_fn=np.load, data_root=str(root / "data"))


def test_remove_short_samples_and_batch_sampler_match_jax(tmp_path):
    lengths = [20, 40, 26, 27, 60, 12, 33, 45, 50, 28]
    kwargs = _dump(tmp_path, lengths)
    config = dict(_config("a2w", True), batch_size=2, format="npy",
                  remove_short_samples=True,
                  generator_params={"out_channels": 1, "use_ar": True,
                                    "ar_input": 512,
                                    "aux_context_window": 1})
    ours = train_cli.build_datasets(config, kwargs["root_dir"],
                                    kwargs["root_dir"], kwargs["data_root"])[0]
    theirs = JaxDataset(mel_length_threshold=FRAMES + 2, **kwargs)
    # more than batch_max_steps // hop + 2 * aux_context_window frames
    assert ours.utt_ids == theirs.utt_ids == [
        f"u{i:02d}" for i, n in enumerate(lengths) if n > FRAMES + 2]

    lens = np.array([len(ours[i]["audio"]) for i in range(len(ours))])
    config = _config("a2w", True)
    loaders = [cls(dataset, collate_fn=collater(
        batch_max_steps=FRAMES * HOP, hop_size=HOP, dataset_mode="a2w",
        config=config, rng=np.random.default_rng(9)), batch_sampler=sampler(
        lens, max_len=9000, seed=2)) for cls, dataset, collater, sampler in (
        (DataLoader, SpeechDataset(**kwargs), SpeechCollater,
         SizeAwareSampler),
        (JaxLoader, JaxDataset(**kwargs), JaxCollater, JaxSampler))]
    for epoch in (0, 1):
        for loader in loaders:
            loader.set_epoch(epoch)
        ours, theirs = list(loaders[0]), list(loaders[1])
        assert len(ours) == len(theirs) > 1
        for a, b in zip(ours, theirs):
            _assert_batches_equal(a, b)


def _jax_native_built() -> bool:
    """The JAX package's library, built with cmake as its own test does."""
    if jax_native.is_available():
        return True
    root = os.path.join(os.path.dirname(__file__), "..")
    try:
        for cmd in (["cmake", "-S", os.path.join(root, "native"), "-B",
                     os.path.join(root, "native", "build")],
                    ["cmake", "--build", os.path.join(root, "native",
                                                      "build")]):
            subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False
    return jax_native.is_available()


def test_native_loader_matches_jax(tmp_path):
    if not _jax_native_built():
        pytest.skip("the JAX package's native library cannot be built here")
    kwargs = _dump(tmp_path, [30, 40, 24, 33, 60, 41, 29])
    dataset = SpeechDataset(**kwargs)
    args = dict(batch_size=2, batch_max_steps=FRAMES * HOP, hop_size=HOP,
                ar_len=64, seed=3, n_threads=2)
    ours = NativeDataLoader(dataset, **args)
    theirs = jax_native.NativeDataLoader(JaxDataset(**kwargs), **args)
    assert ours.indices == theirs.indices and len(ours) == 3
    for epoch in (0, 2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        pairs = list(zip(ours, theirs))
        assert len(pairs) == len(ours)
        for a, b in pairs:
            _assert_batches_equal(a, b)
            assert a["ar"].shape == (2, 64, 1)
