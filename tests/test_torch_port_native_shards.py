"""The native loader's data-parallel shards (``data/native_loader.py``)
against the JAX package's, bit for bit and batch for batch: 2 and 3
shards, every rank, on a corpus of 7 usable utterances (neither count
divides it, so the shards are wrap-padded), two epochs, and a resumed
epoch (``set_epoch(epoch, start)``) that yields the tail of the
uninterrupted shard. ``bin/train.py::_fast_loader`` hands each
data-parallel rank its shard, the same one to the ranks of a
tensor-parallel group, without a warning."""

import logging

import pytest
import torch

from articulatory_tpu.data import native_loader as jax_native
from articulatory_tpu.data.datasets import SpeechDataset as JaxDataset
from articulatory_tpu_torch.bin import train as train_cli
from articulatory_tpu_torch.data.datasets import SpeechDataset
from articulatory_tpu_torch.data.native_loader import NativeDataLoader
from articulatory_tpu_torch.parallel import mesh
from test_torch_port_data_cache import (
    FRAMES,
    HOP,
    _assert_batches_equal,
    _dump,
    _jax_native_built,
)

torch.set_num_threads(1)

# 7 of these are longer than the 25-frame window
LENGTHS = [30, 40, 24, 33, 60, 41, 29, 50, 20]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    if not _jax_native_built():
        pytest.skip("the JAX package's native library cannot be built here")
    return _dump(tmp_path_factory.mktemp("shards"), LENGTHS)


def _args(num_shards):
    return dict(batch_size=2 if num_shards == 2 else 1,
                batch_max_steps=FRAMES * HOP, hop_size=HOP, ar_len=64,
                seed=3, n_threads=2, num_shards=num_shards)


@pytest.mark.parametrize("num_shards,shard_id", [(2, 0), (2, 1), (3, 0),
                                                 (3, 1), (3, 2)])
def test_native_shards_match_jax(corpus, num_shards, shard_id):
    args = dict(_args(num_shards), shard_id=shard_id)
    ours = NativeDataLoader(SpeechDataset(**corpus), **args)
    theirs = jax_native.NativeDataLoader(JaxDataset(**corpus), **args)
    assert len(ours.indices) == 7
    assert len(ours) == len(theirs) == (2 if num_shards == 2 else 3)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours)
        for a, b in zip(got, want):
            _assert_batches_equal(a, b)
        ours.set_epoch(epoch, start=1)
        tail = list(ours)
        assert len(tail) == len(got) - 1
        for a, b in zip(tail, want[1:]):
            _assert_batches_equal(a, b)


def test_shards_cover_the_padded_epoch(corpus):
    loaders = [NativeDataLoader(SpeechDataset(**corpus), **_args(3),
                                shard_id=r) for r in range(3)]
    orders = [loader.shard_order() for loader in loaders]
    assert [len(o) for o in orders] == [3, 3, 3]
    taken = sorted(int(i) for o in orders for i in o)
    usable = loaders[0].indices
    # every usable utterance once, the first two of the shuffle twice
    assert sorted(set(taken)) == sorted(usable) and len(taken) == 9


@pytest.mark.parametrize("dp,tp,rank", [(2, 1, 1), (2, 2, 3), (2, 1, 0)])
def test_fast_loader_hands_each_rank_its_shard(corpus, monkeypatch, caplog,
                                               dp, tp, rank):
    lay = mesh.Layout(dp=dp, tp=tp, dp_rank=rank // tp, tp_rank=rank % tp,
                      dp_group=mesh.SOLO, tp_group=mesh.SOLO)
    monkeypatch.setattr(mesh, "layout", lambda: lay)
    config = {"use_native_loader": True, "dataset_mode": "a2w",
              "batch_size": 2, "batch_max_steps": FRAMES * HOP,
              "hop_size": HOP, "num_workers": 2,
              "generator_params": {"use_ar": True, "ar_input": 64}}
    with caplog.at_level(logging.WARNING):
        loader = train_cli._fast_loader(config, SpeechDataset(**corpus),
                                        None, 3, torch.device("cpu"))
    assert isinstance(loader, NativeDataLoader)
    assert (loader.shard_id, loader.num_shards) == (rank // tp, dp)
    assert loader.batcher.ar_len == 64
    assert not [r for r in caplog.records if r.levelno >= logging.WARNING]
    # the device cache stays single-process, and says so
    with caplog.at_level(logging.WARNING):
        loader = train_cli._fast_loader(dict(config, use_device_cache=True),
                                        SpeechDataset(**corpus), None, 3,
                                        torch.device("cpu"))
    assert isinstance(loader, NativeDataLoader)
    assert any("use_device_cache" in r.getMessage() for r in caplog.records)
