"""The port's decode-side file I/O and datasets against the JAX package's, on
the same files: utterance ids, order and arrays must be equal exactly."""

import h5py
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from articulatory_tpu.data import datasets as jax_datasets
from articulatory_tpu.utils import io as jax_io
from articulatory_tpu_torch.data import datasets
from articulatory_tpu_torch.utils import io

torch.set_num_threads(1)

LENGTHS = {"b_utt": 12, "a_utt": 7, "c_utt": 20}


@pytest.fixture
def dump(tmp_path):
    """Per utterance: <utt>-feats.npy, <utt>.h5 with "feats" and "other",
    and scp files listing each form."""
    rng = np.random.default_rng(0)
    scps = {"npy": [], "h5": [], "h5_dset": []}
    for utt, t in LENGTHS.items():
        feats = rng.standard_normal((t, 13)).astype(np.float32)
        np.save(tmp_path / f"{utt}-feats.npy", feats)
        with h5py.File(tmp_path / f"{utt}.h5", "w") as f:
            f["feats"] = feats
            f["other"] = feats[::-1] * 2
        scps["npy"].append(f"{utt} {tmp_path / f'{utt}-feats.npy'}")
        scps["h5"].append(f"{utt} {tmp_path / f'{utt}.h5'}")
        scps["h5_dset"].append(f"{utt} {tmp_path / f'{utt}.h5'}:other")
    for name, lines in scps.items():
        (tmp_path / f"{name}.scp").write_text("\n".join(lines) + "\n\n")
    return tmp_path


def _assert_same(ours, ref):
    assert len(ours) == len(ref)
    for i in range(len(ref)):
        (uid, arr), (ruid, rarr) = ours[i], ref[i]
        assert uid == ruid
        np.testing.assert_array_equal(arr, rarr)


@pytest.mark.parametrize("source,kwargs", [
    ("dir", {"query": "*-feats.npy"}),
    ("dir", {"query": "*-feats.npy", "length_threshold": 10}),
    ("npy.scp", {}),
    ("dir_h5", {"query": "*.h5"}),
])
def test_art_dataset_matches_jax(dump, source, kwargs):
    path = str(dump if source.startswith("dir") else dump / source)
    if source == "dir_h5":
        kwargs = dict(kwargs, load_fn=lambda p: io.read_hdf5(p, "feats"))
    ours = datasets.ArtDataset(path, return_utt_id=True, **kwargs)
    ref = jax_datasets.ArtDataset(path, return_utt_id=True, **kwargs)
    _assert_same(ours, ref)
    expected = len([t for t in LENGTHS.values()
                    if t > kwargs.get("length_threshold", -1)])
    assert len(ours) == expected


@pytest.mark.parametrize("scp", ["npy.scp", "h5.scp", "h5_dset.scp"])
@pytest.mark.parametrize("cls", ["MelSCPDataset", "ArtSCPDataset"])
def test_scp_datasets_match_jax(dump, scp, cls):
    kwargs = {"return_utt_id": True, "mel_length_threshold": 8}
    ours = getattr(datasets, cls)(str(dump / scp), **kwargs)
    ref = getattr(jax_datasets, cls)(str(dump / scp), **kwargs)
    _assert_same(ours, ref)
    assert len(ours) == 2


def test_art_scp_transform_and_cache_match_jax(dump):
    kwargs = {"transform": lambda a: a[:, :4] + 1.0, "allow_cache": True}
    ours = datasets.ArtSCPDataset(str(dump / "h5.scp"), **kwargs)
    ref = jax_datasets.ArtSCPDataset(str(dump / "h5.scp"), **kwargs)
    for i in range(len(ref)):
        np.testing.assert_array_equal(ours[i], ref[i])
        np.testing.assert_array_equal(ours[i], ref[i])  # from the cache
        assert ours[i].shape[1] == 4
    assert sorted(ours.caches) == sorted(ref.caches) == [0, 1, 2]


@pytest.mark.parametrize("subtype", ["PCM_16", "FLOAT"])
def test_write_wav_matches_jax(tmp_path, subtype):
    wav = np.random.default_rng(1).uniform(-1.3, 1.3, 1000).astype(np.float32)
    io.write_wav(str(tmp_path / "ours" / "x.wav"), wav, 16000, subtype)
    jax_io.write_wav(str(tmp_path / "ref.wav"), wav, 16000, subtype)
    sr, ours = wavfile.read(tmp_path / "ours" / "x.wav")
    rsr, ref = wavfile.read(tmp_path / "ref.wav")
    assert sr == rsr == 16000 and ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)


def test_find_files_and_load_scp_match_jax(dump):
    for query in ("*.h5", "*-feats.npy", "*.scp"):
        for include_root in (True, False):
            assert (io.find_files(str(dump), query, include_root)
                    == jax_io.find_files(str(dump), query, include_root))
    assert io.load_scp(str(dump / "h5_dset.scp")) == jax_io.load_scp(
        str(dump / "h5_dset.scp"))


def test_read_hdf5_raises_on_missing(dump):
    np.testing.assert_array_equal(io.read_hdf5(str(dump / "a_utt.h5"), "other"),
                                  jax_io.read_hdf5(str(dump / "a_utt.h5"),
                                                   "other"))
    with pytest.raises(FileNotFoundError):
        io.read_hdf5(str(dump / "none.h5"), "feats")
    with pytest.raises(KeyError):
        io.read_hdf5(str(dump / "a_utt.h5"), "missing")
