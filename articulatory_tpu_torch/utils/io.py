"""File I/O: kaldi-style scp maps, hdf5 datasets, PCM wav writing (port of
``articulatory_tpu/utils/io.py``). ``h5py`` is imported only when an hdf5
file is read."""

from __future__ import annotations

import fnmatch
import os

import numpy as np
from scipy.io import wavfile


def find_files(root_dir: str, query: str = "*.wav", include_root_dir: bool = True
               ) -> list[str]:
    """Recursively find files matching the query pattern, sorted."""
    files = []
    for root, _, filenames in os.walk(root_dir, followlinks=True):
        for filename in fnmatch.filter(filenames, query):
            files.append(os.path.join(root, filename))
    if not include_root_dir:
        files = [f.replace(root_dir + "/", "") for f in files]
    return sorted(files)


def read_hdf5(hdf5_name: str, hdf5_path: str) -> np.ndarray:
    """Read a named dataset from an hdf5 file."""
    import h5py

    if not os.path.exists(hdf5_name):
        raise FileNotFoundError(f"There is no such hdf5 file ({hdf5_name}).")
    with h5py.File(hdf5_name, "r") as f:
        if hdf5_path not in f:
            raise KeyError(f"There is no dataset {hdf5_path} in {hdf5_name}.")
        return f[hdf5_path][()]


def write_wav(path: str, wav: np.ndarray, sr: int, subtype: str = "PCM_16") -> None:
    """Write a float waveform as PCM_16 (default, as the reference's decode)
    or FLOAT."""
    folder = os.path.dirname(path)
    if folder:
        os.makedirs(folder, exist_ok=True)
    wav = np.asarray(wav, dtype=np.float64)
    if subtype == "PCM_16":
        data = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
    elif subtype == "FLOAT":
        data = wav.astype(np.float32)
    else:
        raise ValueError(f"Unsupported subtype: {subtype}")
    wavfile.write(path, sr, data)


def load_scp(path: str) -> dict[str, str]:
    """Parse a kaldi-style 'utt_id value' scp file into an ordered dict."""
    out: dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                key, value = line.split(maxsplit=1)
                out[key] = value
    return out


class _ScpLoader:
    def __init__(self, feats_scp: str):
        self.data = load_scp(feats_scp)

    def __len__(self) -> int:
        return len(self.data)

    def __iter__(self):
        return iter(self.data)

    def keys(self):
        return self.data.keys()


class HDF5ScpLoader(_ScpLoader):
    """scp values 'some.h5:dataset' or 'some.h5' (reads ``default_hdf5_path``)."""

    def __init__(self, feats_scp: str, default_hdf5_path: str = "feats"):
        super().__init__(feats_scp)
        self.default_hdf5_path = default_hdf5_path

    def __getitem__(self, key: str) -> np.ndarray:
        p = self.data[key]
        if ":" in p:
            path, dset = p.split(":", 1)
            return read_hdf5(path, dset)
        return read_hdf5(p, self.default_hdf5_path)


class NpyScpLoader(_ScpLoader):
    """scp values that are .npy paths."""

    def __getitem__(self, key: str) -> np.ndarray:
        return np.load(self.data[key])
