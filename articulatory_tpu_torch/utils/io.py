"""File I/O: kaldi-style scp maps (feature and wav.scp, with piped entries
and segments), hdf5 datasets, PCM wav reading and writing (port of
``articulatory_tpu/utils/io.py``). ``h5py`` is imported only when an hdf5
file is read or written."""

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


def write_hdf5(hdf5_name: str, hdf5_path: str, write_data) -> None:
    """Write a dataset into an hdf5 file (appending to the file, making its
    directory where needed); an existing dataset of that name is
    replaced."""
    import h5py

    folder = os.path.dirname(hdf5_name)
    if folder:
        os.makedirs(folder, exist_ok=True)
    with h5py.File(hdf5_name, "a") as f:
        if hdf5_path in f:
            del f[hdf5_path]
        f.create_dataset(hdf5_path, data=np.asarray(write_data))


def _pcm_to_float(data: np.ndarray) -> np.ndarray:
    """Integer PCM -> float32 in [-1, 1]; float data passes through."""
    if data.dtype == np.int16:
        return data.astype(np.float32) / 32768.0
    if data.dtype == np.int32:
        return data.astype(np.float32) / 2147483648.0
    if data.dtype == np.uint8:
        return (data.astype(np.float32) - 128.0) / 128.0
    return data.astype(np.float32)


def read_wav(path) -> tuple[np.ndarray, int]:
    """A wav file (a path or a binary file object) -> (float32 waveform in
    [-1, 1], sample rate)."""
    sr, data = wavfile.read(path)
    return _pcm_to_float(data), int(sr)


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


class WavScpLoader:
    """wav.scp values: paths, or shell commands ending in ``|`` whose
    standard output is a wav. With ``segments`` (lines ``utt_id rec_id start
    end``, seconds) the keys are utterances cut out of the recordings.
    Items are ``(waveform, sample rate)``."""

    def __init__(self, wav_scp: str, segments: str | None = None):
        self.data = load_scp(wav_scp)
        self.segments: dict[str, tuple[str, float, float]] | None = None
        if segments is not None:
            self.segments = {}
            with open(segments) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 4:
                        utt, rec, start, end = parts[:4]
                        self.segments[utt] = (rec, float(start), float(end))

    @staticmethod
    def _read(value: str) -> tuple[np.ndarray, int]:
        if value.endswith("|"):
            import io
            import subprocess

            proc = subprocess.run(value[:-1], shell=True, check=True,
                                  stdout=subprocess.PIPE)
            return read_wav(io.BytesIO(proc.stdout))
        return read_wav(value)

    def __getitem__(self, key: str) -> tuple[np.ndarray, int]:
        if self.segments is not None:
            rec, start, end = self.segments[key]
            audio, sr = self._read(self.data[rec])
            return audio[int(start * sr): int(end * sr)], sr
        return self._read(self.data[key])

    def __len__(self) -> int:
        return len(self.keys())

    def __iter__(self):
        return iter(self.keys())

    def keys(self):
        return (self.segments if self.segments is not None
                else self.data).keys()
