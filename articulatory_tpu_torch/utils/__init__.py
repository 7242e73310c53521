"""The reference's ``from articulatory.utils import ...`` API (the JAX
package's ``articulatory_tpu/utils/__init__.py``): ``load_model``,
``download_pretrained_model``, ``PRETRAINED_MODEL_LIST`` and the file I/O of
``utils/io.py``. Every name is resolved on first use, so importing a module
of this package costs nothing more."""

_IO = ("read_hdf5", "write_hdf5", "find_files", "read_wav", "write_wav",
       "HDF5ScpLoader", "NpyScpLoader")

__all__ = ["load_model", "download_pretrained_model", "PRETRAINED_MODEL_LIST",
           *_IO]


def __getattr__(name):
    if name == "load_model":
        from articulatory_tpu_torch.inference import load_model

        return load_model
    if name in ("download_pretrained_model", "PRETRAINED_MODEL_LIST"):
        from articulatory_tpu_torch.utils import pretrained

        return getattr(pretrained, name)
    if name in _IO:
        from articulatory_tpu_torch.utils import io

        return getattr(io, name)
    raise AttributeError(
        f"module 'articulatory_tpu_torch.utils' has no attribute {name!r}")
