"""``utils/pretrained.py`` and the lazy names of ``utils/__init__.py``, on
the CPU, against the JAX package's registry and the cases of
``tests/test_pretrained.py``, with a mock Google Drive of this file's own
(a ``ThreadingHTTPServer`` on localhost): the registry equals JAX's; the
download follows a confirm-token interstitial, a download form (escaped
values, a relative action) or none, extracts the archive flattened and
resolves the checkpoint, then resolves from the cache without the server;
an archive without a checkpoint raises; a corrupt cached archive raises,
is deleted and is fetched anew; a cache hit needs no network, and a miss
without one raises with the cache's path. A downloaded reference pickle
decodes through ``load_model`` as the same pickle does from disk."""

import io
import tarfile
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch
import yaml

from articulatory_tpu.utils import pretrained as jax_pretrained
from articulatory_tpu_torch import utils
from articulatory_tpu_torch.utils import pretrained
from articulatory_tpu_torch.utils.pretrained import (
    PRETRAINED_MODEL_LIST,
    download_pretrained_model,
)

torch.set_num_threads(1)


def test_registry_matches_jax():
    assert PRETRAINED_MODEL_LIST == jax_pretrained.PRETRAINED_MODEL_LIST
    assert len(PRETRAINED_MODEL_LIST) == 35
    assert pretrained.DEFAULT_BASE_URL == jax_pretrained.DEFAULT_BASE_URL


def test_lazy_names_of_utils():
    from articulatory_tpu_torch.inference import load_model
    from articulatory_tpu_torch.utils import io as port_io

    assert utils.load_model is load_model
    assert utils.download_pretrained_model is download_pretrained_model
    assert utils.PRETRAINED_MODEL_LIST is PRETRAINED_MODEL_LIST
    for name in ("read_hdf5", "write_hdf5", "find_files", "read_wav",
                 "write_wav", "HDF5ScpLoader", "NpyScpLoader"):
        assert getattr(utils, name) is getattr(port_io, name)
    with pytest.raises(AttributeError):
        utils.no_such_name


def test_unknown_tag_asserts():
    with pytest.raises(AssertionError):
        download_pretrained_model("no_such_tag.v1")


def _archive(members):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        for name, data in members:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
        tar.addfile(tarfile.TarInfo("exp/train_all/"))  # a directory: skipped
    return buf.getvalue()


def _checkpoint_archive(payload=b"torch-pickle-bytes",
                        name="checkpoint-400000steps.pkl"):
    """The checkpoint nested in a directory (extraction flattens it) beside
    a config and statistics."""
    return _archive([(f"exp/train_all/{name}", payload),
                     ("exp/train_all/config.yml", b"generator_type: x\n"),
                     ("exp/train_all/stats.h5", b"\x89HDF")])


class _Drive(BaseHTTPRequestHandler):
    """Google Drive's ``uc`` endpoint: ``flow`` "link" serves an HTML page
    with a confirm token until it is echoed back, "form" a download form
    whose hidden fields must come back to its (relative) action, "direct"
    the archive at once."""

    archive = b""
    flow = "direct"
    hits = None

    def _send(self, body, ctype):
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        self.hits.append(self.path)
        if self.flow == "link" and "confirm=" not in self.path:
            return self._send(b'<html><a href="#">Download anyway'
                              b'&amp;confirm=tOkEn_-123</a></html>',
                              "text/html; charset=utf-8")
        if self.flow == "form" and self.path.startswith("/uc"):
            return self._send(
                b'<html><form action="/download&#63;source=uc" method="get">'
                b'<input type="hidden" name="id" value="abc123">'
                b'<input type="hidden" name="confirm" value="t&amp;ok">'
                b'<input type="hidden" name="uuid" value="u-1">'
                b'</form></html>', "text/html; charset=utf-8")
        if self.flow == "form":
            query = urllib.parse.parse_qs(urllib.parse.urlparse(
                self.path).query)
            assert query["confirm"] == ["t&ok"] and query["uuid"] == ["u-1"]
        self._send(self.archive, "application/x-gzip")

    def log_message(self, *args):
        pass


@pytest.fixture()
def drive(monkeypatch):
    handler = type("Drive", (_Drive,), {"hits": []})
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    monkeypatch.setenv("ARTICULATORY_PRETRAIN_URL",
                       f"http://127.0.0.1:{server.server_address[1]}/uc")
    yield handler
    server.shutdown()
    thread.join()


@pytest.mark.parametrize("flow,hits", [("link", 2), ("form", 2),
                                       ("direct", 1)])
def test_download_follows_the_interstitial(flow, hits, drive, tmp_path):
    drive.flow, drive.archive = flow, _checkpoint_archive()
    tag = "ljspeech_hifigan.v1"
    path = download_pretrained_model(tag, download_dir=str(tmp_path))
    assert path == str(tmp_path / tag / "checkpoint-400000steps.pkl")
    assert open(path, "rb").read() == b"torch-pickle-bytes"
    assert (tmp_path / tag / "config.yml").exists()
    assert (tmp_path / tag / "stats.h5").exists()
    assert (tmp_path / f"{tag}.tar.gz").exists()  # kept, as the reference
    assert len(drive.hits) == hits
    assert f"id={PRETRAINED_MODEL_LIST[tag]}" in drive.hits[0]
    if flow == "link":
        assert "confirm=tOkEn_-123" in drive.hits[1]
    if flow == "form":
        assert drive.hits[1].startswith("/download?source=uc")
    # from the cache, without the server
    assert download_pretrained_model(tag, download_dir=str(tmp_path)) == path
    assert len(drive.hits) == hits


def test_download_archive_without_checkpoint(drive, tmp_path):
    drive.archive = _archive([("readme.txt", b"hi")])
    with pytest.raises(FileNotFoundError, match="contained no checkpoint"):
        download_pretrained_model("kss_parallel_wavegan.v1",
                                  download_dir=str(tmp_path))


def test_corrupt_cached_archive_self_heals(drive, tmp_path):
    drive.archive = _checkpoint_archive()
    tag = "csmsc_hifigan.v1"
    bad = tmp_path / f"{tag}.tar.gz"
    bad.write_bytes(b"this is not a tarball")
    with pytest.raises(FileNotFoundError, match="download from .* failed"):
        download_pretrained_model(tag, download_dir=str(tmp_path))
    assert not bad.exists()
    path = download_pretrained_model(tag, download_dir=str(tmp_path))
    assert path.endswith("checkpoint-400000steps.pkl")
    assert len(drive.hits) == 1


def test_cache_first_without_network(tmp_path, monkeypatch):
    # a closed local port: the fetch fails at once
    monkeypatch.setenv("ARTICULATORY_PRETRAIN_URL", "http://127.0.0.1:1/uc")
    monkeypatch.setenv("ARTICULATORY_PRETRAIN_DIR", str(tmp_path))
    tag = "ljspeech_hifigan.v1"
    with pytest.raises(FileNotFoundError, match=str(tmp_path / tag)):
        download_pretrained_model(tag)
    (tmp_path / tag).mkdir()
    ckpt = tmp_path / tag / "checkpoint-2500000steps.pkl"
    ckpt.write_bytes(b"\x00")
    assert download_pretrained_model(tag) == str(ckpt)


def test_downloaded_pickle_decodes(drive, tmp_path):
    """A reference pickle fetched and extracted loads through the port's
    ``load_model`` as it is, and decodes as the same pickle from disk."""
    from articulatory_tpu_torch import inference
    from articulatory_tpu_torch.models import build_model

    gp = dict(in_channels=13, out_channels=1, channels=16, kernel_size=7,
              upsample_scales=[4, 2], upsample_kernel_sizes=[8, 4],
              resblock_kernel_sizes=[3], resblock_dilations=[[1, 3]])
    config = {"generator_type": "HiFiGANGenerator", "generator_params": gp,
              "hop_size": 8, "sampling_rate": 16000, "format": "npy"}
    buf = io.BytesIO()
    torch.save({"model": {"generator": build_model(
        "HiFiGANGenerator", gp).state_dict()}, "steps": 1}, buf)
    drive.flow = "link"
    drive.archive = _checkpoint_archive(buf.getvalue())
    path = download_pretrained_model("vctk_hifigan.v1",
                                     download_dir=str(tmp_path))
    local = tmp_path / "local.pkl"
    local.write_bytes(buf.getvalue())
    (tmp_path / "config.yml").write_text(yaml.dump(config))
    x = np.random.default_rng(0).standard_normal((20, 13)).astype(np.float32)
    outs = [inference.load_model(p, config, device="cpu").inference(x)
            for p in (path, str(local))]
    assert outs[0].shape == (160, 1) and np.isfinite(outs[0]).all()
    np.testing.assert_array_equal(outs[0], outs[1])
