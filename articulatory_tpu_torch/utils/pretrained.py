"""Pretrained model registry and downloader (port of
``articulatory_tpu/utils/pretrained.py``; the reference's
utils/utils.py:22-59, 375-407).

The reference downloads 35 ParallelWaveGAN-era checkpoints from Google
Drive through gdown (``uc?id=<drive id>`` -> ``<tag>.tar.gz`` under a file
lock, flattened tar extraction, the first ``checkpoint*.pkl`` returned).
This module keeps the same contract with the standard library alone: a
urllib downloader that follows Google Drive's virus-scan interstitials (a
confirm-token link or a download form, up to 5 hops), an ``fcntl``
download lock, and extraction flattened to the members' basenames, staged
through a temporary directory.

Resolution order in ``download_pretrained_model``:

1. the local cache (``$ARTICULATORY_PRETRAIN_DIR`` or
   ``~/.cache/articulatory_tpu``, the JAX package's, so an archive placed
   once serves both packages): an extracted checkpoint wins without the
   network;
2. a fetch from ``$ARTICULATORY_PRETRAIN_URL`` (default the Google Drive
   ``uc`` endpoint). Without network access, seed the cache instead.

A resolved checkpoint is a reference torch pickle (or a ``.ckpt``), which
``inference.load_model`` reads as it is.

Security note: the archives hold torch pickles. The port reads them with
``torch.load(weights_only=True)``, which refuses arbitrary objects; still,
point ``ARTICULATORY_PRETRAIN_URL`` only at mirrors you trust and prefer
https.
"""

from __future__ import annotations

import contextlib
import os
import re
import tarfile

# tag -> google drive id (for provenance; not downloadable here)
PRETRAINED_MODEL_LIST = {
    "ljspeech_parallel_wavegan.v1": "1PdZv37JhAQH6AwNh31QlqruqrvjTBq7U",
    "ljspeech_parallel_wavegan.v1.long": "1A9TsrD9fHxFviJVFjCk5W6lkzWXwhftv",
    "ljspeech_parallel_wavegan.v1.no_limit": "1CdWKSiKoFNPZyF1lo7Dsj6cPKmfLJe72",
    "ljspeech_parallel_wavegan.v3": "1-oZpwpWZMMolDYsCqeL12dFkXSBD9VBq",
    "ljspeech_melgan.v1": "1i7-FPf9LPsYLHM6yNPoJdw5Q9d28C-ip",
    "ljspeech_melgan.v1.long": "1x1b_R7d2561nqweK3FPb2muTdcFIYTu6",
    "ljspeech_melgan.v3": "1J5gJ_FUZhOAKiRFWiAK6FcO5Z6oYJbmQ",
    "ljspeech_melgan.v3.long": "124JnaLcRe7TsuAGh3XIClS3C7Wom9AU2",
    "ljspeech_full_band_melgan.v2": "1Kb7q5zBeQ30Wsnma0X23G08zvgDG5oen",
    "ljspeech_multi_band_melgan.v2": "1b70pJefKI8DhGYz4SxbEHpxm92tj1_qC",
    "ljspeech_hifigan.v1": "1i6-hR_ksEssCYNlNII86v3AoeA1JcuWD",
    "ljspeech_style_melgan.v1": "10aJSZfmCAobQJgRGio6cNyw6Xlgmme9-",
    "jsut_parallel_wavegan.v1": "1qok91A6wuubuz4be-P9R2zKhNmQXG0VQ",
    "jsut_multi_band_melgan.v2": "1chTt-76q2p69WPpZ1t1tt8szcM96IKad",
    "jsut_hifigan.v1": "1vdgqTu9YKyGMCn-G7H2fI6UBC_4_55XB",
    "jsut_style_melgan.v1": "1VIkjSxYxAGUVEvJxNLaOaJ7Twe48SH-s",
    "csmsc_parallel_wavegan.v1": "1QTOAokhD5dtRnqlMPTXTW91-CG7jf74e",
    "csmsc_multi_band_melgan.v2": "1G6trTmt0Szq-jWv2QDhqglMdWqQxiXQT",
    "csmsc_hifigan.v1": "1fVKGEUrdhGjIilc21Sf0jODulAq6D1qY",
    "csmsc_style_melgan.v1": "1kGUC_b9oVSv24vZRi66AAbSNUKJmbSCX",
    "arctic_slt_parallel_wavegan.v1": "1_MXePg40-7DTjD0CDVzyduwQuW_O9aA1",
    "jnas_parallel_wavegan.v1": "1D2TgvO206ixdLI90IqG787V6ySoXLsV_",
    "vctk_parallel_wavegan.v1": "1bqEFLgAroDcgUy5ZFP4g2O2MwcwWLEca",
    "vctk_parallel_wavegan.v1.long": "1tO4-mFrZ3aVYotgg7M519oobYkD4O_0-",
    "vctk_multi_band_melgan.v2": "10PRQpHMFPE7RjF-MHYqvupK9S0xwBlJ_",
    "vctk_hifigan.v1": "1oVOC4Vf0DYLdDp4r7GChfgj7Xh5xd0ex",
    "vctk_style_melgan.v1": "14ThSEgjvl_iuFMdEGuNp7d3DulJHS9Mk",
    "libritts_parallel_wavegan.v1": "1zHQl8kUYEuZ_i1qEFU6g2MEu99k3sHmR",
    "libritts_parallel_wavegan.v1.long": "1b9zyBYGCCaJu0TIus5GXoMF8M3YEbqOw",
    "libritts_multi_band_melgan.v2": "1kIDSBjrQvAsRewHPiFwBZ3FDelTWMp64",
    "libritts_hifigan.v1": "1_TVFIvVtMn-Z4NiQrtrS20uSJOvBsnu1",
    "libritts_style_melgan.v1": "1yuQakiMP0ECdB55IoxEGCbXDnNkWCoBg",
    "kss_parallel_wavegan.v1": "1mLtQAzZHLiGSWguKCGG0EZa4C_xUO5gX",
    "hui_acg_hokuspokus_parallel_wavegan.v1": "1irKf3okMLau56WNeOnhr2ZfSVESyQCGS",
    "ruslan_parallel_wavegan.v1": "1M3UM6HN6wrfSe5jdgXwBnAIl_lJzLzuI",
}


#: Base endpoint queried with ``?id=<drive id>``. Override (e.g. to an
#: institutional mirror, or a mock server in tests) via the environment.
DEFAULT_BASE_URL = "https://drive.google.com/uc"

# Google Drive's "can't scan for viruses" interstitial embeds the bypass
# token either as a confirm= link or as a hidden <input> in a download form.
_CONFIRM_RE = re.compile(rb"confirm=([0-9A-Za-z_\-]+)")
_FORM_INPUT_RE = re.compile(
    rb'name="([^"]+)"\s+value="([^"]*)"')
_FORM_ACTION_RE = re.compile(rb'action="([^"]+)"')


@contextlib.contextmanager
def _download_lock(path: str):
    """Exclusive advisory lock (reference wraps the fetch in a FileLock)."""
    import fcntl

    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


def _fetch_drive_file(url: str, output_path: str, chunk_size: int = 1 << 20):
    """Download ``url`` to ``output_path``, following the Drive interstitial.

    A response with an HTML content type is parsed for the confirm-token
    link (or download form) and re-requested — the same dance gdown
    performs; binary responses stream straight to disk. Current Drive flows
    chain several interstitials (confirm link, then a usercontent form), so
    up to 5 hops are followed; extracted URLs are HTML-unescaped and
    relative form actions resolved against the page URL.
    """
    import html
    import urllib.parse
    import urllib.request

    opener = urllib.request.build_opener(
        urllib.request.HTTPCookieProcessor())
    for _ in range(5):
        with opener.open(url) as resp:
            ctype = resp.headers.get("Content-Type", "")
            if "text/html" not in ctype:
                with open(output_path + ".part", "wb") as f:
                    while True:
                        chunk = resp.read(chunk_size)
                        if not chunk:
                            break
                        f.write(chunk)
                os.replace(output_path + ".part", output_path)
                return
            body = resp.read()
            page_url = resp.geturl()
        m = _CONFIRM_RE.search(body)
        if m:
            sep = "&" if "?" in url else "?"
            url = f"{url}{sep}confirm={m.group(1).decode()}"
            continue
        action = _FORM_ACTION_RE.search(body)
        if action:
            fields = dict(_FORM_INPUT_RE.findall(body))
            query = urllib.parse.urlencode(
                {html.unescape(k.decode()): html.unescape(v.decode())
                 for k, v in fields.items()})
            action_url = urllib.parse.urljoin(
                page_url, html.unescape(action.group(1).decode()))
            sep = "&" if "?" in action_url else "?"
            url = action_url + sep + query
            continue
        raise RuntimeError(
            f"Unrecognized interstitial page while downloading {url!r} "
            "(no confirm token or download form found).")
    raise RuntimeError(f"Interstitial loop did not converge for {url!r}.")


def _extract_flat(archive_path: str, dest_dir: str):
    """Extract regular members flattened to their basenames (the reference's
    extraction shape: every checkpoint lands directly in the tag dir).

    Extraction is staged through a temp dir and renamed into place only on
    success, so a truncated archive that fails mid-extraction can never
    leave a partial checkpoint*.pkl where ``_resolve_cached`` would treat it
    as a valid cache hit on the next call.
    """
    import shutil

    tmp_dir = f"{dest_dir}.tmp-{os.getpid()}"
    os.makedirs(tmp_dir, exist_ok=True)
    try:
        with tarfile.open(archive_path, "r:*") as tar:
            for member in tar.getmembers():
                if not member.isreg():
                    continue
                name = os.path.basename(member.name)
                if not name or name.startswith(("/", "..")):
                    continue
                src = tar.extractfile(member)
                with open(os.path.join(tmp_dir, name), "wb") as out:
                    while True:
                        chunk = src.read(1 << 20)
                        if not chunk:
                            break
                        out.write(chunk)
    except BaseException:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise
    shutil.rmtree(dest_dir, ignore_errors=True)
    os.rename(tmp_dir, dest_dir)


def _resolve_cached(tag_dir: str) -> str | None:
    from articulatory_tpu_torch.utils.io import find_files

    ckpts = find_files(tag_dir, "checkpoint*.pkl") + \
        find_files(tag_dir, "*.ckpt")
    return ckpts[0] if ckpts else None


def download_pretrained_model(tag: str, download_dir: str | None = None) -> str:
    """Resolve (cache-first) or download a pretrained checkpoint.

    Returns the checkpoint path. When the cache misses and the fetch fails
    (e.g. no egress), raises with seeding instructions.
    """
    assert tag in PRETRAINED_MODEL_LIST, f"{tag} does not exist."
    if download_dir is None:
        download_dir = os.environ.get(
            "ARTICULATORY_PRETRAIN_DIR",
            os.path.expanduser("~/.cache/articulatory_tpu"))
    tag_dir = os.path.join(download_dir, tag)
    if os.path.isdir(tag_dir):
        found = _resolve_cached(tag_dir)
        if found:
            return found

    drive_id = PRETRAINED_MODEL_LIST[tag]
    base_url = os.environ.get("ARTICULATORY_PRETRAIN_URL", DEFAULT_BASE_URL)
    url = f"{base_url}?id={drive_id}"
    output_path = os.path.join(download_dir, f"{tag}.tar.gz")
    os.makedirs(download_dir, exist_ok=True)
    try:
        with _download_lock(output_path + ".lock"):
            if not os.path.exists(output_path):
                _fetch_drive_file(url, output_path)
            # re-check: a concurrent holder may have extracted already
            found = _resolve_cached(tag_dir)
            if found:
                return found
            try:
                _extract_flat(output_path, tag_dir)
            except (tarfile.TarError, OSError, EOFError):
                # corrupt/truncated archive: drop it so the next call
                # re-downloads instead of wedging on the bad cache entry
                with contextlib.suppress(OSError):
                    os.remove(output_path)
                raise
    except (OSError, RuntimeError, tarfile.TarError, EOFError) as exc:
        raise FileNotFoundError(
            f"Pretrained model '{tag}' not in the cache at {tag_dir} and the "
            f"download from {url} failed ({exc}). On a machine without "
            f"network access, fetch the archive (Google Drive id {drive_id}) "
            f"elsewhere and extract it to that directory.") from exc
    found = _resolve_cached(tag_dir)
    if found:
        return found
    raise FileNotFoundError(
        f"Downloaded archive for '{tag}' contained no checkpoint*.pkl/"
        f"*.ckpt (extracted to {tag_dir}).")
