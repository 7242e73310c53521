"""Rules the port keeps: it imports no JAX and nothing of the JAX package,
and neither sklearn nor tqdm (the card's machine has neither); optional
packages (yaml, h5py, msgpack, triton, matplotlib, tensorboardX,
transformers) load only inside the functions that need them; entry points run on CUDA unless asked
for the CPU, and raise without a card instead of dropping to the CPU."""

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

from articulatory_tpu_torch import inference
from articulatory_tpu_torch.bin import decode as decode_cli
from articulatory_tpu_torch.ops.resblock_pair import resblock_pair
from articulatory_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "articulatory_tpu_torch"
PORT_FILES = sorted(p for p in PACKAGE.rglob("*.py")  # build/ is output
                    if p.relative_to(PACKAGE).parts[0] != "build") + [
    ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "articulatory_tpu",
          "sklearn", "tqdm")
OPTIONAL = ("yaml", "h5py", "msgpack", "triton", "matplotlib", "tensorboardX",
            "transformers")


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield node, [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node, [node.module]


def _top(name):
    return name.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_imports_no_jax_package(path):
    tree = ast.parse(path.read_text())
    in_functions = {id(n) for f in ast.walk(tree)
                    if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                    for n in ast.walk(f)}
    for node, names in _imports(tree):
        for name in names:
            assert _top(name) not in BANNED, f"{path}: imports {name}"
            # optional packages load only inside the functions needing them
            assert id(node) in in_functions or _top(name) not in OPTIONAL, \
                f"{path}: module-level import of {name}"


def test_port_file_list_is_complete():
    assert len(PORT_FILES) > 20 and (ROOT / "chip_smoke.py").exists()
    # the parallel modules are held to the rules with the rest
    for name in ("parallel/mesh.py", "parallel/tp.py", "parallel/pp.py",
                 "parallel/sp.py", "distributed/launch.py"):
        assert PACKAGE / name in PORT_FILES, name


def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.load_model(str(tmp_path / "missing.pkl"), {})
    np.save(tmp_path / "u-feats.npy", np.zeros((10, 13), np.float32))
    config = {"format": "npy", "dataset_mode": "a2w",
              "generator_params": {"use_ar": True}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_cli.decode(config, str(tmp_path / "missing.pkl"),
                          str(tmp_path / "out"), dumpdir=str(tmp_path))
    assert resolve_device("cpu") == torch.device("cpu")


def test_ab_phase_fails_without_cuda(monkeypatch, tmp_path):
    """The A/B runner's runs exit without a card; it records each failed
    run and returns 1."""
    from articulatory_tpu_torch.bin import ab_phase

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    out = tmp_path / "ab.json"
    assert ab_phase.main([str(ROOT), str(ROOT), "--out", str(out)]) == 1
    runs = json.loads(out.read_text())
    assert [r["tree"] for r in runs] == ["parent", "change", "change",
                                         "parent"]
    assert all(r["exit"] == 1 for r in runs)


def test_resblock_pair_rejects_other_devices():
    x = torch.zeros(1, 4, 4, device="meta")
    w = torch.zeros(3, 4, 4, device="meta")
    before = resblock_pair.launches
    with pytest.raises(ValueError):
        resblock_pair(x, w, None, w, None, dilation=1)
    assert resblock_pair.launches == before
