"""Long-horizon co-training parity: the port's training stack against the
JAX package's, side by side from the same weights on the same batches.

The JAX leg reuses the code that certified the JAX package's trained models:
``tools/cotrain_parity.py`` is loaded by path, its width globals set as its
``main`` sets them, and its ``build_corpus``, ``sample_batches`` and
``run_ours`` run as they are; JAX's trained generator decodes through
``articulatory_tpu.inference.ar_loop`` behind the tool's ``_Shim``. The port
leg is ``articulatory_tpu_torch/tools/cotrain_parity.py``. Before any step
the two packages' corpora, batches and initial weights are held bit for bit.

The tier-1 test runs the tiny float64 profile (40 steps, the discriminator
from step 11, milestones at 15 and 25): in float64 rounding is ~1e-16 an
op, so any semantic drift (eps placement, clip-then-step order, when a
scheduler steps, an off-by-one in gating) would grow far past 1e-9 over the
run. The other tests hold the committed artifacts
(``articulatory_tpu_torch/tools/artifacts/cotrain_{f64,f32_wide}.json``
and their ``.npz`` decodes) to their profiles and bounds, and ``check`` to
its rule that no bound scales with the port's own gap.

Run as a script, the file writes an artifact: the JAX run, the JAX runs
from inits perturbed by +1, -1, +2 and -2 ulp (the controls: the JAX
package's own noise cone), the port's CPU leg, the decodes and the
checks::

    python tests/test_torch_port_cotrain.py --profile f64 \\
        --out articulatory_tpu_torch/tools/artifacts/cotrain_f64.json

``--steps`` and ``--milestones`` override the profile's (the 300-step
float64 record ``cotrain_f64_300_steps.json`` is ``--profile f64 --steps
300 --milestones 150 225``).
"""

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
jax.config.update("jax_platforms", "cpu")

from articulatory_tpu_torch.tools import cotrain_parity as port_tool  # noqa: E402
from articulatory_tpu_torch.utils.weights import (  # noqa: E402
    jax_msmpd_to_state_dict,
    jax_params_to_state_dict,
)

JAX_TOOL = os.path.join(REPO, "tools", "cotrain_parity.py")
ARTIFACT_PROFILES = ("f64", "f32-wide")


def jax_tool(a):
    """A fresh copy of the JAX tool with its width globals (and, for the
    e2w profile, its discriminator) set as its ``main`` sets them."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_cotrain_{a.profile.replace('-', '_')}", JAX_TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    gp = tool.GEN_CFG
    if a.channels is not None:
        gp["channels"] = a.channels
    if a.full_mrf:
        gp["resblock_kernel_sizes"] = [3, 7, 11]
        gp["resblock_dilations"] = [[1, 3, 5]] * 3
    if a.ar_input is not None:
        gp["ar_input"] = a.ar_input
    if a.ar_hidden is not None:
        gp["ar_hidden"] = a.ar_hidden
    if a.ar_output is not None:
        gp["ar_output"] = a.ar_output
        gp["in_channels"] = tool.N_FEATS + a.ar_output
    if a.disc != "toy":
        tool.DISC_CFG = port_tool.discriminator_config(a)
    assert tool.GEN_CFG == port_tool.generator_config(a)
    assert tool.DISC_CFG == port_tool.discriminator_config(a)
    assert (tool.MEL_CFG, tool.BETAS, tool.HOP, tool.SR) == (
        port_tool.MEL_CFG, port_tool.BETAS, port_tool.HOP, port_tool.SR)
    assert (tool.LAMBDA_AUX, tool.LAMBDA_ADV, tool.LAMBDA_FM) == (
        port_tool.LAMBDA_AUX, port_tool.LAMBDA_ADV, port_tool.LAMBDA_FM)
    return tool


def _same_arrays(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        for gx, wx in zip(g, w):
            assert gx.dtype == wx.dtype and np.array_equal(gx, wx), \
                f"{what} {i}"


def _same_state_dict(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(
            got[k], want[k]), f"{what}: {k}"


def check_inputs_equal(tool, a, inputs):
    """The JAX tool's corpus and batches, and the weights JAX imports from
    the state dicts (carried back by the port's converters), are the
    port's bit for bit."""
    from articulatory_tpu.utils.torch_import import (
        import_hifigan_generator,
        import_hifigan_msmpd,
    )

    train, dev = tool.build_corpus(a.n_train_utts, a.n_dev_utts, a.seed)
    _same_arrays(train + dev, inputs["train"] + inputs["dev"], "utterance")
    gp = inputs["gen_cfg"]
    win = a.batch_max_steps // tool.HOP
    dt = np.float64 if a.x64 else np.float32
    _same_arrays(tool.sample_batches(train, a.steps, a.batch_size, win,
                                     gp["ar_input"], a.seed, dtype=dt),
                 inputs["batches"], "batch")
    _same_arrays(tool.sample_batches(dev, a.n_eval_batches, a.batch_size,
                                     win, gp["ar_input"], a.seed + 7,
                                     dtype=dt),
                 inputs["eval_batches"], "eval batch")
    sd_g, sd_d = inputs["init_sd_g"], inputs["init_sd_d"]
    _same_state_dict(jax_params_to_state_dict(
        import_hifigan_generator(sd_g, tool.GEN_CFG), gp), sd_g, "generator")
    _same_state_dict(jax_msmpd_to_state_dict(
        import_hifigan_msmpd(sd_d, tool.DISC_CFG), inputs["disc_cfg"]), sd_d,
        "discriminator")


class _Shim:
    """``tools/cotrain_parity.py::decode_both``'s stand-in for a loaded JAX
    model: ``ar_loop`` calls it on a chunk and the AR carry."""

    def __init__(self, model, params):
        self.model = model
        self.params = params
        self.mutables = {}
        self._fn = jax.jit(
            lambda p, c, ar: model.apply({"params": p}, c, ar=ar))

    def __call__(self, c, ar=None):
        return self._fn(self.params, c, ar)


def jax_leg(tool, a, inputs, sign=0) -> dict:
    """JAX's ``run_ours`` (from the init times (1 + sign ulp) for a
    control) and its trained generator's decodes of the held-out
    utterances."""
    from articulatory_tpu.inference import ar_loop

    sd_g, sd_d = inputs["init_sd_g"], inputs["init_sd_d"]
    if sign:
        sd_g = port_tool.ulp_perturbed(sd_g, a.x64, sign)
        sd_d = port_tool.ulp_perturbed(sd_d, a.x64, sign)
    with jax.enable_x64(a.x64):
        start = time.perf_counter()
        ours = tool.run_ours(sd_g, sd_d, inputs["batches"],
                             inputs["eval_batches"], a)
        seconds = time.perf_counter() - start
        shim = _Shim(ours["gen"], ours["params"])
        wavs = [np.asarray(ar_loop(shim, feats[:a.decode_frames].astype(
                    np.float64 if a.x64 else np.float32), ours["config"]))
                for _, feats in inputs["dev"][:a.n_decode]]
    return dict(logs=ours["logs"], evals=ours["evals"], seconds=seconds,
                wavs=wavs)


def _inputs(a, log):
    inputs = port_tool.make_inputs(a)
    tool = jax_tool(a)
    check_inputs_equal(tool, a, inputs)
    log(f"[cotrain] inputs equal in both packages: {inputs['digests']}")
    return tool, inputs


def _controls(tool, a, inputs, signs, jax_wavs, log):
    """The control runs of ``signs``: (their records, per control its
    decodes' MCDs against ``jax_wavs``)."""
    records, mcds = [], []
    for sign in signs:
        run = jax_leg(tool, a, inputs, sign)
        log(f"[cotrain] JAX from a {sign:+d}-ulp init: "
            f"{run['seconds']:.1f} s")
        records.append({"sign": sign, **{k: run[k] for k in
                                          ("logs", "evals", "seconds")}})
        mcds.append([port_tool.mcd(w, j)
                     for w, j in zip(run["wavs"], jax_wavs)])
    return records, mcds


def _checked(report, a):
    report["checks"] = {}
    report["failures"] = port_tool.check(report, a)
    report["ok"] = not report["failures"]
    return report


def cotrain(a, signs=port_tool.CONTROL_SIGNS, log=lambda msg: None):
    """The JAX leg, its controls (``signs``), the port's CPU leg and the
    decodes of a profile: (report, {npz name: JAX decode})."""
    tool, inputs = _inputs(a, log)
    jax_run = jax_leg(tool, a, inputs)
    log(f"[cotrain] JAX: {a.steps} steps in {jax_run['seconds']:.1f} s")
    controls, control_mcds = _controls(tool, a, inputs, signs,
                                       jax_run["wavs"], log)
    port = port_tool.run_port(inputs["init_sd_g"], inputs["init_sd_d"],
                              inputs["batches"], inputs["eval_batches"], a,
                              "cpu")
    log(f"[cotrain] port (CPU): {port['seconds']:.1f} s")
    port_wavs, _ = port_tool.decode_port(port, inputs["dev"], a)
    report = {
        "profile": a.profile, "config": vars(a), "gen_cfg": inputs["gen_cfg"],
        "disc_cfg": inputs["disc_cfg"], "mel_cfg": port_tool.MEL_CFG,
        "digests": inputs["digests"],
        "jax": {k: jax_run[k] for k in ("logs", "evals", "seconds")},
        "port": {k: port[k] for k in ("logs", "evals", "seconds", "device")},
        "jax_controls": controls,
        "decode": port_tool.decode_records(port_wavs, jax_run["wavs"],
                                           inputs["dev"], control_mcds),
    }
    dt = np.float64 if a.x64 else np.float32
    return _checked(report, a), {f"jax_{i}": w.astype(dt)
                                 for i, w in enumerate(jax_run["wavs"])}


def test_tiny_x64_cotrain_matches_jax():
    """40 float64 steps across the discriminator's start and two LR
    milestones: per-step and eval mel within 1e-9 relative, the trained
    models' decodes within 0.01 dB, the discriminator trained on both
    sides from the same step."""
    torch.set_num_threads(1)
    a = port_tool.profile_args("tiny")
    report, _ = cotrain(a, signs=())
    assert report["ok"], report["failures"]
    c = report["checks"]
    assert c["pre_disc_mel_max_rel"] < 1e-9
    assert c["eval_mel_max_rel"] < 1e-9
    assert c["worst_mcd_port_vs_jax"] < 0.01
    assert c["port_disc_steps"] == c["jax_disc_steps"] == a.steps - 11
    assert len(report["port"]["evals"]) == a.steps // a.eval_every


def _artifact(profile):
    path = port_tool.artifact_path(profile)
    report, decodes = port_tool.load_artifact(path)
    return path, report, decodes


@pytest.mark.parametrize("profile", ARTIFACT_PROFILES)
def test_committed_artifact_is_green(profile):
    """Each committed artifact is a passing run of its profile: at least
    200 steps with the discriminator's start and both milestones strictly
    inside, the JAX decodes beside it, and its checks as ``check`` reads
    them again."""
    _, report, decodes = _artifact(profile)
    assert report["ok"], report["failures"]
    cfg, c = report["config"], report["checks"]
    assert report["profile"] == profile
    assert {k: cfg[k] for k in port_tool.PROFILES[profile]} == \
        port_tool.PROFILES[profile]
    assert cfg["steps"] >= 200
    assert 0 < cfg["disc_start"] < cfg["steps"]
    assert len(cfg["milestones"]) == 2
    assert all(cfg["disc_start"] < m < cfg["steps"]
               for m in cfg["milestones"])
    assert len(report["jax"]["logs"]) == len(report["port"]["logs"]) \
        == cfg["steps"]
    assert [ctrl["sign"] for ctrl in report["jax_controls"]] == \
        list(port_tool.CONTROL_SIGNS)
    assert sorted(decodes) == [f"jax_{i}" for i in range(cfg["n_decode"])]
    assert all(len(w) == cfg["decode_frames"] * port_tool.HOP
               for w in decodes.values())
    assert c["port_disc_steps"] == c["jax_disc_steps"] == \
        cfg["steps"] - cfg["disc_start"] - 1
    again = dict(report, checks={})
    assert port_tool.check(again, port_tool.settings(report)) == []
    assert again["checks"] == c
    if profile == "f64":
        # f64 leaves no room for semantic drift: a hard 0.1 dB budget
        assert c["eval_mel_max_rel"] <= 1e-6
        assert c["worst_mcd_port_vs_jax"] <= 0.1
    else:
        # f32 past the Lyapunov horizon: within twice JAX's own cone
        assert report["disc_cfg"]["scale_discriminator_params"][
            "channels"] == 128
        assert report["gen_cfg"]["channels"] == 512
        for name in ("eval_mel_max_rel", "worst_mcd_port_vs_jax"):
            assert c[name] <= 2 * c[f"{name}_cone"]
            assert c[f"{name}_bound"] <= max(2 * c[f"{name}_cone"], 0.1)
    for name in ("port", "jax"):
        first, last = c[f"{name}_eval_first_last"]
        assert last < cfg["learn_factor"] * first


@pytest.mark.parametrize("profile", ARTIFACT_PROFILES)
def test_artifact_inputs_remade_from_seed(profile):
    """The port remakes each artifact's corpus, batches and weights from
    its seed with numpy alone: the digests the card's run checks."""
    _, report, _ = _artifact(profile)
    inputs = port_tool.make_inputs(port_tool.settings(report))
    assert inputs["digests"] == report["digests"]
    assert inputs["gen_cfg"] == report["gen_cfg"]
    assert inputs["disc_cfg"] == report["disc_cfg"]


def _tiny_report(scale, cone=1.0):
    """A two-step report: the port's eval-mel gap 1e-5 x ``scale`` and
    decode MCD 0.01 x ``scale``; one control's 2e-5 and 0.02 dB x
    ``cone``."""
    logs = [{}, {"mel": 3.0, "disc": 1.0}]
    return {
        "jax": {"logs": logs, "evals": [[1, 4.0], [2, 3.0]]},
        "port": {"logs": logs,
                 "evals": [[1, 4.0], [2, 3.0 * (1 + 1e-5 * scale)]]},
        "jax_controls": [{"sign": 1, "logs": logs,
                          "evals": [[1, 4.0], [2, 3.0 * (1 + 2e-5 * cone)]]}],
        "decode": [{"mcd_port_vs_jax": 0.01 * scale,
                    "mcd_jax_vs_controls": [0.02 * cone],
                    "mcd_port_vs_gt": 10.0, "mcd_jax_vs_gt": 10.1}],
        "checks": {}}


def _tiny_check_args(x64):
    return port_tool.profile_args("tiny", disc_start=0, envelope_pre=1.0,
                                  envelope_eval=1e-3, learn_factor=2.0,
                                  mcd_budget=0.1, self_mcd_factor=2.0,
                                  x64=x64)


@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
def test_check_fails_gap_and_mcd_inflated_together(x64):
    """A port leg whose eval-mel gap and decode MCD grow 1000x together
    fails: the bounds are the budget or the JAX package's own cone, never a
    rate taken from the port's own gap."""
    a = _tiny_check_args(x64)
    report = _tiny_report

    ok = report(1)
    assert port_tool.check(ok, a) == []
    assert ok["checks"]["eval_mel_max_rel_bound"] == 1e-3
    assert ok["checks"]["worst_mcd_port_vs_jax_bound"] == 0.1
    assert ok["checks"]["gt_mcd_delta_per_utt"] == [10.0 - 10.1]
    inflated = report(1000)
    fails = port_tool.check(inflated, a)
    assert any("eval-mel" in f for f in fails), fails
    assert any("MCD" in f for f in fails), fails
    # the bounds stay where the budget and the cone put them
    assert inflated["checks"]["eval_mel_max_rel_bound"] == 1e-3
    assert inflated["checks"]["worst_mcd_port_vs_jax_bound"] == 0.1


@pytest.mark.parametrize("x64", [True, False], ids=["f64", "f32"])
def test_check_cone_widens_float32_bounds_only(x64):
    """Where JAX's own cone is wide (10000x the tiny report's), a gap of
    1000x passes in float32, inside twice the cone, and fails in float64,
    whose bounds are the absolute budgets alone."""
    a = _tiny_check_args(x64)
    report = _tiny_report(1000, cone=10000)
    fails = port_tool.check(report, a)
    c = report["checks"]
    assert c["eval_mel_max_rel_cone"] == pytest.approx(0.2)
    assert c["worst_mcd_port_vs_jax_cone"] == pytest.approx(200.0)
    if x64:
        assert c["eval_mel_max_rel_bound"] == 1e-3
        assert c["worst_mcd_port_vs_jax_bound"] == 0.1
        assert any("eval-mel" in f for f in fails), fails
        assert any("MCD" in f for f in fails), fails
    else:
        assert c["eval_mel_max_rel_bound"] == pytest.approx(0.4)
        assert c["worst_mcd_port_vs_jax_bound"] == pytest.approx(400.0)
        assert fails == []


@pytest.mark.parametrize("disc", ["toy", "e2w"])
def test_numpy_discriminator_round_trips_through_jax(disc):
    """``numpy_msmpd_params``'s state dict loads strictly into the port's
    MSMPD, and JAX's importer reads it back to the same tensors."""
    from articulatory_tpu.utils.torch_import import import_hifigan_msmpd
    from articulatory_tpu_torch.models import build_model
    from articulatory_tpu_torch.utils.numpy_init import numpy_msmpd_params

    dp = port_tool.discriminator_config(port_tool.profile_args(
        "tiny", disc=disc))
    sd = jax_msmpd_to_state_dict(numpy_msmpd_params(dp, 3), dp)
    build_model("HiFiGANMultiScaleMultiPeriodDiscriminator",
                dp).load_state_dict(sd)
    _same_state_dict(jax_msmpd_to_state_dict(import_hifigan_msmpd(sd, dp),
                                             dp), sd, disc)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="write a co-training artifact")
    p.add_argument("--profile", choices=sorted(port_tool.PROFILES),
                   required=True)
    p.add_argument("--out", default=None,
                   help="artifact JSON (default the profile's under "
                        "articulatory_tpu_torch/tools/artifacts/); the JAX "
                        "decodes go to the .npz of the same name")
    p.add_argument("--steps", type=int, default=None,
                   help="override the profile's steps")
    p.add_argument("--milestones", type=int, nargs=2, default=None,
                   help="override the profile's two LR milestones")
    args = p.parse_args(argv)
    overrides = {k: v for k, v in (("steps", args.steps),
                                   ("milestones", args.milestones))
                 if v is not None}
    a = port_tool.profile_args(args.profile, **overrides)
    out = args.out or port_tool.artifact_path(args.profile)
    log = lambda msg: print(msg, flush=True)  # noqa: E731
    start = time.perf_counter()
    report, decodes = cotrain(a, log=log)
    report["seconds"] = time.perf_counter() - start
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    np.savez_compressed(os.path.splitext(out)[0] + ".npz", **decodes)
    print(f"[cotrain] wrote {out} in {time.perf_counter() - start:.1f} s")
    print(json.dumps(port_tool.summary(report)))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
