#!/usr/bin/env python3
"""Long-horizon co-training parity of the port against the JAX package.

The port's GAN step (``train/gan.py::make_train_step``, its optimizers and
host schedulers) trains from the same initial weights on the same batches
of a learnable synthetic EMA-to-wave corpus as the JAX package's
``tools/cotrain_parity.py::run_ours``, for hundreds of steps, with the
phase changes firing inside the run: ``discriminator_train_start_steps``
flips, and two MultiStepLR milestones halve both learning rates. Then the
held-out utterances are decoded with the trained generator
(``inference.py::ar_loop``) and scored by MCD (``eval/mcd.py``) against
the JAX package's decodes of its own trained model.

Everything the run starts from is made with numpy from the profile's seed:
the corpus and batches (``tools/make_synth_corpus.py::build_corpus``,
``sample_batches``) and the weights (``utils/numpy_init.py``, carried into
the reference's state dicts by ``utils/weights.py``). A machine without
JAX so remakes them bit for bit, and their sha256 digests prove it.

The JAX side of a run is in a committed artifact
(``tools/artifacts/cotrain_<profile>.json`` beside this file, and its
decodes in the ``.npz`` of the same name): its per-step losses, its eval-mel
trajectory, and runs of JAX against itself from inits perturbed by +1,
-1, +2 and -2 ulp (the controls, CONTROL_SIGNS), whose largest gap from
the JAX run is the JAX package's own noise cone. The artifact is
written on the CPU by the script form of
``tests/test_torch_port_cotrain.py``, the one place that imports both
packages. ``check`` bounds each float32 reading by an absolute budget or
by ``self_mcd_factor`` x that cone, whichever is larger, and each float64
reading by its budget alone; no bound scales with the port's own gap.

Re-run the port leg of an artifact on the card (or ``--device cpu``)::

    python -m articulatory_tpu_torch.tools.cotrain_parity \\
        --against articulatory_tpu_torch/tools/artifacts/cotrain_f32_wide.json

and re-run the checks of a saved artifact::

    python -m articulatory_tpu_torch.tools.cotrain_parity --recheck <json>

This profile's models draw nothing at random in a step (no noise input,
no random windows, no dropout), so the step's ``RandomDraws`` go unused.
"""

from __future__ import annotations

import argparse
import copy
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ARTIFACTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "artifacts")
E2W_CONF = os.path.join(ROOT, "egs", "ema", "voc1", "conf",
                        "e2w_hifigan_car.yaml")

SR = 16000
HOP = 80
N_FEATS = 13

# the JAX package's profile (tools/cotrain_parity.py)
GEN_CFG = dict(in_channels=N_FEATS + 8, out_channels=1, channels=16,
               kernel_size=7, upsample_scales=[5, 4, 2, 2],
               upsample_kernel_sizes=[10, 8, 4, 4],
               resblock_kernel_sizes=[3], resblock_dilations=[[1, 3]],
               use_ar=True, ar_input=64, ar_hidden=8, ar_output=8)
DISC_CFG = dict(
    scales=2,
    scale_discriminator_params={"channels": 16, "max_downsample_channels": 32,
                                "max_groups": 4,
                                "downsample_scales": [2, 2, 4, 4, 1]},
    periods=[2, 3],
    period_discriminator_params={"channels": 4, "max_downsample_channels": 16,
                                 "downsample_scales": [3, 3, 3, 3, 1]},
    follow_official_norm=False)
MEL_CFG = dict(fs=SR, fft_size=512, hop_size=128, win_length=None,
               window="hann", num_mels=40, fmin=0, fmax=8000, log_base=None)

LAMBDA_AUX, LAMBDA_ADV, LAMBDA_FM = 45.0, 1.0, 2.0
BETAS = (0.5, 0.9)

# the JAX tool's defaults; ``disc`` names the discriminator: "toy" is
# DISC_CFG, "e2w" the recipe's (E2W_CONF's discriminator_params), whose
# 128-channel scale head runs the head kernel on the card
DEFAULTS = dict(
    steps=400, gen_start=0, disc_start=150, milestones=[200, 300],
    gamma=0.5, lr=1e-4, gen_grad_norm=10.0, disc_grad_norm=-1.0,
    batch_size=4, batch_max_steps=4800, eval_every=20, n_train_utts=24,
    n_dev_utts=6, n_eval_batches=2, n_decode=3, decode_frames=300, seed=0,
    envelope_pre=0.02, envelope_eval=0.15, learn_factor=0.7,
    mcd_budget=0.1, self_mcd_factor=2.0, x64=False, channels=None,
    full_mrf=False, ar_input=None, ar_hidden=None, ar_output=None,
    disc="toy")
# f64: tools/artifacts/cotrain_parity.json's profile, where float rounding
# is ~1e-16 an op and any visible gap is a semantic difference; f32-wide:
# the e2w_hifigan_car generator at full width and its discriminator, at
# the flagship lr (chaotic past a few hundred steps: the JAX package's own
# noise cone is the yardstick); tiny: the tier-1 test's x64 horizon
PROFILES = {
    "f64": dict(steps=200, disc_start=100, milestones=[150, 175], lr=2e-5,
                batch_size=4, batch_max_steps=2400, eval_every=20,
                envelope_pre=1e-6, envelope_eval=1e-6, learn_factor=0.98,
                x64=True),
    "f32-wide": dict(steps=300, disc_start=100, milestones=[150, 225],
                     lr=1e-4, batch_size=2, batch_max_steps=2000,
                     eval_every=25, n_train_utts=16, n_dev_utts=4,
                     envelope_pre=0.02, envelope_eval=0.02, learn_factor=0.9,
                     channels=512, full_mrf=True, ar_input=512,
                     ar_hidden=256, ar_output=128, disc="e2w"),
    "tiny": dict(steps=40, disc_start=10, milestones=[15, 25], eval_every=10,
                 n_train_utts=6, n_dev_utts=2, n_eval_batches=1, n_decode=1,
                 decode_frames=120, batch_size=2, batch_max_steps=2400,
                 envelope_pre=1e-9, envelope_eval=1e-9, learn_factor=1.05,
                 mcd_budget=0.01, x64=True),
}
INIT_SEEDS = (1000, 1001)  # added to the seed: generator, discriminator
# the controls: JAX from its init times (1 + sign ulp); past the Lyapunov
# horizon each gap is a noisy draw, so the cone is the largest of four
CONTROL_SIGNS = (1, -1, 2, -2)


def profile_args(name: str, **overrides) -> argparse.Namespace:
    """The run's settings: DEFAULTS, then the profile's, then overrides."""
    return argparse.Namespace(**{**DEFAULTS, **PROFILES[name], **overrides,
                                 "profile": name})


def generator_config(a) -> dict:
    """GEN_CFG with the JAX tool's width overrides (its ``main``)."""
    gp = copy.deepcopy(GEN_CFG)
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
        # the AR-context vector is concatenated onto the features
        gp["in_channels"] = N_FEATS + a.ar_output
    return gp


def discriminator_config(a) -> dict:
    if a.disc == "toy":
        return copy.deepcopy(DISC_CFG)
    if a.disc == "e2w":
        from articulatory_tpu_torch.config import load_config

        return load_config(E2W_CONF)["discriminator_params"]
    raise ValueError(f"unknown discriminator {a.disc!r}")


def train_config(a, gp: dict, dp: dict) -> dict:
    """The experiment config of both packages' steps (the JAX tool's, with
    the discriminator's params beside)."""
    return {
        "dataset_mode": "a2w", "batch_max_steps": a.batch_max_steps,
        "hop_size": HOP, "sampling_rate": SR,
        "use_stft_loss": False, "use_mel_loss": True,
        "mel_loss_params": dict(MEL_CFG), "use_feat_match_loss": True,
        "feat_match_loss_params": {"average_by_discriminators": False,
                                   "average_by_layers": False},
        "generator_adv_loss_params": {"average_by_discriminators": False},
        "discriminator_adv_loss_params": {"average_by_discriminators": False},
        "lambda_aux": LAMBDA_AUX, "lambda_adv": LAMBDA_ADV,
        "lambda_feat_match": LAMBDA_FM,
        "generator_train_start_steps": a.gen_start,
        "discriminator_train_start_steps": a.disc_start,
        "generator_params": dict(gp), "discriminator_params": dict(dp),
    }


def init_state_dicts(a, gp: dict, dp: dict) -> tuple[dict, dict]:
    """The reference-named initial state dicts of both models, float32,
    from the seed (``utils/numpy_init.py``)."""
    from articulatory_tpu_torch.utils.numpy_init import (
        numpy_generator_params,
        numpy_msmpd_params,
    )
    from articulatory_tpu_torch.utils.weights import (
        jax_msmpd_to_state_dict,
        jax_params_to_state_dict,
    )

    return (jax_params_to_state_dict(
                numpy_generator_params(gp, a.seed + INIT_SEEDS[0]), gp),
            jax_msmpd_to_state_dict(
                numpy_msmpd_params(dp, a.seed + INIT_SEEDS[1]), dp))


def ulp_perturbed(sd: dict, x64: bool, sign: int = 1) -> dict:
    """Every weight times (1 + sign ulp) in its own dtype (the factor is
    exact in both): a change of the weights' last bits, whose growth is a
    package's own noise cone."""
    ulp = 2.0 ** -52 if x64 else 2.0 ** -23
    return {k: v * (1.0 + sign * ulp) for k, v in sd.items()}


def cast(sd: dict, dtype: torch.dtype) -> dict:
    return {k: v.to(dtype) for k, v in sd.items()}


def digest_state_dict(sd: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(sd):
        v = sd[k].detach().cpu().contiguous()
        h.update(f"{k}/{v.dtype}/{tuple(v.shape)}".encode())
        h.update(v.numpy().tobytes())
    return h.hexdigest()


def digest_arrays(batches) -> str:
    h = hashlib.sha256()
    for batch in batches:
        for x in batch:
            x = np.ascontiguousarray(x)
            h.update(f"{x.dtype}/{x.shape}".encode())
            h.update(x.tobytes())
    return h.hexdigest()


def make_inputs(a) -> dict:
    """Everything a run starts from, and its digests: the model configs,
    the corpus, the training and evaluation batches, and the initial state
    dicts in the run's dtype."""
    from articulatory_tpu_torch.tools.make_synth_corpus import (
        build_corpus,
        sample_batches,
    )

    gp, dp = generator_config(a), discriminator_config(a)
    win_frames = a.batch_max_steps // HOP
    dt = np.float64 if a.x64 else np.float32
    train, dev = build_corpus(a.n_train_utts, a.n_dev_utts, a.seed)
    batches = sample_batches(train, a.steps, a.batch_size, win_frames,
                             gp["ar_input"], a.seed, dtype=dt)
    eval_batches = sample_batches(dev, a.n_eval_batches, a.batch_size,
                                  win_frames, gp["ar_input"], a.seed + 7,
                                  dtype=dt)
    sd_g, sd_d = init_state_dicts(a, gp, dp)
    dtype = torch.float64 if a.x64 else torch.float32
    sd_g, sd_d = cast(sd_g, dtype), cast(sd_d, dtype)
    digests = {"init_g": digest_state_dict(sd_g),
               "init_d": digest_state_dict(sd_d),
               "batches": digest_arrays(batches),
               "eval_batches": digest_arrays(eval_batches),
               "corpus": digest_arrays(train + dev)}
    return dict(gen_cfg=gp, disc_cfg=dp, train=train, dev=dev,
                batches=batches,
                eval_batches=eval_batches, init_sd_g=sd_g, init_sd_d=sd_d,
                digests=digests)


def launch_counts() -> dict:
    """The hand kernels' launch counts so far (chip_smoke's
    ``read_counts`` form)."""
    from articulatory_tpu_torch.ops import resblock_pair as pair
    from articulatory_tpu_torch.ops import scale_disc_head as head

    return {"resblock_pair": dict(pair.resblock_pair.launches_by_dtype),
            "scale_disc_head": dict(head.scale_disc_head.launches_by_dtype),
            "split_tf32": pair.split_tf32.launches,
            "split_weights": head.split_weights.launches}


def _add_counts(total: dict, after: dict, before: dict) -> None:
    for key, value in after.items():
        if isinstance(value, dict):
            for dtype, n in value.items():
                d = n - before[key].get(dtype, 0)
                if d:
                    total[key][dtype] = total[key].get(dtype, 0) + d
        else:
            total[key] += value - before[key]


def _no_counts() -> dict:
    return {"resblock_pair": {}, "scale_disc_head": {}, "split_tf32": 0,
            "split_weights": 0}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_port(init_sd_g, init_sd_d, batches, eval_batches, a,
             device=None) -> dict:
    """The port's stack on ``device`` (default ``cuda``), step for step as
    the JAX tool's ``run_ours``:
    ``make_train_step`` with ``steps > gen_start`` / ``steps >
    disc_start`` gating inside the step, each host scheduler stepping in
    its gated branch, and the held-out mel loss every ``eval_every`` steps.
    The hand kernels' launches are counted apart for the training steps
    and the evaluations."""
    from articulatory_tpu_torch.models import build_model
    from articulatory_tpu_torch.train import gan
    from articulatory_tpu_torch.train.optimizers import build_optimizer
    from articulatory_tpu_torch.train.schedulers import build_scheduler
    from articulatory_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    gp, dp = generator_config(a), discriminator_config(a)
    config = train_config(a, gp, dp)
    dtype = torch.float64 if a.x64 else torch.float32
    gen = build_model("HiFiGANGenerator", gp)
    disc = build_model("HiFiGANMultiScaleMultiPeriodDiscriminator", dp)
    gen.load_state_dict(init_sd_g)
    disc.load_state_dict(init_sd_d)
    gen.to(device=device, dtype=dtype).train()
    disc.to(device=device, dtype=dtype).train()
    state = gan.GANTrainState(
        generator=gen, discriminator=disc,
        opt_g=build_optimizer("Adam", {"betas": list(BETAS)},
                              a.gen_grad_norm, gen.parameters()),
        opt_d=build_optimizer("Adam", {"betas": list(BETAS)},
                              a.disc_grad_norm, disc.parameters()),
        draws=gan.RandomDraws(a.seed))
    crit = gan.GANCriterion(config)
    step = gan.make_train_step(crit, config)
    sched = {"milestones": list(a.milestones), "gamma": a.gamma}
    sched_g = build_scheduler("MultiStepLR", a.lr, sched)
    sched_d = build_scheduler("MultiStepLR", a.lr, sched)

    def tensors(b):
        return tuple(torch.from_numpy(np.asarray(x)).to(device) for x in b)

    dev_batches = [tensors(b) for b in eval_batches]

    @torch.no_grad()
    def eval_mel() -> float:
        gen.eval()
        losses = [float(crit.mel_loss(gen(x, ar=ar), y))
                  for x, y, ar in dev_batches]
        gen.train()
        return float(np.mean(losses))

    launches = {"train": _no_counts(), "eval": _no_counts()}
    steps = 0
    raw_logs, evals = [], []
    _sync(device)
    t_start = time.perf_counter()
    for i, b in enumerate(batches):
        if i and i % 50 == 0:
            print(f"[cotrain]   port step {i}/{len(batches)} "
                  f"({time.perf_counter() - t_start:.0f}s)", flush=True)
        x, y, ar = tensors(b)
        before = launch_counts()
        m = step(state, {"x": (x,), "y": y, "ar": ar}, sched_g.lr, sched_d.lr)
        _add_counts(launches["train"], launch_counts(), before)
        rec = {}
        if steps > a.gen_start:
            rec["gen"] = m["train/generator_loss"]
            rec["mel"] = m["train/mel_loss"]
            sched_g.step(None)
        if steps > a.disc_start:
            rec["disc"] = m["train/discriminator_loss"]
            sched_d.step(None)
        steps += 1
        raw_logs.append(rec)
        if steps % a.eval_every == 0:
            before = launch_counts()
            evals.append([steps, eval_mel()])
            _add_counts(launches["eval"], launch_counts(), before)
    _sync(device)
    seconds = time.perf_counter() - t_start
    logs = [{k: float(v) for k, v in rec.items()} for rec in raw_logs]
    gen.eval()
    return dict(gen=gen, config=config, logs=logs, evals=evals,
                seconds=seconds, launches=launches, device=str(device))


def decode_port(port: dict, dev, a) -> tuple[list[np.ndarray], dict]:
    """The trained generator's decodes of the first ``n_decode`` held-out
    utterances (``decode_frames`` frames each) through ``ar_loop``, and the
    hand kernels' launches in them."""
    from articulatory_tpu_torch.inference import LoadedModel, ar_loop

    gen = port["gen"]
    model = LoadedModel(model=gen, config=port["config"],
                        device=next(gen.parameters()).device)
    before, launches = launch_counts(), _no_counts()
    outs = []
    for _, feats in dev[:a.n_decode]:
        x = feats[:a.decode_frames].astype(
            np.float64 if a.x64 else np.float32)
        outs.append(np.asarray(ar_loop(model, x, port["config"])))
    _add_counts(launches, launch_counts(), before)
    return outs, launches


def mcd(a_wav: np.ndarray, b_wav: np.ndarray) -> float:
    """The harness's MCD: fft 512, hop 128, c0 excluded, no DTW."""
    from articulatory_tpu_torch.eval.mcd import mel_cepstral_distortion

    return float(mel_cepstral_distortion(
        np.squeeze(a_wav), np.squeeze(b_wav), SR, fft_size=512,
        hop_size=128))


def decode_records(port_wavs, jax_wavs, dev, control_mcds=None) -> list:
    """Per utterance: MCD(port, JAX) and each side's MCD to the ground
    truth; ``control_mcds`` a list per control of its decodes' MCDs
    against JAX's (the JAX package's own decode cone)."""
    recs = []
    for i, (yp, yj) in enumerate(zip(port_wavs, jax_wavs)):
        if np.shape(yp) != np.shape(yj):
            raise AssertionError(f"decode {i}: port {np.shape(yp)} against "
                                 f"JAX {np.shape(yj)}")
        gt = dev[i][0][:len(yj)]
        rec = {"mcd_port_vs_jax": mcd(yp, yj), "mcd_port_vs_gt": mcd(yp, gt),
               "mcd_jax_vs_gt": mcd(yj, gt)}
        if control_mcds:
            rec["mcd_jax_vs_controls"] = [float(c[i]) for c in control_mcds]
        recs.append(rec)
    return recs


def _rel(pairs) -> list[float]:
    return [abs(o - r) / max(abs(r), 1e-9) for o, r in pairs]


def _pre_disc(side: dict, ref: dict, disc_start: int, n: int) -> list:
    return _rel((o["mel"], r["mel"]) for i, (o, r) in
                enumerate(zip(side["logs"][:n], ref["logs"][:n]))
                if "mel" in o and "mel" in r and i <= disc_start)


def _eval_gaps(side: dict, ref: dict, n: int) -> list:
    pairs = []
    for (s_o, e_o), (s_r, e_r) in zip(side["evals"], ref["evals"]):
        if s_o != s_r:
            raise AssertionError(f"eval steps differ: {s_o} against {s_r}")
        if s_o <= n:
            pairs.append((e_o, e_r))
    return _rel(pairs)


def check(report: dict, a) -> list[str]:
    """The acceptance checks of a run (the JAX tool's ``check``, with
    the port in its place); returns the failures. Each reading stands in
    ``report["checks"]`` beside its bound, and the JAX package's own
    reading (the cone: the largest over the report's ``jax_controls``)
    where it has controls. In float32 a bound is ``max(budget,
    self_mcd_factor x cone)``; in float64 (``a.x64``), where rounding
    leaves no room for drift, it is the budget alone. No bound reads the
    port's own gaps. A run shorter than the JAX side's is held over its
    own steps, against the cone's over the same steps; it has no learning
    or decode checks."""
    fails = []
    c = report["checks"]
    jax, port = report["jax"], report["port"]
    controls = report.get("jax_controls") or []
    n = len(port["logs"])
    truncated = n < len(jax["logs"])
    factor = a.self_mcd_factor

    def bounded(name, reading, cone_reading, budget, what):
        bound = (budget if cone_reading is None or a.x64
                 else max(budget, factor * cone_reading))
        c[name], c[f"{name}_bound"] = reading, bound
        if controls:
            c[f"{name}_cone"] = cone_reading
        if reading is not None and reading > bound:
            fails.append(f"{what}: {reading:.4g} > bound {bound:.4g} "
                         f"(budget {budget:.4g}, JAX's own cone "
                         f"{cone_reading})")

    # 1. the regression phase before the discriminator: per-step mel
    pre = _pre_disc(port, jax, a.disc_start, n)
    pre_cone = [g for ctrl in controls
                for g in _pre_disc(ctrl, jax, a.disc_start, n)]
    bounded("pre_disc_mel_max_rel", max(pre) if pre else None,
            max(pre_cone) if pre_cone else None, a.envelope_pre,
            "pre-disc mel tracking, max rel diff")

    # 2. the held-out mel trajectory
    gaps = _eval_gaps(port, jax, n)
    gap_cone = [g for ctrl in controls for g in _eval_gaps(ctrl, jax, n)]
    bounded("eval_mel_max_rel", max(gaps) if gaps else None,
            max(gap_cone) if gap_cone else None, a.envelope_eval,
            "eval-mel trajectory, max rel diff")

    # 3. the discriminator phase fired on both sides
    if n > a.disc_start + 1:
        for name, side in (("port", port), ("jax", jax)):
            fired = sum("disc" in r for r in side["logs"][:n])
            c[f"{name}_disc_steps"] = fired
            if fired != n - a.disc_start - 1:
                fails.append(f"{name}: the discriminator trained {fired} "
                             f"steps of {n}, not from step "
                             f"{a.disc_start + 1} on")

    if truncated:
        return fails
    # 4. both stacks learn
    for name, side in (("port", port), ("jax", jax)):
        if not side["evals"]:
            fails.append(f"{name}: no evaluation in the run")
            continue
        first, last = side["evals"][0][1], side["evals"][-1][1]
        c[f"{name}_eval_first_last"] = [first, last]
        if not last < a.learn_factor * first:
            fails.append(f"{name} did not learn: eval mel {first:.4f} -> "
                         f"{last:.4f} (need < {a.learn_factor}x)")

    # 5. the trained models' decodes: MCD(port, JAX) inside the budget or
    # (float32) the JAX package's own decode cone
    decode = report.get("decode") or []
    if not decode:
        fails.append("no decodes")
        return fails
    cones = [m for r in decode for m in r.get("mcd_jax_vs_controls", [])]
    bounded("worst_mcd_port_vs_jax",
            max(r["mcd_port_vs_jax"] for r in decode),
            max(cones) if cones else None, a.mcd_budget,
            "trained-model MCD(port, JAX) dB")
    # trained-model quality: per utterance MCD(port, gt) - MCD(JAX, gt),
    # recorded, not held
    c["gt_mcd_delta_per_utt"] = [r["mcd_port_vs_gt"] - r["mcd_jax_vs_gt"]
                                 for r in decode]
    return fails


def artifact_path(profile: str) -> str:
    return os.path.join(ARTIFACTS,
                        f"cotrain_{profile.replace('-', '_')}.json")


def load_artifact(path: str) -> tuple[dict, dict]:
    """An artifact's report and the JAX decodes of its ``.npz``."""
    with open(path) as f:
        report = json.load(f)
    with np.load(os.path.splitext(path)[0] + ".npz") as z:
        decodes = {k: z[k] for k in z.files}
    return report, decodes


def settings(report: dict, **overrides) -> argparse.Namespace:
    """A saved run's settings (its profile's keys only)."""
    keys = set(DEFAULTS) | {"profile"}
    return argparse.Namespace(**{**{k: v for k, v in report["config"].items()
                                    if k in keys}, **overrides})


def against(path: str, device="cuda", steps: int | None = None) -> dict:
    """The port leg of a committed artifact on ``device``: the inputs
    remade from its seed (their digests must equal the artifact's), the
    run (its first ``steps`` steps, default all), the decodes against the
    JAX decodes, and ``check`` against the JAX side stored there. Returns
    the report (``ok``, ``failures``, ``checks``, the port's launches)."""
    saved, decodes = load_artifact(path)
    a = settings(saved)
    t0 = time.perf_counter()
    inputs = make_inputs(a)
    setup_s = time.perf_counter() - t0
    mismatched = [k for k, v in saved["digests"].items()
                  if inputs["digests"].get(k) != v]
    if mismatched or inputs["gen_cfg"] != saved["gen_cfg"] \
            or inputs["disc_cfg"] != saved["disc_cfg"]:
        raise AssertionError(f"{path}: the inputs remade from seed {a.seed} "
                             f"are not the artifact's (digests "
                             f"{mismatched}, or the model configs)")
    n = a.steps if steps is None else min(steps, a.steps)
    port = run_port(inputs["init_sd_g"], inputs["init_sd_d"],
                    inputs["batches"][:n], inputs["eval_batches"], a, device)
    report = {k: saved[k] for k in ("profile", "config", "gen_cfg",
                                    "disc_cfg", "mel_cfg", "digests", "jax",
                                    "jax_controls") if k in saved}
    report["port"] = {k: port[k] for k in ("logs", "evals", "seconds",
                                           "launches", "device")}
    report["setup_seconds"] = setup_s
    report["checks"] = {}
    if n == a.steps:
        t0 = time.perf_counter()
        wavs, report["port"]["launches"]["decode"] = decode_port(
            port, inputs["dev"], a)
        report["port"]["decode_seconds"] = time.perf_counter() - t0
        jax_wavs = [decodes[f"jax_{i}"] for i in range(len(wavs))]
        controls = [[r["mcd_jax_vs_controls"][k] for r in saved["decode"]]
                    for k in range(len(saved.get("jax_controls", [])))]
        report["decode"] = decode_records(wavs, jax_wavs, inputs["dev"],
                                          controls)
    fails = check(report, a)
    report["failures"] = fails
    report["ok"] = not fails
    return report


def summary(report: dict) -> dict:
    return {"ok": report["ok"], "failures": report["failures"],
            **report["checks"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--against", metavar="ARTIFACT",
                      help="re-run the port leg of a committed artifact "
                           "and check it against the JAX side stored there")
    mode.add_argument("--recheck", metavar="ARTIFACT",
                      help="re-run the checks of a saved artifact and "
                           "rewrite its checks, failures and ok")
    p.add_argument("--device", default="cuda",
                   help="the port leg's device (cuda, or cpu)")
    p.add_argument("--steps", type=int, default=None,
                   help="run only the first N steps (no decode)")
    p.add_argument("--out", default=None,
                   help="write the --against report here as JSON")
    args = p.parse_args(argv)

    if args.recheck:
        with open(args.recheck) as f:
            report = json.load(f)
        report["checks"] = {}
        report["failures"] = check(report, settings(report))
        report["ok"] = not report["failures"]
        with open(args.recheck, "w") as f:
            json.dump(report, f, indent=1)
        print(json.dumps(summary(report)))
        return 0 if report["ok"] else 1

    report = against(args.against, args.device, args.steps)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(summary(report)))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
