"""The port's entry points and recipe script against the JAX package's, on
the CPU:

- ``utils/run_jobs.py`` beside ``articulatory_tpu/utils/run_jobs.py`` over
  the cases of ``tests/test_run_jobs_backends.py``: the parsed arguments,
  the slurm and sge submissions (with and without a queue config) and the
  array scripts are equal, and the local backend's exit codes and
  concurrency cap agree; importing the port's module loads no ``h5py``;
- ``bin/predict_wav.py`` against ``egs/ema/voc1/local/predict_wav.py`` on
  one msgpack of the tiny HiFi-CAR of ``tests/test_predict_wav.py``: the
  same wavs (an utterance of 250 frames or fewer skipped), each within 1
  int16 LSB of the JAX script's and of the port's own ``ar_loop``, and the
  same parameter count;
- ``bin/model_stats.py``: the parameter count JAX's prints, for the
  HiFi-CAR and MelGAN;
- ``bin/convert_checkpoint.py --to-torch``: the pickle equals JAX's
  ``export_checkpoint`` key for key and array for array (atol 0), for the
  HiFi-CAR with its MSMPD, the BiGRU and MelGAN, and ``load_model``
  decodes it as it decodes the msgpack; the default direction raises for
  a generator with no importer;
- ``recipe/run.sh``: stages 1-3 with ``--device cpu`` through the local
  backend on a tiny synthetic corpus in a recipe directory's layout write
  the dumps, the statistics, the checkpoint and the wavs."""

import functools
import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import flax.serialization
import jax
import jax.numpy as jnp
from scipy.io import wavfile

from articulatory_tpu import models as jax_models
from articulatory_tpu.utils import run_jobs as jax_run_jobs
from articulatory_tpu.utils.torch_export import export_checkpoint
from articulatory_tpu_torch import inference
from articulatory_tpu_torch.bin import convert_checkpoint, model_stats
from articulatory_tpu_torch.bin import predict_wav
from articulatory_tpu_torch.utils import run_jobs

torch.set_num_threads(1)
# JAX's programs compiled at XLA's lowest backend optimisation level, as
# in tests/test_torch_port_cond_train.py
_jit = functools.partial(jax.jit, compiler_options={
    "xla_backend_optimization_level": 0,
    "xla_llvm_disable_expensive_passes": True})
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = (jax_run_jobs, run_jobs)

# --- run_jobs ---------------------------------------------------------------

PARSE_CASES = {
    "array_and_options": ["--backend", "slurm", "--mem", "4G", "--time",
                          "12:00:00", "--num-threads", "2", "--gpu", "1",
                          "--max-jobs-run", "5", "JOB=1:10", "log/x.JOB.log",
                          "echo", "JOB"],
    "options_after_positional": ["JOB=1:2", "log/x.JOB.log", "python",
                                 "train.py", "--gpu", "2", "--time", "10:00"],
    "single_job": ["--backend=local", "log/x.log", "true"],
    "env_backend": ["JOB=1:2", "log/x.JOB.log", "true"],
    "explicit_beats_env": ["--backend", "local", "JOB=1:2", "log/x.JOB.log",
                           "true"],
}


@pytest.mark.parametrize("case", sorted(PARSE_CASES))
def test_run_jobs_parse_matches_jax(case, monkeypatch):
    monkeypatch.setenv("RUN_JOBS_BACKEND", "sge")
    (jopts, *jrest), (opts, *rest) = (m.parse_args(PARSE_CASES[case])
                                      for m in MODULES)
    assert vars(opts) == vars(jopts) and rest == jrest
    if case == "env_backend":
        assert opts.backend == "sge"


@pytest.mark.parametrize("argv", [[], ["--backend", "slurm"], ["JOB=1:2"],
                                  ["JOB=1:2", "log/x.JOB.log"],
                                  ["log/x.log"], ["--mem"]])
def test_run_jobs_usage_errors_match_jax(argv):
    for module in MODULES:
        with pytest.raises(SystemExit):
            module.parse_args(argv)


QUEUE_CONFIGS = {
    "slurm": "command sbatch --export=PATH --ntasks-per-node=1\n"
             "option mem=* --mem-per-cpu $0\noption time=* --time $0\n"
             "option num_threads=* --cpus-per-task $0\n"
             "default gpu=0\noption gpu=0 -p cpu\n"
             "option gpu=* -p gpu --gres=gpu:$0\n",
    "sge": "command qsub -V\noption mem=* -l mem_free=$0\n"
           "option time=* -l h_rt=$0\noption num_threads=* -pe smp $0\n"
           "option gpu=* -l gpu=$0\n"}


@pytest.mark.parametrize("with_config", [False, True])
@pytest.mark.parametrize("backend", ["slurm", "sge"])
def test_run_jobs_submission_matches_jax(backend, with_config, tmp_path):
    argv = ["--backend", backend, "--mem", "2G", "--time", "01:00:00",
            "--num-threads", "2", "--gpu", "1", "--max-jobs-run", "3"]
    if with_config:
        conf = tmp_path / f"{backend}.conf"
        conf.write_text(QUEUE_CONFIGS[backend])
        argv += ["--config", str(conf)]
    argv += ["JOB=2:6", "log/n.JOB.log", "python3", "-c",
             "print('job JOB ok')", "--tag", ""]
    subs = []
    for module in MODULES:
        opts, lo, hi, logpat, cmd = module.parse_args(argv)
        subs.append(module.build_submission(backend, lo, hi, logpat, cmd,
                                            opts))
    assert subs[0] == subs[1]
    assert subs[1][0][-1] == "__SCRIPT__"
    for module in MODULES:
        with pytest.raises(ValueError):
            module.build_submission("local", 1, 2, "l.JOB", ["true"], opts)


@pytest.mark.parametrize("cmd,want", [
    (["python3", "-c", "print('job JOB ok')"], "job 7 ok"),
    (["python3", "-c", "import sys; print(repr(sys.argv[1:]))", "--tag", "",
      "JOB"], "['--tag', '', '7']")], ids=["quoted_job", "empty_arg"])
def test_run_jobs_array_script_matches_jax(cmd, want, tmp_path):
    scripts = [m._array_script(cmd, "SLURM_ARRAY_TASK_ID") for m in MODULES]
    assert scripts[0] == scripts[1]
    path = tmp_path / "array.sh"
    path.write_text(scripts[1])
    out = subprocess.run(["bash", str(path)], capture_output=True, text=True,
                         env={**os.environ, "SLURM_ARRAY_TASK_ID": "7"})
    assert out.returncode == 0 and out.stdout.strip() == want


@pytest.mark.parametrize("case", ["ok", "fails", "capped"])
def test_run_jobs_local_matches_jax(case, tmp_path):
    if case == "capped":  # a job fails if it sees another's lock file
        locks = tmp_path / "locks"
        locks.mkdir()
        cmd = ["bash", "-c", f'test -z "$(ls -A {locks})" || exit 1; '
               f'touch {locks}/l.JOB; sleep 0.1; rm {locks}/l.JOB']
        for module in MODULES:
            assert module._run_local(1, 3, str(tmp_path / "c.JOB.log"), cmd,
                                     max_jobs_run=1) == []
        return
    code = "sys.exit(0)" if case == "ok" else "sys.exit(0 if 'JOB'=='1' else 1)"
    rcs = []
    for name, module in (("jax", "articulatory_tpu.utils.run_jobs"),
                         ("port", "articulatory_tpu_torch.utils.run_jobs")):
        logpat = str(tmp_path / name / "job.JOB.log")
        rcs.append(subprocess.call(
            [sys.executable, "-m", module, "JOB=1:3", logpat, "python3", "-c",
             f"import sys; print('job JOB ok'); {code}"], cwd=ROOT))
        for j in (1, 2, 3):
            text = open(logpat.replace("JOB", str(j))).read()
            assert f"job {j} ok" in text
    assert rcs[0] == rcs[1] and (rcs[1] == 0) == (case == "ok")


def test_run_jobs_imports_no_h5py():
    out = subprocess.run(
        [sys.executable, "-c", "import sys, articulatory_tpu_torch.utils."
         "run_jobs; print('h5py' in sys.modules, 'jax' in sys.modules and "
         "'articulatory_tpu.utils' in sys.modules)"],
        capture_output=True, text=True, cwd=ROOT)
    assert out.returncode == 0 and out.stdout.split() == ["False", "False"]


# --- predict_wav and model_stats --------------------------------------------

GP = {"in_channels": 13 + 8, "out_channels": 1, "channels": 16,
      "kernel_size": 7, "upsample_scales": [5, 4, 2, 2],
      "upsample_kernel_sizes": [10, 8, 4, 4], "resblock_kernel_sizes": [3],
      "resblock_dilations": [[1, 3]], "use_ar": True, "ar_input": 64,
      "ar_hidden": 8, "ar_output": 8}
CONFIG = {"sampling_rate": 16000, "hop_size": 80, "batch_max_steps": 800,
          "dataset_mode": "a2w", "format": "npy",
          "generator_type": "HiFiGANGenerator", "generator_params": GP}


def _tuples(v):
    if isinstance(v, list):
        return tuple(_tuples(x) for x in v)
    if isinstance(v, dict):
        return {k: _tuples(x) for k, x in v.items()}
    return v


def _init(gen_type, gp, *inputs, **kwargs):
    module = jax_models.build_model(gen_type, _tuples(gp))
    return jax.device_get(_jit(lambda k: module.init(
        k, *inputs, **kwargs))(jax.random.PRNGKey(0)))


def _write(path, payload):
    with open(path, "wb") as f:
        f.write(flax.serialization.msgpack_serialize(payload))
    return str(path)


def _script(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT,
                                                                     path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_predict_wav_matches_jax_script(tmp_path, monkeypatch, capsys):
    params = _init("HiFiGANGenerator", GP, jnp.zeros((1, 10, 13)),
                   ar=jnp.zeros((1, 64, 1)))["params"]
    ckpt = _write(tmp_path / "ckpt.pkl", {"model": {"generator": params},
                                          "steps": 0})
    cfg = tmp_path / "config.yml"
    cfg.write_text(yaml.dump(CONFIG))
    rng = np.random.default_rng(0)
    feats = {"long": 300, "short": 250, "longer": 420}
    lines = []
    for fid, frames in feats.items():
        np.save(tmp_path / f"{fid}.npy",
                rng.standard_normal((frames, 13)).astype(np.float32))
        lines.append(f"{fid} {tmp_path / fid}.npy\n")
    scp = tmp_path / "feats.scp"
    scp.write_text("".join(lines))
    args = ["--feats-scp", str(scp), "--checkpoint", ckpt, "--config",
            str(cfg), "--verbose", "0"]
    monkeypatch.setattr(sys, "argv", ["predict_wav", *args, "--outdir",
                                      str(tmp_path / "jax")])
    _script("egs/ema/voc1/local/predict_wav.py", "jax_predict_wav").main()
    jax_count = capsys.readouterr().out.split()[-1]
    predict_wav.main([*args, "--outdir", str(tmp_path / "port"), "--device",
                      "cpu"])
    assert capsys.readouterr().out.split()[-1] == jax_count
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax")) == ["long.wav", "longer.wav"]
    model = inference.load_model(ckpt, CONFIG, device="cpu")
    for fid in ("long", "longer"):
        sr, wav = wavfile.read(tmp_path / "port" / f"{fid}.wav")
        assert sr == 16000 and wav.dtype == np.int16
        assert wav.shape == (feats[fid] * 80,)
        ref = (np.clip(inference.ar_loop(model, np.load(
            tmp_path / f"{fid}.npy"), CONFIG), -1, 1) * 32767).astype(np.int16)
        np.testing.assert_allclose(wav, ref, atol=1)
        jax_sr, jax_wav = wavfile.read(tmp_path / "jax" / f"{fid}.wav")
        assert jax_sr == sr and jax_wav.dtype == np.int16
        np.testing.assert_allclose(wav.astype(np.int32),
                                   jax_wav.astype(np.int32), atol=1)


ZOO_GP = {"in_channels": 13, "channels": 32, "upsample_scales": [4, 4],
          "stacks": 2}


@pytest.mark.parametrize("gen_type,gp", [("HiFiGANGenerator", GP),
                                         ("MelGANGenerator", ZOO_GP)],
                         ids=["hifi_car", "melgan"])
def test_model_stats_counts_match_jax(gen_type, gp, tmp_path, capsys):
    """The count JAX's model_stats prints: the leaves of its generator's
    init params (shapes from ``jax.eval_shape``, nothing compiled)."""
    use_ar = gp.get("use_ar", False)
    feats = gp["in_channels"] - (gp["ar_output"] if use_ar else 0)
    kwargs = {"ar": jnp.zeros((1, gp["ar_input"], 1))} if use_ar else {}
    module = jax_models.build_model(gen_type, _tuples(gp))
    shapes = jax.eval_shape(lambda k: module.init(
        k, jnp.zeros((1, 12, feats)), **kwargs), jax.random.PRNGKey(0))
    want = sum(int(np.prod(p.shape))
               for p in jax.tree.leaves(shapes["params"]))
    cfg = tmp_path / "config.yml"
    cfg.write_text(yaml.dump({"generator_type": gen_type,
                              "generator_params": gp, "hop_size": 16}))
    model_stats.main(["--config", str(cfg), "--lengths", "12", "24",
                      "--iters", "1", "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[0] == f"generator params: {want:,}"
    assert [line.split()[0] for line in got[1:]] == ["len=", "len="]
    stats = model_stats.model_stats(
        {"generator_type": gen_type, "generator_params": gp}, [12],
        iters=1, device="cpu")
    assert stats["params"] == want and stats["lengths"][0]["latency_ms"] > 0


# --- convert_checkpoint --to-torch ------------------------------------------

MSMPD = dict(scales=1, scale_discriminator_params=dict(
    channels=16, max_downsample_channels=32, max_groups=4,
    downsample_scales=[4, 1]), periods=[2], period_discriminator_params=dict(
        channels=4, max_downsample_channels=8, downsample_scales=[3, 1]))
BIGRU = dict(in_channels=5 + 8, hidden_size=8, out_channels=4, use_ar=True,
             ar_input=16, ar_hidden=8, ar_output=8)
MSD = dict(scales=2, channels=8, max_downsample_channels=32,
           downsample_scales=[2, 2])
CONVERT = {
    "hifi_car_msmpd": ("HiFiGANGenerator", GP,
                       "HiFiGANMultiScaleMultiPeriodDiscriminator", MSMPD),
    "bigru": ("BiGRU", BIGRU, None, None),
    "melgan": ("MelGANGenerator", ZOO_GP, "MelGANMultiScaleDiscriminator",
               MSD),
}


def _payload(name):
    gen_type, gp, disc_type, dp = CONVERT[name]
    if gen_type == "BiGRU":
        v = _init(gen_type, gp, jnp.zeros((1, 8, 5)),
                  ar=jnp.zeros((1, 4, 4)))
    elif gen_type == "HiFiGANGenerator":
        v = _init(gen_type, gp, jnp.zeros((1, 10, 13)),
                  ar=jnp.zeros((1, 64, 1)))
    else:
        v = _init(gen_type, gp, jnp.zeros((1, 10, 13)))
    model = {"generator": v["params"]}
    if disc_type is not None:
        model["discriminator"] = _init(disc_type, dp,
                                       jnp.zeros((1, 256, 1)))["params"]
    mutables = {k: x for k, x in v.items() if k != "params"}
    return {"model": model, "mutables": {"generator": mutables},
            "optimizer": {}, "steps": 7, "epochs": 2}


def _config(name):
    gen_type, gp, disc_type, dp = CONVERT[name]
    config = {"generator_type": gen_type, "generator_params": gp,
              "sampling_rate": 16000, "hop_size": 16, "batch_max_steps": 160,
              "format": "npy",
              "dataset_mode": "w2a" if gen_type == "BiGRU" else "a2w"}
    if gen_type == "HiFiGANGenerator":
        config.update(hop_size=80, batch_max_steps=800)
    if disc_type is not None:
        config.update(discriminator_type=disc_type, discriminator_params=dp)
    return config


def _same(got, want, where=""):
    assert type(got) is type(want), where
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for key in want:
            _same(got[key], want[key], f"{where}.{key}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype, where
        if want.shape == (1,) and got.dim() == 0:
            # JAX's exporter turns a 0-d entry (num_batches_tracked) 1-d
            # through np.ascontiguousarray; torch loads either
            got = got.reshape(1)
        torch.testing.assert_close(got, want, rtol=0, atol=0, msg=where)
    else:
        assert got == want, where


@pytest.mark.parametrize("name", sorted(CONVERT))
def test_convert_to_torch_matches_jax_export(name, tmp_path, capsys):
    payload = _payload(name)
    ckpt = _write(tmp_path / "ckpt.pkl", payload)
    config = _config(name)
    (tmp_path / "config.yml").write_text(yaml.dump(config))
    out = tmp_path / "export" / "ckpt.pkl"
    convert_checkpoint.main(["--to-torch", "--checkpoint", ckpt, "--out",
                             str(out)])
    assert "exported generator" in capsys.readouterr().out
    got = torch.load(out, weights_only=True)
    _same(got, export_checkpoint(payload, config))
    assert ("discriminator" in got["model"]) == (name != "bigru")
    # the pickle decodes as the msgpack does
    rng = np.random.default_rng(3)
    models = [inference.load_model(path, config, device="cpu")
              for path in (ckpt, str(out))]
    x = rng.standard_normal((25 if name == "hifi_car_msmpd" else 30,
                             5 if name == "bigru" else 13)).astype(np.float32)
    if name == "melgan":
        outs = [m.inference(x) for m in models]
    else:  # the AR models
        outs = [inference.ar_loop(m, x, config) for m in models]
    np.testing.assert_array_equal(outs[0], outs[1])


def test_convert_default_direction_raises(tmp_path):
    """The default direction (a reference pickle to a JAX msgpack, ported
    since; ``test_torch_port_convert.py``) raises, as JAX's does, for a
    generator type with no importer, and writes nothing."""
    torch.save({"model": {"generator": {}}, "steps": 0}, tmp_path / "x.pkl")
    (tmp_path / "config.yml").write_text(yaml.dump(
        {"generator_type": "NoSuchGenerator", "generator_params": {}}))
    with pytest.raises(NotImplementedError, match="no importer"):
        convert_checkpoint.main(["--checkpoint", str(tmp_path / "x.pkl"),
                                 "--out", str(tmp_path / "y.pkl")])
    assert not (tmp_path / "y.pkl").exists()


# --- the recipe script ------------------------------------------------------

RECIPE_DP = dict(scales=1, scale_discriminator_params=dict(
    channels=128, max_downsample_channels=128, downsample_scales=[4, 1]),
    periods=[2], period_discriminator_params=dict(
        channels=4, max_downsample_channels=8, downsample_scales=[3, 1]))
RECIPE = dict(
    CONFIG, fft_size=1024, win_length=None, window="hann", num_mels=80,
    fmin=80, fmax=7600, global_gain_scale=1.0, trim_silence=False,
    discriminator_type="HiFiGANMultiScaleMultiPeriodDiscriminator",
    discriminator_params=RECIPE_DP, use_stft_loss=False, use_mel_loss=True,
    mel_loss_params=dict(fs=16000, fft_size=256, hop_size=64, num_mels=20,
                         fmin=0, fmax=8000, log_base=None),
    generator_adv_loss_params=dict(average_by_discriminators=False),
    discriminator_adv_loss_params=dict(average_by_discriminators=False),
    use_feat_match_loss=True, lambda_aux=45.0, lambda_feat_match=2.0,
    batch_size=2, num_workers=0, allow_cache=True,
    generator_optimizer_type="Adam",
    generator_optimizer_params=dict(lr=1e-4, betas=[0.5, 0.9]),
    generator_scheduler_type="MultiStepLR",
    generator_scheduler_params=dict(gamma=0.5, milestones=[10]),
    discriminator_optimizer_type="Adam",
    discriminator_optimizer_params=dict(lr=1e-4, betas=[0.5, 0.9]),
    discriminator_scheduler_type="MultiStepLR",
    discriminator_scheduler_params=dict(gamma=0.5, milestones=[10]),
    generator_train_start_steps=1, discriminator_train_start_steps=0,
    train_max_steps=2, save_interval_steps=2, eval_interval_steps=2,
    log_interval_steps=100)


def _recipe_dir(root):
    """A recipe directory: path.sh (the port on PYTHONPATH), cmd.sh and
    utils/ of egs/ema/voc1, conf/, and data/<set>/{wav,feats}.scp of a
    synthetic corpus."""
    from articulatory_tpu_torch.utils.io import write_wav

    (root / "path.sh").write_text(f"export PYTHONPATH={ROOT}:"
                                  "${PYTHONPATH:-}\n")
    shutil.copy(os.path.join(ROOT, "egs", "ema", "voc1", "cmd.sh"), root)
    shutil.copytree(os.path.join(ROOT, "egs", "ema", "voc1", "utils"),
                    root / "utils")
    (root / "conf").mkdir()
    (root / "conf" / "tiny.yaml").write_text(yaml.dump(RECIPE))
    rng = np.random.default_rng(0)
    for name, n in (("tr", 3), ("dev", 1), ("ev", 1)):
        data = root / "data" / name
        data.mkdir(parents=True)
        wavs, feats = [], []
        for i in range(n):
            utt = f"{name}_{i}"
            frames = 24 + 3 * i
            write_wav(str(data / f"{utt}.wav"),
                      0.3 * rng.standard_normal(frames * 80), 16000)
            np.save(data / f"{utt}.npy",
                    rng.standard_normal((frames, 13)).astype(np.float32))
            wavs.append(f"{utt} {data / utt}.wav\n")
            feats.append(f"{utt} {data / utt}.npy\n")
        (data / "wav.scp").write_text("".join(wavs))
        (data / "feats.scp").write_text("".join(feats))


def test_recipe_script_runs_stages_1_to_3(tmp_path):
    _recipe_dir(tmp_path)
    env = dict(os.environ, PATH=os.path.dirname(sys.executable) + os.pathsep
               + os.environ.get("PATH", ""), OMP_NUM_THREADS="1")
    out = subprocess.run(
        ["bash", os.path.join(ROOT, "articulatory_tpu_torch", "recipe",
                              "run.sh"),
         "--conf", "conf/tiny.yaml", "--n_jobs", "1", "--train_set", "tr",
         "--dev_set", "dev", "--eval_set", "ev", "--expdir", "exp/tiny",
         "--device", "cpu", "--stage", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "Stage 0 (data preparation) is not run here" in out.stdout
    for name, n in (("tr", 3), ("dev", 1), ("ev", 1)):
        for stage in ("raw", "norm"):
            dump = tmp_path / "dump" / name / stage
            assert len(list(dump.glob("*-wave.npy"))) == n, (name, stage)
        assert (tmp_path / "log" / f"preprocess.{name}.1.log").exists()
    stats = np.load(tmp_path / "dump" / "tr" / "stats.npy")
    assert stats.shape == (2, 80) and np.isfinite(stats).all()
    exp = tmp_path / "exp" / "tiny"
    assert (exp / "best_mel_ckpt.pkl").exists()
    assert (exp / "checkpoint-2steps.ckpt").exists()
    for name, utt, frames in (("dev", "dev_0", 24), ("ev", "ev_0", 24)):
        path = exp / "wav" / "best_mel_ckpt" / name / f"{utt}_gen.wav"
        sr, wav = wavfile.read(path)
        assert sr == 16000 and wav.shape == (frames * 80,)
    # unknown options stop the script
    bad = subprocess.run(
        ["bash", os.path.join(ROOT, "articulatory_tpu_torch", "recipe",
                              "run.sh"), "--no_such_option", "1"],
        cwd=tmp_path, env=env, capture_output=True, text=True)
    assert bad.returncode != 0 and "unknown option" in bad.stderr
