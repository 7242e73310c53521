"""The launcher and the train CLI on two CPU ranks: ``python -m
articulatory_tpu_torch.distributed.launch --nproc_per_node 2`` wires a
rendezvous (a free port, found by binding port 0) that the ranks join, and
takes the other rank down when one fails; and a 2-rank ``bin/train.py``
run resumed inside an epoch ends bit for bit where the uninterrupted run
does (the parameters' md5 on both ranks, as the JAX package's
``test_two_process_ckpt_coordination`` checks its own)."""

import hashlib
import os
import pathlib
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch
import yaml

from articulatory_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent

RENDEZVOUS = textwrap.dedent('''
    import os, sys
    import torch
    from articulatory_tpu_torch.parallel import mesh

    backend = mesh.init_distributed()
    t = torch.tensor([float(mesh.rank() + 1)])
    mesh.all_reduce(t)
    # a file a rank: two ranks' lines can interleave on one pipe
    with open(os.path.join(sys.argv[1], f"rank{mesh.rank()}.txt"), "w") as f:
        f.write(f"RANK {mesh.rank()} OF {mesh.world_size()} LOCAL "
                f"{os.environ['LOCAL_RANK']} {backend} SUM {float(t[0])}")
    if "--fail" in sys.argv and mesh.rank() == 1:
        sys.exit(3)
    mesh.barrier()  # rank 0 waits here for a rank that is gone
    mesh.shutdown()
''')

CONFIG = dict(
    sampling_rate=16000, hop_size=80, dataset_mode="a2w", format="npy",
    batch_max_steps=800, generator_type="HiFiGANGenerator",
    generator_params=dict(
        in_channels=13 + 8, out_channels=1, channels=16, kernel_size=7,
        upsample_scales=[5, 4, 2, 2], upsample_kernel_sizes=[10, 8, 4, 4],
        resblock_kernel_sizes=[3], resblock_dilations=[[1, 3]],
        use_ar=True, ar_input=64, ar_hidden=8, ar_output=8),
    discriminator_type="HiFiGANMultiScaleMultiPeriodDiscriminator",
    discriminator_params=dict(
        scales=1, scale_discriminator_params=dict(
            channels=128, max_downsample_channels=128,
            downsample_scales=[4, 1]),
        periods=[2], period_discriminator_params=dict(
            channels=4, max_downsample_channels=8, downsample_scales=[3, 1])),
    use_stft_loss=False, use_mel_loss=True,
    mel_loss_params=dict(fs=16000, fft_size=256, hop_size=64, num_mels=20,
                         fmin=0, fmax=11025, log_base=None),
    generator_adv_loss_params=dict(average_by_discriminators=False),
    discriminator_adv_loss_params=dict(average_by_discriminators=False),
    use_feat_match_loss=True, lambda_aux=45.0, lambda_feat_match=2.0,
    batch_size=2, num_workers=0, allow_cache=True,
    generator_optimizer_type="Adam",
    generator_optimizer_params=dict(lr=1e-4, betas=[0.5, 0.9]),
    generator_scheduler_type="MultiStepLR",
    generator_scheduler_params=dict(gamma=0.5, milestones=[3]),
    discriminator_optimizer_type="Adam",
    discriminator_optimizer_params=dict(lr=1e-4, betas=[0.5, 0.9]),
    discriminator_scheduler_type="MultiStepLR",
    discriminator_scheduler_params=dict(gamma=0.5, milestones=[3]),
    generator_train_start_steps=1, discriminator_train_start_steps=0,
    save_interval_steps=1, eval_interval_steps=2, log_interval_steps=1,
    num_save_intermediate_results=0)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(*args, timeout=180):
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return subprocess.run(
        [sys.executable, "-m", "articulatory_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--master_port", str(free_port()), *args],
        env=env, capture_output=True, text=True, timeout=timeout, cwd=ROOT)


def test_launcher_rendezvous(tmp_path):
    script = tmp_path / "rank.py"
    script.write_text(RENDEZVOUS)
    proc = launch(str(script), str(tmp_path), "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [(tmp_path / f"rank{r}.txt").read_text() for r in range(2)]
    assert lines == ["RANK 0 OF 2 LOCAL 0 gloo SUM 3.0",
                     "RANK 1 OF 2 LOCAL 1 gloo SUM 3.0"], proc.stderr


def test_launcher_tears_down_on_first_failure(tmp_path):
    script = tmp_path / "rank.py"
    script.write_text(RENDEZVOUS)
    start = time.monotonic()
    proc = launch(str(script), str(tmp_path), "--device", "cpu", "--fail",
                  timeout=120)
    assert proc.returncode != 0
    assert "returned non-zero exit status 3" in proc.stderr, proc.stderr
    assert time.monotonic() - start < 60  # rank 0 did not wait it out



FAIL_IN_TURN = textwrap.dedent('''
    import os, sys, time
    if os.environ["RANK"] == "1":
        sys.exit(3)
    time.sleep(0.3)
    sys.exit(1)
''')


def test_launcher_reports_the_first_failure(tmp_path, monkeypatch, caplog):
    """Rank 1 exits with 3, rank 0 with 1 some 0.3 s later; the launcher,
    held back for a second wherever it sleeps, still raises rank 1's code
    and logs both ranks'. (A poll sweep in rank order, as the launcher had,
    sees both exits in one sweep and reports rank 0's 1.)"""
    from articulatory_tpu_torch.distributed import launch as launcher

    script = tmp_path / "rank.py"
    script.write_text(FAIL_IN_TURN)
    sleep = time.sleep
    monkeypatch.setattr(launcher.time, "sleep", lambda s: sleep(max(s, 1.0)))
    with pytest.raises(subprocess.CalledProcessError) as err:
        launcher.main(["--nproc_per_node", "2", "--master_port",
                       str(free_port()), str(script), "--device", "cpu"])
    assert err.value.returncode == 3
    assert "rank 1 failed first" in caplog.text
    assert "rank 0: " in caplog.text and "rank 1: 3" in caplog.text

def _dump(root, n_utts=8, frames=30):
    rng = np.random.default_rng(0)
    for stage in ("tr", "dev"):
        dump, data = root / "dump" / stage / "norm", root / "data" / stage
        dump.mkdir(parents=True)
        data.mkdir(parents=True)
        lines = []
        for i in range(n_utts if stage == "tr" else 4):
            n = frames + 3 * i
            np.save(dump / f"u{i}-wave.npy",
                    (0.3 * rng.standard_normal(n * 80)).astype(np.float32))
            np.save(dump / f"u{i}-feats.npy", np.zeros((n, 13), np.float32))
            np.save(data / f"u{i}.npy",
                    rng.standard_normal((n, 13)).astype(np.float32))
            lines.append(f"u{i} {data / f'u{i}.npy'}\n")
        (data / "feats.scp").write_text("".join(lines))


def _train(root, outdir, max_steps, *extra):
    path = root / f"config{max_steps}.yaml"
    path.write_text(yaml.dump(dict(CONFIG, train_max_steps=max_steps)))
    proc = launch(
        "articulatory_tpu_torch/bin/train.py", "--device", "cpu",
        "--train-dumpdir", str(root / "dump/tr/norm"),
        "--dev-dumpdir", str(root / "dump/dev/norm"), "--outdir",
        str(outdir), "--config", str(path), "--data-root",
        str(root / "data"), "--verbose", "0", *extra)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc


def _md5(payload) -> str:
    h = hashlib.md5()
    for model in ("generator", "discriminator"):
        for key, value in sorted(payload["model"][model].items()):
            h.update(key.encode())
            h.update(value.numpy().tobytes())
    return h.hexdigest()


def test_two_rank_resume_matches_uninterrupted_run(tmp_path):
    """4 steps straight against the run's step-3 checkpoint resumed to 4
    in another directory (2 batches an epoch a rank, so the resume lands
    inside an epoch)."""
    _dump(tmp_path)
    _train(tmp_path, tmp_path / "straight", 4)
    ckpt = tmp_path / "straight" / "checkpoint-3steps.ckpt"
    assert load_checkpoint(str(ckpt))["epoch_batches"] == 1
    _train(tmp_path, tmp_path / "split", 4, "--resume", str(ckpt))
    want = load_checkpoint(str(tmp_path / "straight/checkpoint-4steps.ckpt"))
    got = load_checkpoint(str(tmp_path / "split/checkpoint-4steps.ckpt"))
    assert _md5(got) == _md5(want)
    for model in ("generator", "discriminator"):
        sa = got["optimizer"][model]["state"]
        sb = want["optimizer"][model]["state"]
        assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i])
    # rank 0 alone wrote the run's files
    names = sorted(p.name for p in (tmp_path / "straight").iterdir())
    assert "best_mel_step.txt" in names and "config.yml" in names
