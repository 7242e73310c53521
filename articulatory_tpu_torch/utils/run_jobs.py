#!/usr/bin/env python3
"""Parallel array-job launcher, the python replacement for Kaldi's run.pl
family (a copy of ``articulatory_tpu/utils/run_jobs.py`` for the port; it
imports nothing outside the standard library, so it runs where neither the
JAX package nor ``h5py`` is installed).

Interface (run.pl parity, reference egs/*/voc1/cmd.sh:1-28):
  ``python -m articulatory_tpu_torch.utils.run_jobs [options] JOB=1:N
  log/xxx.JOB.log cmd --args JOB ...``
Each job runs with the literal token ``JOB`` substituted by its index; logs
go to the per-job log file. Exits nonzero if any job fails (run.pl
semantics).

Backends (reference cmd.sh:31-92 backend switch):
  local   run all jobs as subprocesses on this host (run.pl)
  stdout  like local but job output goes to stdout (stdout.pl)
  slurm   submit one ``sbatch --wait --array`` job (slurm.pl)
  sge     submit one ``qsub -sync y -t`` array job (queue.pl)
  ssh     round-robin jobs over hosts in .queue/machines (ssh.pl)
Select with --backend or the RUN_JOBS_BACKEND env var (cmd.sh exports it).

Scheduler options (unified across backends, ignored where meaningless):
  --mem 4G  --time 12:00:00  --num-threads N  --gpu N  --max-jobs-run N
--max-jobs-run caps CONCURRENCY on every backend (sliding window on
local/stdout/ssh, %N on slurm arrays, -tc on sge), like run.pl's option.
Like run.pl, options are only recognized BEFORE the JOB spec / log path —
everything from the first positional onward belongs to the wrapped command
(so ``run_jobs.py JOB=1:2 log/x.JOB.log train.py --gpu 2`` passes ``--gpu 2``
to train.py, not to the scheduler).

The port's recipe script (``recipe/run.sh``) launches its stages through
this module.
"""

from __future__ import annotations

import argparse
import os
import re
import shlex
import subprocess
import sys
import tempfile

# options recognized before the JOB spec (run.pl-style prefix parsing)
_SCHEDULER_OPTS = {
    "--backend", "--mem", "--time", "--num-threads", "--gpu",
    "--max-jobs-run", "--machines", "--config",
}


class QueueConf:
    """Kaldi queue.pl/slurm.pl config (reference conf/slurm.conf schema).

    Lines:
      ``command <submit cmd...>``        base scheduler command
      ``option <name>=* <args...>``      map option to args, $0 = the value
      ``option <name>=<val> <args...>``  exact-value override (args may be
                                         empty: emit nothing for that value)
      ``default <name>=<val>``           value used when the option is unset
    """

    def __init__(self, command: list[str], options: dict, defaults: dict):
        self.command = command
        self.options = options      # {(name, "*" | value): [args]}
        self.defaults = defaults    # {name: value}

    @classmethod
    def parse(cls, text: str) -> "QueueConf":
        command: list[str] = []
        options: dict = {}
        defaults: dict = {}
        for ln, raw in enumerate(text.splitlines(), 1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            toks = line.split()
            if toks[0] == "command":
                command = toks[1:]
            elif toks[0] == "option" and len(toks) >= 2 and "=" in toks[1]:
                name, val = toks[1].split("=", 1)
                options[(name, val)] = toks[2:]
            elif toks[0] == "default" and len(toks) == 2 and "=" in toks[1]:
                name, val = toks[1].split("=", 1)
                defaults[name] = val
            else:
                raise ValueError(f"bad config line {ln}: {raw!r}")
        if not command:
            raise ValueError("config defines no 'command' line")
        return cls(command, options, defaults)

    def expand(self, values: dict) -> list[str]:
        """Scheduler args for the given unified-option values.

        ``values``: {name: value-or-None}; defaults fill unset names; names
        with neither a value nor a default are skipped. Unknown names with a
        value error out (queue.pl behavior).
        """
        vals = dict(values)
        for name, d in self.defaults.items():
            if vals.get(name) is None:
                vals[name] = d
        out: list[str] = []
        for name, v in vals.items():
            if v is None:
                continue
            v = str(v)
            if (name, v) in self.options:
                out += self.options[(name, v)]
            elif (name, "*") in self.options:
                out += [a.replace("$0", v) for a in self.options[(name, "*")]]
            else:
                raise ValueError(
                    f"config has no rule for option {name}={v} "
                    f"(add 'option {name}=*' or 'option {name}={v}')")
        return out


def parse_args(argv):
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--backend",
                        default=os.environ.get("RUN_JOBS_BACKEND", "local"),
                        choices=["local", "stdout", "slurm", "sge", "ssh"])
    parser.add_argument("--mem", default=None)
    parser.add_argument("--time", default=None)
    parser.add_argument("--num-threads", type=int, default=None)
    parser.add_argument("--gpu", type=int, default=None)
    parser.add_argument("--max-jobs-run", type=int, default=None)
    parser.add_argument("--machines", default=".queue/machines",
                        help="host list for the ssh backend (one per line)")
    parser.add_argument("--config", default=None,
                        help="queue.pl-style option-mapping config (e.g. "
                             "conf/slurm.conf) for the slurm/sge backends")

    # run.pl semantics: scheduler options appear only before the JOB spec /
    # log path; stop at the first non-option token so flags belonging to the
    # wrapped command (e.g. ``train.py --gpu 2``) are never stolen.
    head, i = [], 0
    while i < len(argv):
        name = argv[i].split("=", 1)[0]
        if name not in _SCHEDULER_OPTS:
            break
        head.append(argv[i])
        if "=" not in argv[i]:
            i += 1
            if i >= len(argv):
                parser.error(f"option {name} expects a value")
            head.append(argv[i])
        i += 1
    rest = argv[i:]
    opts = parser.parse_args(head)

    usage = "usage: run_jobs.py [options] [JOB=lo:hi] log/xxx.JOB.log cmd ..."
    if not rest:
        parser.error(f"missing log file and command\n{usage}")
    m = re.match(r"JOB=(\d+):(\d+)$", rest[0])
    if m:
        lo, hi = int(m.group(1)), int(m.group(2))
        if len(rest) < 2:
            parser.error(f"missing log file after the JOB spec\n{usage}")
        logpat, cmd = rest[1], rest[2:]
    else:
        lo = hi = 1
        logpat, cmd = rest[0], rest[1:]
    if not cmd:
        parser.error(f"missing command to run\n{usage}")
    return opts, lo, hi, logpat, cmd


def _quote_with_job(arg: str, task_var: str) -> str:
    """shlex-quote ``arg`` with every JOB token replaced by the scheduler's
    task-id variable OUTSIDE the quoting (quote-then-replace would bury the
    ``"${VAR}"`` reference inside single quotes where it never expands)."""
    ref = f'"${{{task_var}}}"'
    # quote EVERY piece, including empty ones: bash concatenates adjacent
    # words (''"$x"'' == "$x"), and a fully-empty arg must stay an '' argv
    # entry rather than vanish from the command line
    return ref.join(shlex.quote(p) for p in arg.split("JOB"))


def _array_script(cmd: list[str], task_var: str) -> str:
    """Shell script body running the command with JOB -> scheduler task id.

    slurm.pl parity (reference utils/slurm.pl:373-386): the queue script
    re-creates the submit-time environment itself, because config command
    lines like ``sbatch --export=PATH`` (reference conf/slurm.conf:2)
    forward nothing else — cd back to the submit cwd, re-export the
    submit-time PATH (and PYTHONPATH, which the recipes' path.sh puts the
    package on), then source ``./path.sh`` when present, as slurm.pl does.
    """
    quoted = " ".join(_quote_with_job(c, task_var) for c in cmd)
    lines = ["#!/bin/bash",
             f"cd {shlex.quote(os.getcwd())}",
             f"export PATH={shlex.quote(os.environ.get('PATH', ''))}"]
    if os.environ.get("PYTHONPATH"):
        lines.append(
            f"export PYTHONPATH={shlex.quote(os.environ['PYTHONPATH'])}")
    lines += ["if [ -f ./path.sh ]; then . ./path.sh; fi", quoted]
    return "\n".join(lines) + "\n"


def _structural_args(backend: str, lo: int, hi: int, logpat: str,
                     opts) -> tuple[list[str], str]:
    """Backend-determined submission flags (array spec, blocking, log
    paths, concurrency cap) and the scheduler's task-id variable. Shared
    by the --config and default paths so they cannot drift."""
    if backend == "slurm":
        # slurm.pl semantics: one array job, %a = task id in log names,
        # --wait blocks until the whole array finishes (run.sh is
        # synchronous), exit status reflects job failures
        argv = ["--wait",
                f"--array={lo}-{hi}"
                + (f"%{opts.max_jobs_run}" if opts.max_jobs_run else ""),
                "-o", logpat.replace("JOB", "%a"),
                "-e", logpat.replace("JOB", "%a")]
        return argv, "SLURM_ARRAY_TASK_ID"
    if backend == "sge":
        # queue.pl semantics: qsub -t array, -sync y blocks until done,
        # -j y merges stderr into the per-task -o log, $TASK_ID in -o
        # gives per-task logs on SGE ('$TASK_ID' literal)
        argv = ["-cwd", "-sync", "y", "-b", "n", "-j", "y",
                "-t", f"{lo}-{hi}",
                "-o", logpat.replace("JOB", "$TASK_ID")]
        if opts.max_jobs_run:
            argv += ["-tc", str(opts.max_jobs_run)]
        return argv, "SGE_TASK_ID"
    raise ValueError(f"no submission command for backend {backend!r}")


def build_submission(backend: str, lo: int, hi: int, logpat: str,
                     cmd: list[str], opts) -> tuple[list[str], str]:
    """Construct (scheduler argv, array script text) — pure, for unit tests.

    The argv's final element is the placeholder ``__SCRIPT__``; the caller
    writes the script to a temp file and substitutes its path.

    With ``opts.config`` (queue.pl/slurm.pl ``--config conf/slurm.conf``
    parity, reference cmd.sh:58-60 + conf/slurm.conf), the config's
    ``command`` line replaces the base submit command and its option table
    maps --mem/--time/--num-threads/--gpu onto scheduler flags; the
    structural flags (array spec, blocking, log paths, --max-jobs-run) stay
    backend-determined, as in slurm.pl.
    """
    structural, task_var = _structural_args(backend, lo, hi, logpat, opts)
    if getattr(opts, "config", None):
        with open(opts.config) as f:
            conf = QueueConf.parse(f.read())
        head = list(conf.command) + conf.expand(
            {"mem": opts.mem, "time": opts.time,
             "num_threads": opts.num_threads, "gpu": opts.gpu})
    elif backend == "slurm":
        head = ["sbatch", "--export=ALL"]
        if opts.mem:
            head += [f"--mem={opts.mem}"]
        if opts.time:
            head += [f"--time={opts.time}"]
        if opts.num_threads:
            head += [f"--cpus-per-task={opts.num_threads}"]
        if opts.gpu:
            head += [f"--gres=gpu:{opts.gpu}"]
    else:  # sge (anything else was rejected by _structural_args)
        head = ["qsub"]
        if opts.mem:
            head += ["-l", f"mem_free={opts.mem},ram_free={opts.mem}"]
        if opts.time:
            head += ["-l", f"h_rt={opts.time}"]
        if opts.num_threads:
            head += ["-pe", "smp", str(opts.num_threads)]
        if opts.gpu:
            head += ["-l", f"gpu={opts.gpu}"]
    return head + structural + ["__SCRIPT__"], _array_script(cmd, task_var)


def _run_local(lo, hi, logpat, cmd, to_stdout=False, hosts=None,
               max_jobs_run=None):
    """Run the job array as local (or ssh-wrapped) subprocesses.

    ``max_jobs_run`` bounds CONCURRENCY like run.pl's option of the same
    name (run.pl enforces it as a sliding window, not batched waves)."""
    import time as _time

    cap = max_jobs_run if max_jobs_run and max_jobs_run > 0 else None
    running: list = []
    failed: list = []

    def _reap_finished():
        still = []
        for job, p in running:
            rc = p.poll()
            if rc is None:
                still.append((job, p))
            elif rc != 0:
                failed.append(job)
        running[:] = still

    for job in range(lo, hi + 1):
        while cap is not None and len(running) >= cap:
            _reap_finished()
            if len(running) >= cap:
                _time.sleep(0.05)
        jcmd = [c.replace("JOB", str(job)) for c in cmd]
        if hosts is not None:  # ssh.pl round-robin
            host = hosts[(job - lo) % len(hosts)]
            jcmd = ["ssh", "-o", "BatchMode=yes", host,
                    f"cd {shlex.quote(os.getcwd())} && "
                    + " ".join(shlex.quote(c) for c in jcmd)]
        if to_stdout:
            running.append((job, subprocess.Popen(jcmd)))
            continue
        jlog = logpat.replace("JOB", str(job))
        os.makedirs(os.path.dirname(jlog) or ".", exist_ok=True)
        with open(jlog, "w") as logf:
            running.append((job, subprocess.Popen(jcmd, stdout=logf,
                                                  stderr=subprocess.STDOUT)))
    for job, p in running:
        if p.wait() != 0:
            failed.append(job)
    return sorted(failed)


def main():
    opts, lo, hi, logpat, cmd = parse_args(sys.argv[1:])

    if opts.config and opts.backend not in ("slurm", "sge"):
        # cmd.sh may export a global cmd_config while the backend is still
        # local (e.g. debugging) — say so instead of silently ignoring it
        print(f"run_jobs.py: --config {opts.config} has no effect on the "
              f"{opts.backend!r} backend (only slurm/sge map config options)",
              file=sys.stderr)

    if opts.backend in ("local", "stdout"):
        failed = _run_local(lo, hi, logpat, cmd,
                            to_stdout=opts.backend == "stdout",
                            max_jobs_run=opts.max_jobs_run)
    elif opts.backend == "ssh":
        if not os.path.exists(opts.machines):
            print(f"run_jobs.py: ssh backend needs a host list at "
                  f"{opts.machines}", file=sys.stderr)
            sys.exit(1)
        with open(opts.machines) as f:
            hosts = [line.strip() for line in f if line.strip()]
        failed = _run_local(lo, hi, logpat, cmd, hosts=hosts,
                            max_jobs_run=opts.max_jobs_run)
    else:
        argv, script = build_submission(opts.backend, lo, hi, logpat, cmd, opts)
        # per-task log dirs: when JOB appears in a directory component
        # (log/JOB/out.log), every task's dir must exist before the
        # scheduler tries to open its -o/-e file
        for job in range(lo, hi + 1):
            os.makedirs(os.path.dirname(logpat.replace("JOB", str(job)))
                        or ".", exist_ok=True)
        with tempfile.NamedTemporaryFile(
                "w", suffix=".sh", prefix="run_jobs.",
                delete=False) as f:
            f.write(script)
            script_path = f.name
        os.chmod(script_path, 0o755)
        argv = [script_path if a == "__SCRIPT__" else a for a in argv]
        rc = subprocess.call(argv)
        failed = [f"array rc={rc}"] if rc != 0 else []

    if failed:
        print(f"run_jobs.py: jobs failed: {failed} (see {logpat})",
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
