#!/usr/bin/env python3
"""Multi-process launcher (port of ``articulatory_tpu/distributed/launch.py``,
the reference's ``articulatory/distributed/launch.py``): one process a
rank, wired through the environment ``torch.distributed`` reads.

Each rank gets ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``, and the JAX package's names for the
same rendezvous (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
``JAX_PROCESS_ID``); ``bin/train.py`` joins the group from them, and a rank
asked for ``cuda`` runs on ``cuda:{LOCAL_RANK % device_count}``. Unless the
script's arguments hold ``--device cpu``, the CUDA kernels are built once
here, before the ranks start (``ops/_build.py``; each rank then loads the
libraries), and the seconds that took are logged. A rank is killed when the
launcher dies, and the first rank to fail takes the others down with it:
the launcher exits with that rank's code, and logs every rank's.

    python -m articulatory_tpu_torch.distributed.launch --nproc_per_node 2 \\
        [--nnodes 1 --node_rank 0 --master_addr 127.0.0.1 \\
         --master_port 29500] [-c] training_script args...
"""

from __future__ import annotations

import logging
import os
import queue
import subprocess
import sys
import threading
import time
from argparse import REMAINDER, ArgumentParser


def parse_args(argv: list[str] | None = None):
    parser = ArgumentParser(description="torch.distributed launcher")
    parser.add_argument("--nnodes", type=int, default=1)
    parser.add_argument("--node_rank", type=int, default=0)
    parser.add_argument("--nproc_per_node", type=int, default=1)
    parser.add_argument("--master_addr", default="127.0.0.1", type=str)
    parser.add_argument("--master_port", default=29500, type=int)
    parser.add_argument("-c", "--command", default=False, action="store_true",
                        help="run as a shell command instead of a python "
                             "script")
    parser.add_argument("training_script", type=str)
    parser.add_argument("training_script_args", nargs=REMAINDER)
    return parser.parse_args(argv)


def _die_with_parent():
    """preexec_fn: SIGKILL the rank when the launcher dies, even by SIGKILL;
    a rank left behind would wait in a collective whose peer is gone."""
    try:
        import ctypes
        import signal

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG = 1
    except Exception:
        pass


def _on_cpu(args: list[str]) -> bool:
    for i, a in enumerate(args):
        if a == "--device" and i + 1 < len(args):
            return args[i + 1] == "cpu"
        if a.startswith("--device="):
            return a.split("=", 1)[1] == "cpu"
    return False


def build_kernels(script_args: list[str]) -> float | None:
    """Build the CUDA kernels before the ranks start; the seconds it took,
    or None on a CPU run or where there is no nvcc (a rank asked for a card
    then raises as it would alone)."""
    if _on_cpu(script_args):
        return None
    from articulatory_tpu_torch.ops import _build

    try:
        _build._nvcc()
    except RuntimeError:
        return None
    start = time.perf_counter()
    _build.build_all()
    seconds = time.perf_counter() - start
    logging.warning(f"launcher: kernels built in {seconds:.1f} s before the "
                    f"ranks started")
    return seconds


def rank_env(base: dict, *, rank: int, local_rank: int, world: int,
             local_world: int, addr: str, port: int) -> dict:
    env = dict(base)
    env.update(MASTER_ADDR=addr, MASTER_PORT=str(port), WORLD_SIZE=str(world),
               RANK=str(rank), LOCAL_RANK=str(local_rank),
               LOCAL_WORLD_SIZE=str(local_world),
               JAX_COORDINATOR_ADDRESS=f"{addr}:{port}",
               JAX_NUM_PROCESSES=str(world), JAX_PROCESS_ID=str(rank))
    # guard against CPU thread oversubscription (reference launch.py:120-131)
    env.setdefault("OMP_NUM_THREADS", "1")
    return env


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    world = args.nnodes * args.nproc_per_node
    build_kernels(args.training_script_args)

    processes = []
    for local_rank in range(args.nproc_per_node):
        env = rank_env(os.environ,
                       rank=args.nproc_per_node * args.node_rank + local_rank,
                       local_rank=local_rank, world=world,
                       local_world=args.nproc_per_node,
                       addr=args.master_addr, port=args.master_port)
        if args.command:
            cmd = [args.training_script] + args.training_script_args
        else:
            cmd = [sys.executable, "-u", args.training_script,
                   *args.training_script_args]
        processes.append(subprocess.Popen(
            cmd, env=env,
            preexec_fn=_die_with_parent if sys.platform == "linux" else None))

    wait_ranks(processes)


def wait_ranks(processes: list[subprocess.Popen], grace: float = 10.0
               ) -> None:
    """Wait for every rank; on the first failure terminate the others
    instead of leaving them waiting in a collective (SIGKILL after
    ``grace`` seconds) and raise ``CalledProcessError`` with the code of
    the rank that failed first. A waiter thread a rank puts ``(rank,
    code)`` on a queue as its process ends, so the order of the queue is
    the order of the exits, however late the launcher reads it."""
    exits: queue.Queue = queue.Queue()
    for rank, p in enumerate(processes):
        threading.Thread(target=lambda r=rank, p=p: exits.put((r, p.wait())),
                         daemon=True).start()
    codes: dict[int, int] = {}
    first = None
    deadline = None
    while len(codes) < len(processes):
        try:
            rank, code = exits.get(
                timeout=None if deadline is None
                else max(0.1, deadline - time.monotonic()))
        except queue.Empty:  # a rank ignored SIGTERM
            for p in processes:
                if p.poll() is None:
                    p.kill()
            continue
        codes[rank] = code
        if code != 0 and first is None:
            first = rank
            deadline = time.monotonic() + grace
            for p in processes:
                if p.poll() is None:
                    p.terminate()
    report = ", ".join(f"rank {r}: {codes[r]}" for r in sorted(codes))
    if first is None:
        logging.info("launcher: exit codes %s", report)
        return
    logging.warning("launcher: rank %d failed first; exit codes %s", first,
                    report)
    raise subprocess.CalledProcessError(returncode=codes[first],
                                        cmd=processes[first].args)


if __name__ == "__main__":
    main()
