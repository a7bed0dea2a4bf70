#!/usr/bin/env python
"""Multi-process launcher, port of ``tools/launch.py``.

Starts N processes of one trainer command (locally, or over ssh from a
hostfile) with the ``RESNET_TPU_*`` rendezvous that
``parallel/dist.py::maybe_init_distributed`` reads. Each process is one
rank of the ``torch.distributed`` group and drives one device.

Local:
    python -m resnet_tpu_torch.tools.launch -n 2 -- \\
        python -m resnet_tpu_torch.train_resnet ...

Multi-host:
    python -m resnet_tpu_torch.tools.launch -n 4 --hostfile hosts.txt \\
        --coordinator host0:12345 -- \\
        python -m resnet_tpu_torch.train_resnet ...
"""

from __future__ import annotations

import argparse
import os
import shlex
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional, Sequence

ENV_KEYS = ("RESNET_TPU_COORDINATOR", "RESNET_TPU_NUM_PROCS",
            "RESNET_TPU_PROC_ID")
GRACE_S = 10.0      # SIGTERM to SIGKILL, for a rank stuck in a collective


def free_port() -> int:
    """A TCP port free on this machine now, for a local coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(cmd: Sequence[str], num_procs: int, coordinator: str,
          hosts: Optional[Sequence[str]] = None, env=None,
          **popen_kw) -> List[subprocess.Popen]:
    """Start ``num_procs`` ranks of ``cmd`` with the rendezvous in their
    environment (``env``, by default this process's): locally, or rank r
    over ssh on ``hosts[r]``."""
    procs = []
    for rank in range(num_procs):
        penv = dict(os.environ if env is None else env)
        penv.update(zip(ENV_KEYS, (coordinator, str(num_procs), str(rank))))
        if hosts is None:
            procs.append(subprocess.Popen(list(cmd), env=penv, **popen_kw))
        else:
            env_str = " ".join(f"{k}={shlex.quote(penv[k])}"
                               for k in ENV_KEYS)
            remote = f"cd {shlex.quote(os.getcwd())} && {env_str} " \
                     + " ".join(shlex.quote(c) for c in cmd)
            procs.append(subprocess.Popen(["ssh", hosts[rank], remote],
                                          **popen_kw))
    return procs


def terminate(procs: Sequence[subprocess.Popen]) -> None:
    for pr in procs:
        if pr.poll() is None:
            pr.terminate()


def wait_all(procs: Sequence[subprocess.Popen],
             timeout: Optional[float] = None,
             stop: Optional[threading.Event] = None) -> int:
    """Wait for every rank; returns the first nonzero exit code, else 0.

    Fail fast: when one rank fails, terminate the rest, so that the job
    fails instead of hanging in a collective (recovery is a relaunch with
    --auto-resume from the last checkpoint). A rank blocked inside a
    collective cannot run its SIGTERM handler, so terminate escalates to
    SIGKILL after a grace period; ``stop`` being set does the same. Past
    ``timeout`` seconds every rank is killed and ``TimeoutError``
    raised."""
    deadline = None if timeout is None else time.monotonic() + timeout
    rc = 0
    live = list(procs)
    killing_since = None
    try:
        while live:
            for pr in list(live):
                r = pr.poll()
                if r is None:
                    continue
                live.remove(pr)
                rc = rc or r
                if r and live and killing_since is None:
                    print(f"launch: worker exited rc={r}; terminating "
                          "remaining workers", file=sys.stderr)
                    terminate(live)
                    killing_since = time.monotonic()
            if stop is not None and stop.is_set() and killing_since is None:
                terminate(live)
                killing_since = time.monotonic()
            if killing_since is not None and live \
                    and time.monotonic() - killing_since > GRACE_S:
                for pr in live:
                    pr.kill()
            if deadline is not None and live and time.monotonic() > deadline:
                raise TimeoutError(
                    f"{len(live)} of {len(procs)} ranks still running after "
                    f"{timeout} s")
            time.sleep(0.1)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
            pr.wait()
    return rc


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-n", "--num-procs", type=int, required=True)
    p.add_argument("--coordinator", default="127.0.0.1:12355",
                   help="host:port of process 0")
    p.add_argument("--local", action="store_true",
                   help="all processes on this machine")
    p.add_argument("--hostfile", default=None,
                   help="one host per line (ssh launch)")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="-- trainer command")
    args = p.parse_args(argv)
    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        p.error("missing trainer command after --")

    hosts = None
    if args.hostfile and not args.local:
        with open(args.hostfile) as f:
            hosts = [h.strip() for h in f if h.strip()]
        if len(hosts) < args.num_procs:
            p.error(f"hostfile has {len(hosts)} hosts, need {args.num_procs}")
    procs = start(cmd, args.num_procs, args.coordinator, hosts)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda signum, frame: stop.set())
    return wait_all(procs, stop=stop)


if __name__ == "__main__":
    sys.exit(main())
