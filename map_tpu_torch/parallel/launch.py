"""Launch N local ranks of a module (the training CLI by default).

    python -m map_tpu_torch.parallel.launch --nprocs 2 [--backend gloo] \\
        [--module map_tpu_torch.run] -- --model_name=dcnv2 ... --device cpu

starts N processes of `python -m <module> <args>`, each with torchrun's
variables (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR=localhost and a free
MASTER_PORT; MAP_TPU_DIST_BACKEND when --backend is given), and waits for
all of them. If one fails the others are stopped, and the launcher exits
with the failed rank's code. `python -m map_tpu_torch.run --mock_devices N`
comes here (map_tpu's N virtual CPU devices become N gloo ranks on the CPU).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
from typing import List, Optional, Sequence


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int, backend: Optional[str] = None,
             base: Optional[dict] = None) -> dict:
    env = dict(os.environ if base is None else base)
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               MASTER_ADDR="localhost", MASTER_PORT=str(port))
    env.pop("MAP_TPU_COORDINATOR", None)
    env.pop("MAP_TPU_NUM_PROCESSES", None)
    env.pop("MAP_TPU_PROCESS_ID", None)
    if backend:
        env["MAP_TPU_DIST_BACKEND"] = backend
    return env


def launch(nprocs: int, argv: Sequence[str], module: str = "map_tpu_torch.run",
           backend: Optional[str] = None, timeout: Optional[float] = None,
           capture: bool = False) -> List[subprocess.CompletedProcess]:
    """Run `python -m module argv` as ranks 0..nprocs-1 and wait for them:
    one CompletedProcess a rank (stdout and stderr captured with
    `capture`). A rank that fails, or the timeout, stops every rank."""
    port = free_port()
    pipe = subprocess.PIPE if capture else None
    procs = [subprocess.Popen([sys.executable, "-m", module, *argv],
                              env=rank_env(r, nprocs, port, backend),
                              stdout=pipe, stderr=pipe, text=True)
             for r in range(nprocs)]
    deadline = None if timeout is None else time.monotonic() + timeout
    outs = [None] * nprocs
    try:
        pending = set(range(nprocs))
        while pending:
            for r in sorted(pending):
                p = procs[r]
                if p.poll() is None and not capture:
                    continue
                if capture:
                    try:
                        outs[r] = p.communicate(timeout=0.2)
                    except subprocess.TimeoutExpired:
                        continue
                pending.discard(r)
                if p.returncode != 0:
                    raise _RankFailed(r)
            if deadline is not None and time.monotonic() > deadline:
                raise _RankFailed(-1)
            time.sleep(0.05)
    except _RankFailed:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for r, p in enumerate(procs):
            o = p.communicate()
            if outs[r] is None:
                outs[r] = o
    return [subprocess.CompletedProcess(p.args, p.returncode,
                                        *(outs[r] if capture else (None, None)))
            for r, p in enumerate(procs)]


class _RankFailed(Exception):
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--module", default="map_tpu_torch.run")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    ap.add_argument("rest", nargs=argparse.REMAINDER)
    a = ap.parse_args(argv)
    rest = a.rest[1:] if a.rest[:1] == ["--"] else a.rest
    results = launch(a.nprocs, rest, a.module, a.backend)
    bad = [r for r in results if r.returncode != 0]
    return bad[0].returncode if bad else 0


if __name__ == "__main__":
    sys.exit(main())
