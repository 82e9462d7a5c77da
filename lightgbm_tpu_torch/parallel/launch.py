"""A world of local processes with a hard time limit.

``LocalWorld(argv, P, cwd)`` starts ``argv`` as ranks 0..P-1 of one world
on this host, each with torch's environment as ``torch.distributed.run``
sets it (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT`` on a free port), its output in
``rank<r>.log`` under ``cwd``.  ``wait`` gives the world ``timeout``
seconds from its start, then kills every rank and raises
``WorldTimeout``: a hung collective ends the caller's wait instead of
stalling it.  The ranks find their devices by the backend rule of
parallel/mesh.py (every rank of one card shares it over gloo).
"""
from __future__ import annotations

import os
import socket
import subprocess
import time
from typing import List, Optional, Tuple


class WorldTimeout(RuntimeError):
    """A world ran past its time limit and was killed."""


def free_port() -> int:
    """A TCP port free on this host now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class LocalWorld:
    def __init__(self, argv: List[str], nprocs: int, cwd: str,
                 timeout: float, env: Optional[dict] = None):
        base = dict(os.environ if env is None else env,
                    MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                    WORLD_SIZE=str(nprocs), LOCAL_WORLD_SIZE=str(nprocs))
        self.nprocs, self.timeout = nprocs, timeout
        self.deadline = time.monotonic() + timeout
        self.logs, self.procs = [], []
        for r in range(nprocs):
            self.logs.append(open(os.path.join(str(cwd), "rank%d.log" % r),
                                  "w+"))
            self.procs.append(subprocess.Popen(
                argv, cwd=str(cwd), stdout=self.logs[-1],
                stderr=subprocess.STDOUT,
                env=dict(base, RANK=str(r), LOCAL_RANK=str(r))))

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def wait(self) -> List[Tuple[int, str]]:
        """Each rank's (exit code, output), once all have exited."""
        try:
            for p in self.procs:
                p.wait(timeout=max(self.deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            self.kill()
            raise WorldTimeout("a world of %d ranks ran past %g s and was "
                               "killed" % (self.nprocs, self.timeout))
        finally:
            out = []
            for p, f in zip(self.procs, self.logs):
                f.seek(0)
                out.append((p.returncode, f.read()))
                f.close()
        return out


__all__ = ["LocalWorld", "WorldTimeout", "free_port"]
