"""Multi-process (multi-controller) harness of the port.

The counterpart of ``radix_sorting_tpu.utils.mpharness``: one copy of the
launch recipe that ``scripts/mp_worker.py``'s launchers share
(``tests/test_torch_multiprocess.py``, ``tests/test_torch_cuda.py`` and
``chip_smoke.py``). The contract a cluster launcher also follows:

* the coordinator is an address the launcher names (a free localhost port
  here); every worker gets its process index, the number of processes and
  the backend as arguments, never from ambient variables: an inherited
  ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` or
  ``LOCAL_RANK`` is scrubbed from a worker's environment;
* each worker calls :func:`init_worker`, which initialises the default
  ``torch.distributed`` process group over ``tcp://<coordinator>``; gloo on
  the CPU, NCCL between cards. A backend is never swapped for another.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import tempfile
import time
from typing import List, Optional, Sequence, Tuple

__all__ = ["free_port", "worker_env", "init_worker", "run_workers"]

_AMBIENT = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")


def free_port() -> int:
    """An OS-assigned free TCP port on localhost (the coordinator)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_env(local_devices: Optional[int] = None,
               extra: Optional[dict] = None) -> dict:
    """A spawned worker's environment: this one without the ambient
    ``torch.distributed`` variables, with ``RST_MP_LOCAL_DEVICES`` (the
    ranks a worker drives) where given, and ``extra`` on top."""
    env = {k: v for k, v in os.environ.items() if k not in _AMBIENT}
    if local_devices is not None:
        env["RST_MP_LOCAL_DEVICES"] = str(local_devices)
    if extra:
        env.update(extra)
    return env


def init_worker(process_id: int, num_processes: int, coordinator: str, *,
                backend: str, timeout_s: float = 60.0):
    """Join the group: ``init_process_group(backend, init_method=
    f"tcp://{coordinator}", rank=process_id, world_size=num_processes)``.
    ``timeout_s`` bounds the rendezvous and every collective, so a worker
    whose peer died raises instead of waiting for ever. Returns the group."""
    import torch.distributed as dist
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", rank=process_id,
                            world_size=num_processes,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


def run_workers(commands: Sequence[Sequence[str]], *, env: Optional[dict] = None,
                cwd: Optional[str] = None, timeout_s: float = 120.0
                ) -> List[Tuple[int, str]]:
    """Start one process a command, all at once, and wait for them: each
    one's (exit code, output: stdout and stderr). As soon as one exits with
    another code than 0, every other is killed (its code is then negative);
    past ``timeout_s`` every one is killed and TimeoutError raised with the
    ends of their outputs. No process outlives the call."""
    with tempfile.TemporaryDirectory(prefix="rst_mp_") as tmp:
        logs = [open(os.path.join(tmp, f"worker{i}.log"), "w+") for i in range(len(commands))]
        procs, timed_out = [], False
        try:
            for cmd, log in zip(commands, logs):
                procs.append(subprocess.Popen(list(cmd), stdout=log, stderr=subprocess.STDOUT,
                                              env=env, cwd=cwd))
            deadline = time.monotonic() + timeout_s
            while True:
                codes = [p.poll() for p in procs]
                if None not in codes or any(codes):     # all done, or one failed
                    break
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
    if timed_out:
        tails = "\n".join(f"--- worker {i}:\n{o[-2000:]}" for i, o in enumerate(outs))
        raise TimeoutError(f"workers still running after {timeout_s} s, all killed\n{tails}")
    return [(p.returncode, out) for p, out in zip(procs, outs)]
