"""A world of ranks, for a cell whose ``chips`` N is over 1: one process a
card, started by the process that the benchmark's command starts.

The launcher (:func:`launch`) makes no CUDA context.  It picks a free local
port and starts N processes of a script (``run.py``, ``calibrate.py``) with
the script's own arguments, one a card, each in a process group of its own
and with the environment that ``torchrun`` sets (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) and
two variables of the harness: :data:`T0`, the launcher's start on the
monotonic clock (a rank's ``setup_s`` counts from it), and :data:`DEVICE`,
``cuda`` (rank r on ``cuda:r``, NCCL) or ``cpu`` (gloo; the tests' worlds).
It waits for every rank.  When one ends with another code than 0, or the
launcher is told to stop, it kills every rank's process group (a rank's own
children with it) and returns that code; a launcher that is killed takes
its ranks with it (Linux's parent-death signal).  A rank left waiting in a
collective by a rank that hangs ends at the group's timeout
(:data:`TIMEOUT_S`), so the launcher ends the world within it.

A rank's side is :class:`World`: the default process group, started before
the entry is loaded, and the few collectives the harness makes itself.
Those travel on the host (a gloo group beside NCCL's), so the harness puts
nothing on the cards between the entry's calls: no memory, no kernel and
no stream synchronisation.  One all-reduce a call carries all that the
window needs: on an H100's host a round trip after a waited-for call costs
0.7-1.0 ms (a world of one rank against the one-chip path on the 5.7-ms
preview call; two collectives a call cost 1.2-1.9 ms).
"""

from __future__ import annotations

import ctypes
import datetime
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch
import torch.distributed as dist

T0 = "BENCH_WORLD_T0"
DEVICE = "BENCH_WORLD_DEVICE"
# a collective that waits longer than this fails on its rank, which then
# exits; the skew between ranks is a few seconds (they make the same calls
# and build the same kernels), the longest call tens of seconds
TIMEOUT_S = 600


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stop(signum, frame):
    raise SystemExit(128 + signum)


def launch(script: Path, argv: list, chips: int, t0: float, device: str = "cuda") -> tuple:
    """Run ``script argv`` as a world of ``chips`` ranks and wait for them;
    returns the first code other than 0 that a rank ended with (0 if none
    did) and the lines rank 0 wrote to standard output.  The other ranks'
    standard output goes to standard error."""
    env = dict(os.environ, WORLD_SIZE=str(chips), LOCAL_WORLD_SIZE=str(chips),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               **{T0: repr(t0), DEVICE: device})
    procs, lines, rc = [], [], 0
    prctl = ctypes.CDLL(None, use_errno=True).prctl

    def die_with_launcher():  # in the rank, between fork and exec
        prctl(1, int(signal.SIGKILL))  # PR_SET_PDEATHSIG

    old = {s: signal.signal(s, _stop) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        for r in range(chips):
            procs.append(subprocess.Popen(
                [sys.executable, str(script), *argv], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=subprocess.PIPE if r == 0 else sys.stderr.fileno(), text=True,
                start_new_session=True, preexec_fn=die_with_launcher))
        reader = threading.Thread(target=lambda: lines.extend(procs[0].stdout), daemon=True)
        reader.start()
        while rc == 0 and any(p.poll() is None for p in procs):
            time.sleep(0.05)
            rc = next((p.returncode for p in procs if p.returncode not in (None, 0)), 0)
        rc = rc or next((p.returncode for p in procs if p.returncode), 0)
    finally:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        for p in procs:
            p.wait()
        for s, handler in old.items():
            signal.signal(s, handler)
    reader.join()
    return rc, [line.rstrip("\n") for line in lines]


class World:
    """This rank's place in the world that :func:`launch` started: the
    default process group (NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU,
    with :data:`TIMEOUT_S`), which carries the inputs, and the harness's
    collectives on a gloo group of the same ranks, on the host."""

    def __init__(self):
        self.rank, self.size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        self.t0 = float(os.environ[T0])
        if os.environ[DEVICE] == "cuda":
            self.device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(self.device)
            backend = "nccl"
        else:
            self.device, backend = torch.device("cpu"), "gloo"
        timeout = datetime.timedelta(seconds=TIMEOUT_S)
        dist.init_process_group(backend, rank=self.rank, world_size=self.size, timeout=timeout)
        self._host = dist.new_group(backend="gloo", timeout=timeout) if backend == "nccl" else None
        self._flags = torch.zeros(2)

    def since_start(self) -> float:
        """Seconds since the launcher started."""
        return time.monotonic() - self.t0

    def inputs(self, make, part=None) -> list:
        """Rank 0's ``make()``, a list of tensors, with the same bits on
        every rank; each kept as ``part(tensor)`` where ``part`` is given."""
        made = make() if self.rank == 0 else None
        meta = self.share([(tuple(t.shape), t.dtype) for t in made] if made is not None else None)
        out = []
        for i, (shape, dtype) in enumerate(meta):
            t = made[i] if made is not None else torch.empty(shape, dtype=dtype, device=self.device)
            dist.broadcast(t, 0)
            out.append(part(t) if part is not None else t)
            if made is not None:
                made[i] = None
        return out

    def close(self, failed: bool, last: bool, mark=None) -> tuple:
        """Close a call on every rank: whether it ``failed`` on any rank,
        and rank 0's ``last`` (whether the window ends with it).  ``mark``
        (a CUDA event) is recorded once every rank has come: this rank's
        card is idle then (it was waited for), so the event keeps that
        time."""
        self._flags[0], self._flags[1] = float(failed), float(last and self.rank == 0)
        dist.all_reduce(self._flags, op=dist.ReduceOp.MAX, group=self._host)
        if mark is not None:
            mark.record()
            mark.synchronize()
        return bool(self._flags[0]), bool(self._flags[1])

    def barrier(self) -> None:
        self.close(False, False)

    def gather(self, obj) -> list:
        """Every rank's ``obj``, by rank."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self._host)
        return out

    def share(self, obj):
        """Rank 0's ``obj``, on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, 0, group=self._host)
        return box[0]

    def mean(self, name: str, value):
        """The mean over the ranks that read ``value`` (None where none
        did); rank 0 writes each rank's reading to standard error."""
        values = self.gather(value)
        if self.rank == 0:
            print(f"{name} by rank: {values}", file=sys.stderr)
        read = [v for v in values if v is not None]
        return sum(read) / len(read) if read else None

    def end(self) -> None:
        dist.destroy_process_group()
