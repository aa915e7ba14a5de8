"""Worker processes of the batch driver: the port's counterpart of the
JAX package's device mesh and of its host-prepare overlap.

A worker is a child process started as

    python -m redtime_tpu_torch.worker

(never by `multiprocessing`: a spawned child re-runs the caller's
unguarded script, and a forked one inherits a started CUDA context).  It
imports torch and this package only, says it is ready, then answers
requests, one at a time, until its input closes:

  * prepare: `driver._prepare_chunk` of one chunk (cs, lins, norm: numpy
    rows) on the host CPU, on one torch thread, as the caller would run
    it; the answer is the Model's fields as numpy and the seconds taken;
  * run: `driver.run_batch` of one shard on one device with the caller's
    settings; the answer is the RunResult as numpy, the timer's stages and
    stats, its wall on the device, and the launch counts of
    `kernels.counts` for the shard.

Requests and answers are pickled (numpy arrays and plain values) and
framed by an 8-byte length, on the child's stdin and on a copy of its
stdout (the child's own stdout goes to its stderr, so a print cannot
break a frame).  An exception in a handler goes back as its traceback
and the worker waits for the next request.

The parent side is `Worker`: it polls the child whenever it waits, so a
child that dies raises `WorkerError` with its exit code instead of
hanging the caller, and a child that raised raises `WorkerError` with its
traceback.  `Worker` is a context manager: leaving the block closes the
child, or kills it when the block raised.  A worker whose parent dies
sees its input close and exits.
"""

from __future__ import annotations

import os
import pickle
import select
import struct
import subprocess
import sys
import time
import traceback

_HEADER = struct.Struct("<Q")
# how often a wait looks at the child's exit status, seconds
POLL_S = 0.2
# how long close() lets a child exit on its own before it is killed
CLOSE_S = 30.0


class WorkerError(RuntimeError):
    """A worker raised (the message carries its traceback) or died."""


def argv() -> list:
    """The command that starts a worker."""
    return [sys.executable, "-m", "redtime_tpu_torch.worker"]


def _env() -> dict:
    """The caller's environment with the directory that holds this
    package first on PYTHONPATH, so the child imports the same code."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    return env


def _write(fd: int, obj) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    view = memoryview(_HEADER.pack(len(data)) + data)
    while view:
        view = view[os.write(fd, view):]


def _read_exact(fd: int, size: int) -> bytes | None:
    """size bytes from fd; None at end of file."""
    parts, left = [], size
    while left:
        part = os.read(fd, min(left, 1 << 20))
        if not part:
            return None
        parts.append(part)
        left -= len(part)
    return b"".join(parts)


def _read(fd: int):
    """One framed object from fd: (True, obj), or (False, None) at end of
    file."""
    head = _read_exact(fd, _HEADER.size)
    if head is None:
        return False, None
    data = _read_exact(fd, _HEADER.unpack(head)[0])
    if data is None:
        return False, None
    return True, pickle.loads(data)


class Worker:
    """One worker process, seen from its parent.  `name` says what it
    does (for example "shard 1 of 2 on cuda:0"); it is in every error."""

    def __init__(self, name: str):
        self.name = name
        self._t0 = time.time()
        # seconds from the start to the child's ready message (its clock
        # and ours are the host's)
        self.start_s: float | None = None
        self.proc = subprocess.Popen(argv(), stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, bufsize=0,
                                     env=_env())

    def __enter__(self) -> "Worker":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self.kill()

    def _died(self) -> WorkerError:
        try:
            code = self.proc.wait(timeout=CLOSE_S)
        except subprocess.TimeoutExpired:
            self.kill()
            code = self.proc.returncode
        return WorkerError(f"{self.name}: worker (pid {self.proc.pid}) "
                           f"exited with code {code}")

    def _readable(self, timeout: float | None) -> bool:
        """Whether a frame (or the end of the child's output) waits to be
        read, looking at the child's exit status every POLL_S seconds for
        at most `timeout` seconds (None: until it answers or dies)."""
        fd = self.proc.stdout.fileno()
        end = None if timeout is None else time.perf_counter() + timeout
        while True:
            tick = POLL_S if end is None else max(
                0.0, min(POLL_S, end - time.perf_counter()))
            if select.select([fd], [], [], tick)[0]:
                return True
            if self.proc.poll() is not None:
                # its last frame, or the end of its output, can be read
                return True
            if end is not None and time.perf_counter() >= end:
                return False

    def _next(self):
        """The next frame from the child, which is readable."""
        ok, msg = _read(self.proc.stdout.fileno())
        if not ok:
            raise self._died()
        return msg

    def ready(self, timeout: float = 0.0) -> bool:
        """Whether the child has said it is ready (waiting at most
        `timeout` seconds, None for as long as it takes to start);
        raises if it died while starting."""
        if self.start_s is not None:
            return True
        if not self._readable(timeout):
            return False
        kind, when = self._next()
        if kind != "ready":
            raise WorkerError(f"{self.name}: expected the ready message, "
                              f"got {kind!r}")
        self.start_s = when - self._t0
        return True

    def send(self, kind: str, **args) -> None:
        """Send one request; the child must be ready."""
        if not self.ready():
            raise WorkerError(f"{self.name}: a request sent before the "
                              "worker was ready")
        try:
            _write(self.proc.stdin.fileno(), (kind, args))
        except BrokenPipeError:
            raise self._died() from None

    def receive(self, timeout: float | None = None):
        """The answer to the last request: waits at most `timeout` seconds
        (None: until it comes), polling the child; raises WorkerError
        when the child raised, died or did not answer in time."""
        if not self._readable(timeout):
            raise WorkerError(f"{self.name}: no answer in {timeout} s")
        kind, value = self._next()
        if kind == "error":
            raise WorkerError(f"{self.name}: the worker raised:\n{value}")
        return value

    def close(self) -> None:
        """Close the child's input, so it exits, and reap it; kill it if
        it has not exited within CLOSE_S seconds, or at once if it never
        said it was ready (it holds no work then)."""
        if self.start_s is None:
            self.kill()
            return
        if self.proc.poll() is None:
            self.stop()
            try:
                self.proc.wait(timeout=CLOSE_S)
            except subprocess.TimeoutExpired:
                self.kill()
        self._release()

    def stop(self) -> None:
        """Close the child's input, so it exits when it is done with the
        request it holds, without waiting for it (close() reaps it)."""
        if not self.proc.stdin.closed:
            self.proc.stdin.close()

    def kill(self) -> None:
        """Kill the child at once and reap it."""
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self._release()

    def _release(self) -> None:
        for f in (self.proc.stdin, self.proc.stdout):
            if not f.closed:
                f.close()


def gather(workers: list) -> list:
    """The answer of every worker, in the list's order, read as they come:
    a worker that raises or dies raises at once, whatever the others are
    doing."""
    out = [None] * len(workers)
    pending = set(range(len(workers)))
    while pending:
        fds = {workers[i].proc.stdout.fileno(): i for i in pending}
        for fd in select.select(list(fds), [], [], POLL_S)[0]:
            out[fds[fd]] = workers[fds[fd]].receive()
            pending.discard(fds[fd])
        for i in list(pending):
            if workers[i].proc.poll() is not None:
                out[i] = workers[i].receive()
                pending.discard(i)
    return out


# --- the child's side ---

def _numpy(tree):
    """A NamedTuple of tensors (nested one level, as Model.cosmo) with
    numpy leaves on the host."""
    return type(tree)(*[_numpy(x) if isinstance(x, tuple)
                        else x.detach().cpu().numpy() for x in tree])


def handle_prepare(cfg, chunk) -> tuple:
    """driver._prepare_chunk of `chunk` on the host CPU on one torch
    thread: (the Model with numpy leaves, seconds)."""
    from redtime_tpu_torch import driver

    t0 = time.perf_counter()
    with driver._torch_threads(1):
        m = driver._prepare_chunk(cfg, chunk, "cpu")
    return _numpy(m), time.perf_counter() - t0


def handle_run(cfg, settings, inputs, device: str, threads: int,
               **kw) -> dict:
    """driver.run_batch of one shard (inputs: cs, lins, norm as numpy
    rows) on `device` with torch's CPU threads set to `threads`; kw goes
    to run_batch.  Answers the RunResult as numpy, the run's wall
    (synchronized), the timer's stages and stats, the launch counts and
    the counts by phase."""
    import torch

    from redtime_tpu_torch import driver
    from redtime_tpu_torch.config import CosmoParams
    from redtime_tpu_torch.io.camb import LinearData
    from redtime_tpu_torch.kernels import counts
    from redtime_tpu_torch.profiling import StageTimer, sync

    dev = torch.device(device)
    if dev.type == "cuda" and (dev.index or 0) >= torch.cuda.device_count():
        raise RuntimeError(f"device {device!r}: this machine has "
                           f"{torch.cuda.device_count()} CUDA card(s)")
    torch.set_num_threads(threads)
    cs, lins, nrm = inputs
    timer = StageTimer(enabled=False)
    counts.reset()
    t0 = time.perf_counter()
    res = driver.run_batch(cfg, settings, CosmoParams(*cs), LinearData(*lins),
                           device=dev, norm_override=nrm, timer=timer, **kw)
    sync(res.table)
    return dict(result=_numpy(res), wall_s=time.perf_counter() - t0,
                times=dict(timer.times), stats=timer.stats,
                launches=counts.snapshot(), phases=counts.phases())


HANDLERS = {"prepare": handle_prepare, "run": handle_run}


def main() -> int:
    """The worker's loop: ready, then one answer per request until the
    input closes."""
    inp = sys.stdin.fileno()
    out = os.dup(sys.stdout.fileno())
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    import redtime_tpu_torch.driver  # noqa: F401  (torch: the start waited for)

    try:
        _write(out, ("ready", time.time()))
        while True:
            ok, msg = _read(inp)
            if not ok:
                return 0
            kind, args = msg
            try:
                answer = ("ok", HANDLERS[kind](**args))
            except Exception:  # noqa: BLE001  (goes back to the parent)
                answer = ("error", traceback.format_exc())
            _write(out, answer)
    except BrokenPipeError:      # the parent is gone
        return 0


if __name__ == "__main__":
    sys.exit(main())
