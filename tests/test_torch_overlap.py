"""The port's worker processes on the CPU (redtime_tpu_torch/worker.py):
the prepare worker and the host-prepare overlap of the chunked scheduler
(the counterpart of redtime_tpu/driver.py:520-531), the faults a worker
can have, and `batch --shard`.

Inputs: five design cosmologies, 1-loop at nk=16 (tests/test_sharding.py's
tiny config); max_chunk=2 makes three chunks.  The prepare worker runs the
same code as the caller on one torch thread on the same host, so its
Model, and every result, is held to the caller's bit for bit.  Delays
and faults are injected here, in the test: a stand-in for the worker's
command (worker.argv) or a wrapper of the caller's prepare.  Every wait
on a worker has a time limit (deadline, or receive's timeout).
"""

import os
import pickle
import struct
import subprocess
import sys

import pytest
import torch

import chip_smoke
from torch_port_util import deadline
from redtime_tpu_torch import cli
from redtime_tpu_torch import driver as td
from redtime_tpu_torch import worker
from redtime_tpu_torch.config import RunSettings as TSet
from redtime_tpu_torch.config import SolverConfig as TCfg
from redtime_tpu_torch.profiling import StageTimer

CFG = TCfg(nk=16, np_factor=4, growth_n_lna=10, growth_n_lnk=6,
           quad_panels=8, quad_order=8)
SETTINGS = TSet(z_out=(1.0, 0.0))
N, CHUNK = 5, 2
WAIT_S = 300
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(n: int = N):
    return chip_smoke.design_inputs(n)


def _chunk(i0: int, size: int = CHUNK):
    cs, lins = _inputs()
    return ([td._take(td._host(x), i0, size) for x in cs],
            [td._take(td._host(x), i0, size) for x in lins], None)


def _child_script(body: str) -> list:
    """A stand-in for worker.argv: python -c `body`, then the worker's
    own loop."""
    return [sys.executable, "-c",
            body + "\nfrom redtime_tpu_torch import worker as w\n"
            "raise SystemExit(w.main())\n"]


def _run(**kw):
    timer = StageTimer(enabled=False)
    cs, lins = _inputs()
    with deadline(WAIT_S):
        res = td.run_batch(CFG, SETTINGS, cs, lins, device="cpu",
                           max_chunk=CHUNK, timer=timer, **kw)
    return res, timer


def _inline_loop():
    """The chunked scheduler spelled out: each chunk prepared in this
    process, then solved, then the lanes concatenated."""
    ec = td.engine_consts(CFG, "cpu")
    outs = []
    for i0 in range(0, N, CHUNK):
        m = td._prepare(CFG, _chunk(i0), torch.device("cpu"), True)
        outs.append(td._solve(CFG, SETTINGS, m, ec)[0])
    return td.RunResult(*[torch.cat(xs)[:N] for xs in zip(*outs)])


def test_prepare_worker_model_equals_the_callers(tmp_path, monkeypatch):
    """The Model a prepare worker sends back, rebuilt by
    state.model_from_numpy, equals driver._prepare_chunk in this process
    on one thread bit for bit; the worker prepared on one torch thread
    and imports no JAX and nothing of the JAX package (a sys.modules
    check in the child at its exit)."""
    seen, threads = tmp_path / "modules.txt", tmp_path / "threads.txt"
    monkeypatch.setattr(worker, "argv", lambda: _child_script(
        "import atexit, sys, torch\n"
        "from redtime_tpu_torch import driver as d\n"
        f"atexit.register(lambda: open({str(seen)!r}, 'w').write(' '.join("
        "m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
        "'redtime_tpu.')))))\n"
        "real = d._prepare_chunk\n"
        "def counting(*args):\n"
        f"    open({str(threads)!r}, 'a').write(str(torch.get_num_threads()))\n"
        "    return real(*args)\n"
        "d._prepare_chunk = counting"))
    chunk = _chunk(2)
    with worker.Worker("prepare worker") as w:
        assert w.ready(WAIT_S)
        w.send("prepare", cfg=CFG, chunk=chunk)
        m_np, secs = w.receive(timeout=WAIT_S)
    assert secs > 0
    got = td.model_from_numpy(m_np)
    with td._torch_threads(1):
        ref = td._prepare_chunk(CFG, chunk, "cpu")
    for a, b in zip(list(got.cosmo) + list(got[1:]),
                    list(ref.cosmo) + list(ref[1:])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert seen.read_text() == ""
    assert threads.read_text() == "1"
    assert not chip_smoke.child_pids()


def _prepared_once_ready(monkeypatch):
    """Make the caller's first prepare wait until the prepare worker is
    ready, so the worker prepares every later chunk: returns the list of
    workers started."""
    started = []
    real_init, real_prepare = worker.Worker.__init__, td._prepare

    def init(self, name):
        real_init(self, name)
        started.append(self)

    def prepare(*args):
        if started and started[0].start_s is None:
            started[0].ready(WAIT_S)
        return real_prepare(*args)

    monkeypatch.setattr(worker.Worker, "__init__", init)
    monkeypatch.setattr(td, "_prepare", prepare)
    return started


def test_overlap_equals_the_inline_loop(monkeypatch):
    """Three chunks with host prepare: the caller prepares chunk 0, the
    worker chunks 1 and 2 while chunk 0 and 1 are solved; the result
    equals the inline loop bit for bit, and the timer books the wait
    ("prepare"), the solve, the worker's seconds and the hidden ones."""
    started = _prepared_once_ready(monkeypatch)
    res, timer = _run(prepare_on_host=True)
    ref = _inline_loop()
    for a, b in zip(res, ref):
        assert torch.equal(a, b)
    stats = timer.stats
    assert len(started) == 1
    assert stats["prepared_by"] == ["caller", "worker", "worker"]
    assert stats["worker_start_s"] > 0 and stats["prepare_worker_s"] > 0
    assert 0 <= stats["prepare_hidden_s"] <= stats["prepare_worker_s"]
    assert timer.times["prepare"] > 0 and timer.times["solve"] > 0
    assert len(stats["attempts"]) == N
    assert not chip_smoke.child_pids()


def test_caller_prepares_while_the_worker_starts(monkeypatch):
    """A worker that takes 3 s to start: the caller prepares chunk 0 (and
    any chunk it reaches before the worker is ready) itself; the result
    is the same bits."""
    monkeypatch.setattr(worker, "argv", lambda: _child_script(
        "import time; time.sleep(3)"))
    res, timer = _run(prepare_on_host=True)
    by = timer.stats["prepared_by"]
    assert by[0] == "caller" and len(by) == 3
    start = timer.stats["worker_start_s"]
    assert start is None or start >= 3
    for a, b in zip(res, _inline_loop()):
        assert torch.equal(a, b)
    assert not chip_smoke.child_pids()


def test_a_ready_worker_takes_the_next_chunk_first(monkeypatch):
    """A worker that is ready only once chunk 0 is being solved (a 2 s
    start, and chunk 0's solve waits for it): the caller hands chunk 2 to
    it before preparing chunk 1 itself, so both are prepared at once; the
    result is the same bits."""
    started = []
    real_init, real_solve = worker.Worker.__init__, td._solve

    def init(self, name):
        real_init(self, name)
        started.append(self)

    def solve(*args):
        started[0].ready(WAIT_S)
        return real_solve(*args)

    monkeypatch.setattr(worker, "argv", lambda: _child_script(
        "import time; time.sleep(2)"))
    monkeypatch.setattr(worker.Worker, "__init__", init)
    monkeypatch.setattr(td, "_solve", solve)
    res, timer = _run(prepare_on_host=True)
    assert timer.stats["prepared_by"] == ["caller", "caller", "worker"]
    assert timer.stats["worker_start_s"] >= 2
    for a, b in zip(res, _inline_loop()):
        assert torch.equal(a, b)
    assert not chip_smoke.child_pids()


def test_no_worker_without_host_prepare_or_chunks(monkeypatch):
    """Prepare on the card's side (prepare_on_host=False) and a single
    chunk start no worker."""
    started = []
    monkeypatch.setattr(worker, "Worker",
                        lambda name: started.append(name))
    res, timer = _run(prepare_on_host=False)
    assert "prepared_by" not in timer.stats
    cs, lins = _inputs()
    with deadline(WAIT_S):
        td.run_batch(CFG, SETTINGS, cs, lins, device="cpu",
                     prepare_on_host=True)
    assert started == []


def test_a_worker_that_raises(tmp_path):
    """A setting that fails only in the worker (growth_n_lna=0): run_batch
    raises WorkerError with the worker's traceback, and no child is left
    running."""
    bad = TCfg(nk=16, np_factor=4, growth_n_lna=0, growth_n_lnk=6,
               quad_panels=8, quad_order=8)
    cs, lins = _inputs(2)
    with deadline(WAIT_S), pytest.raises(worker.WorkerError) as err:
        td.run_batch(bad, SETTINGS, cs, lins, device="cpu",
                     devices=["cpu", "cpu"])
    msg = str(err.value)
    assert "shard 0 of 2 on cpu" in msg or "shard 1 of 2 on cpu" in msg
    assert "the worker raised" in msg and "IndexError" in msg
    assert not chip_smoke.child_pids()


def test_a_worker_killed_mid_run(monkeypatch):
    """A shard worker killed when its run begins: run_batch raises at
    once, naming the shard, the device and the exit code, and the other
    worker is not left running."""
    monkeypatch.setattr(worker, "argv", lambda: _child_script(
        "import os, signal\n"
        "from redtime_tpu_torch import worker as k\n"
        "def die(**kw):\n"
        "    if kw['inputs'][0][0][0] == k_first:\n"
        "        os.kill(os.getpid(), signal.SIGKILL)\n"
        "    return run(**kw)\n"
        f"k_first = {float(_inputs(2)[0][0][1])!r}\n"
        "run = k.HANDLERS['run']\n"
        "k.HANDLERS['run'] = die"))
    cs, lins = _inputs(2)
    with deadline(WAIT_S), pytest.raises(worker.WorkerError) as err:
        td.run_batch(CFG, SETTINGS, cs, lins, device="cpu",
                     devices=["cpu", "cpu"])
    assert "shard 1 of 2 on cpu" in str(err.value)
    assert "exited with code -9" in str(err.value)
    assert not chip_smoke.child_pids()


def test_receive_has_a_time_limit():
    """A worker that does not answer in time raises instead of waiting
    on; leaving the block kills it."""
    with pytest.raises(worker.WorkerError, match="no answer in 0.5 s"):
        with worker.Worker("idle worker") as w:
            assert w.ready(WAIT_S)
            w.receive(timeout=0.5)
    assert w.proc.returncode is not None
    assert not chip_smoke.child_pids()


@pytest.mark.parametrize("n, nd", [(4, 4), (6, 4), (5, 4), (7, 8), (3, 1)])
def test_shard_devices_is_jax_rule(n, nd):
    """nd is the largest divisor of the file count at most the number of
    devices (redtime_tpu/cli.py:226-229)."""
    devs = [f"cuda:{i}" for i in range(nd)]
    want = max(d for d in range(1, nd + 1) if n % d == 0)
    assert cli.shard_devices(n, devs) == devs[:want]


def test_cli_batch_shard(tmp_path, capsys):
    """`batch --shard --platform cpu` over 3 files: one worker on the CPU
    (nd = 1), the sharding line on stderr, and the same bytes as
    `batch`."""
    paths = chip_smoke.write_cli_inputs(str(tmp_path),
                                        chip_smoke.design_params(3),
                                        (2.0, 0.0))
    base = ["batch", "--platform", "cpu", "--nk", "16"]
    with deadline(WAIT_S):
        assert cli.main(base + ["-o", str(tmp_path / "plain")] + paths) == 0
        capsys.readouterr()
        assert cli.main(base + ["--shard", "-o", str(tmp_path / "shard")]
                        + paths) == 0
    assert "# sharding batch of 3 over 1 devices" in capsys.readouterr().err
    for i in range(3):
        name = f"redTime_M{i:03d}.dat"
        assert (tmp_path / "shard" / name).read_bytes() == \
            (tmp_path / "plain" / name).read_bytes()
    assert not chip_smoke.child_pids()


def test_worker_module_runs_without_jax():
    """`python -m redtime_tpu_torch.worker` says it is ready and exits
    when its input closes, with no JAX module loaded."""
    code = ("import sys, runpy; sys.argv = ['w']\n"
            "try:\n"
            "    runpy.run_module('redtime_tpu_torch.worker', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'redtime_tpu.'))]\n"
            "    sys.stderr.write(f'exit {e.code} jax {bad}')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, input=b"",
                         capture_output=True, timeout=WAIT_S)
    assert out.returncode == 0
    assert out.stderr.decode().endswith("exit 0 jax []"), out.stderr
    (size,) = struct.unpack("<Q", out.stdout[:8])     # the ready frame
    assert len(out.stdout) == 8 + size
    assert pickle.loads(out.stdout[8:])[0] == "ready"
