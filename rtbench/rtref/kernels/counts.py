"""Launch counters of the hand-written kernels.

Each wrapper adds one to its counter where it launches its kernel on the
card, and nowhere else (the plain PyTorch path on CPU tensors does not
count), so a run can show that the main path went through the kernels.
`mark(phase)` books the launches since the last mark to a phase of the
run (run_batch marks "prepare" and "solve"), so the counts of a kernel
that several phases launch can be told apart.  `add` books the launches
that a worker process counted (driver.run_batch(devices=...)) here.
"""

from __future__ import annotations

LAUNCHES = {"engine_front": 0, "tab_leg": 0, "out_leg": 0, "pz_leg": 0,
            "rk_finish": 0, "rk_stage": 0, "rhs_tail": 0, "out_block": 0,
            "affine": 0,
            "int8_dot": 0, "dd_mul": 0, "oz_pack_w": 0, "oz_fused": 0}

PHASES: dict = {}        # phase -> launches booked to it by mark()
_marked = dict(LAUNCHES)


def reset() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    PHASES.clear()
    _marked.update(LAUNCHES)


def mark(phase: str) -> None:
    """Book the launches since the last mark (or reset) to `phase`."""
    booked = PHASES.setdefault(phase, dict.fromkeys(LAUNCHES, 0))
    for name, count in LAUNCHES.items():
        booked[name] += count - _marked[name]
    _marked.update(LAUNCHES)


def add(launches: dict, by_phase: dict) -> None:
    """Add another process's launches, and its launches by phase, to the
    counts here (they do not count again at the next mark)."""
    for name, count in launches.items():
        LAUNCHES[name] += count
        _marked[name] += count
    for phase, booked in by_phase.items():
        mine = PHASES.setdefault(phase, dict.fromkeys(LAUNCHES, 0))
        for name, count in booked.items():
            mine[name] += count


def snapshot() -> dict:
    return dict(LAUNCHES)


def phases() -> dict:
    return {phase: dict(booked) for phase, booked in PHASES.items()}
