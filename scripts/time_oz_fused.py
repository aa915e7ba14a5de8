"""Time K7 oz_fused on the card at P4's shape, whole and with one part
taken out at a time.

    python3 scripts/time_oz_fused.py [--rounds 3]

from the root of a checkout, on a machine with a CUDA card.  It builds the
kernels, prints the card (nvidia-smi) and the registers, shared memory and
spills of K7's two kernels (ptxas), then times, in turns for `rounds`
rounds, at M, K, O = 2016, 1024, 256 (probe4's inputs):

  * the whole call (pack, then the main kernel): eager (CUDA events over
    20 calls, the wrapper's host path included), on the device (20 calls
    in a CUDA graph) and with the L2 cold (chip_smoke.cold_ms, which
    writes 256 MB before each call, so the L2 holds dirty lines that are
    written back during the call; and once more after a read of 256 MB
    instead, which leaves the L2 clean: cold_read_ms);
  * the pack kernel alone on the device;
  * the pack and a variant of the main kernel on the device, for each part
    taken out (rt_oz_fused_ablate): the peel arithmetic, the wgmma, the
    copies of the slices (and the wait for them), the copies of W, and
    both copies.  What a part costs is the whole call's device time less
    the variant's.

The readings go to chiprun_out/time_oz_fused.json.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

DROPS = {"peel": 1, "mma": 2, "slice copies": 4, "W copies": 8,
         "both copies": 12}


def ptxas_lines(log: str) -> dict:
    """{kernel: 'N registers, S bytes smem, spill ...'} of oz_* kernels."""
    out = {}
    for block in re.split(r"(?=ptxas info    : Compiling entry function)",
                          log):
        name = re.search(r"entry function '([^']+)'", block)
        if not name or "oz_" not in name.group(1):
            continue
        kernel = re.search(r"(oz_\w+?_kernel)", name.group(1)).group(1)
        drop = re.search(r"kernelILi(\d+)E", name.group(1))
        key = kernel + (f"<{drop.group(1)}>" if drop else "")
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        out[key] = dict(registers=int(regs.group(1)) if regs else None,
                        spill_stores=int(spill.group(1)) if spill else None,
                        spill_loads=int(spill.group(2)) if spill else None)
    return out


def cold_read_ms(fn, calls: int = 21, flush_mb: int = 256) -> float:
    """chip_smoke.cold_ms with the L2 emptied by reading flush_mb MB (a
    sum) instead of writing them: median device ms of fn() over `calls`."""
    import torch
    flush = torch.ones(flush_mb * 2 ** 18, dtype=torch.float32,
                       device="cuda")
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(calls):
        flush.sum()
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_oz_fused: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from redtime_tpu_torch import probes
    from redtime_tpu_torch.kernels import build
    from redtime_tpu_torch.kernels import probes as kp

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    card = cs.card_line()
    print(f"card: {card}")
    build.build()
    regs = ptxas_lines(build.BUILD_LOG.get("output", ""))
    print(f"ptxas: {regs or 'not rebuilt in this process'}")
    lib = build.lib()
    _, xh, xl, ws = probes.probe4_inputs("cuda")
    M, K = xh.shape
    O = ws.shape[2]
    on_card = kp.oz_plan_on_card(M, K, O)
    print(f"oz_fused_kernel: {on_card['threads']} threads, "
          f"{on_card['smem_bytes']} bytes of dynamic shared memory")
    plan = kp.oz_plan(M, K, O)
    sync = torch.empty(plan["sync_words"], dtype=torch.int32, device="cuda")
    ring = torch.empty(plan["ring_bytes"], dtype=torch.uint8, device="cuda")
    oh = torch.empty((M, O), dtype=torch.float32, device="cuda")
    ol = torch.empty_like(oh)

    def variant(drop):
        def call():
            # the current stream: graph_ms warms up on a side stream and
            # captures on its own
            wp = kp.oz_pack_w(ws, sync)
            build.check(lib.rt_oz_fused_ablate(
                xh.data_ptr(), xl.data_ptr(), wp.data_ptr(),
                ring.data_ptr(), sync.data_ptr(), oh.data_ptr(),
                ol.data_ptr(), M, K, O, drop,
                torch.cuda.current_stream().cuda_stream), "oz_fused_ablate")
        return call

    whole = lambda: kp.oz_fused(xh, xl, ws)
    runs = {k: [] for k in ["eager", "device", "cold", "cold_read", "pack"]
            + [f"without {d}" for d in DROPS]}
    for _ in range(args.rounds):
        runs["eager"].append(cs.time_ms(whole))
        runs["device"].append(cs.graph_ms(whole))
        runs["cold"].append(cs.cold_ms(whole)[0])
        runs["cold_read"].append(cold_read_ms(whole))
        runs["pack"].append(cs.graph_ms(lambda: kp.oz_pack_w(ws, sync)))
        for name, drop in DROPS.items():
            runs[f"without {name}"].append(cs.graph_ms(variant(drop)))
    med = {k: float(np.median(v)) for k, v in runs.items()}
    bound = cs.least_time(float(2 * 4 * M * K + 4 * K * O + 2 * 4 * M * O),
                          6.0 * 2.0 * M * K * O, cs.PEAK_INT8_TC)
    print(f"K7 at (M, K, O) = ({M}, {K}, {O}), ms, medians of "
          f"{args.rounds} rounds: eager {med['eager']:.5f}, device "
          f"{med['device']:.5f}, cold {med['cold']:.5f} (after a read "
          f"flush {med['cold_read']:.5f}), pack alone "
          f"{med['pack']:.5f}; bound {bound['bound_ms']:.5f} by "
          f"{bound['bound_by']}")
    for name in DROPS:
        t = med[f"without {name}"]
        print(f"  without {name}: {t:.5f} ms device (the part: "
              f"{med['device'] - t:.5f} ms)")
    out = dict(card=card, shape=[M, K, O], ptxas=regs, plan=on_card,
               bound=bound,
               medians=med, runs=runs)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "time_oz_fused.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
