"""Build and run scripts/sm90_probe.cu on the card: the measurements behind
K7 oz_fused's design (the 8-bit wgmma operand layout, distributed shared
memory and L2 bulk-copy rates, how many clusters of K7's size fit, and
K7's stage copies alone with and without multicast).

    python3 scripts/sm90_probe.py

from the root of a checkout, on a machine with a CUDA card and nvcc.  It
prints the card (nvidia-smi) and the probe's lines, and writes them to
chiprun_out/sm90_probe.txt.
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    from redtime_tpu_torch.kernels import build

    out_dir = os.path.join(HERE, "build", "sm90_probe")
    os.makedirs(out_dir, exist_ok=True)
    exe = os.path.join(out_dir, "sm90_probe")
    subprocess.run([build.nvcc_path(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-o", exe, os.path.join(HERE, "scripts", "sm90_probe.cu")],
                   check=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    run = subprocess.run([exe], capture_output=True, text=True, timeout=300)
    text = f"card: {card}\n{run.stdout}"
    print(text, end="")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "sm90_probe.txt"), "w") as f:
        f.write(text)
    return run.returncode


if __name__ == "__main__":
    sys.exit(main())
