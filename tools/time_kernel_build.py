"""Time the build of the port's hand kernel, checkout by checkout, on one host.

    python3 tools/time_kernel_build.py ROOT [ROOT ...]

Each ROOT is a checkout of this repo (say, a ``git archive`` of another
commit unpacked into a git-ignored directory). For each ROOT, in the order
given, the script empties ``ROOT/qfedx_tpu_torch/ops/csrc/_build`` and
times ``qfedx_tpu_torch.ops.scan_body.load_kernel()`` of that checkout in
a fresh Python process: every nvcc process the build starts and the load
of what it built. Give the roots as A B B A to see the host's drift.
It prints the card's name and power limit, one line per build and, last,
one JSON object with the seconds of each build by root.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

_TIMED = (
    "import time; t0 = time.perf_counter(); "
    "from qfedx_tpu_torch.ops import scan_body; scan_body.load_kernel(); "
    "print(time.perf_counter() - t0)"
)


def build_seconds(root: Path) -> float:
    """One build and load of ``root``'s kernel from an empty build dir."""
    shutil.rmtree(root / "qfedx_tpu_torch/ops/csrc/_build",
                  ignore_errors=True)
    proc = subprocess.run([sys.executable, "-c", _TIMED], cwd=root,
                          capture_output=True, text=True, check=True)
    return float(proc.stdout.strip().splitlines()[-1])


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(card.stdout.strip().splitlines()[0])
    out: dict[str, list[float]] = {}
    for root in argv:
        t0 = time.perf_counter()
        secs = build_seconds(Path(root).resolve())
        wall = time.perf_counter() - t0
        print(f"[build-time] {root}: load_kernel {secs:.2f} s "
              f"({wall:.2f} s with the process)")
        out.setdefault(root, []).append(secs)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
