"""The port stands alone: importing every module of ``qfedx_tpu_torch``
loads neither ``jax`` nor any module of the ``qfedx_tpu`` reference.

Runs in a fresh subprocess (this test process has both loaded already).
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import qfedx_tpu_torch
names = sorted(
    m.name for m in pkgutil.walk_packages(
        qfedx_tpu_torch.__path__, prefix="qfedx_tpu_torch."
    )
)
for name in names:
    importlib.import_module(name)
leaked = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "qfedx_tpu"
    or m.startswith("qfedx_tpu.")
)
print(json.dumps({"modules": names, "leaked": leaked}))
"""


def test_port_imports_no_jax_and_no_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["leaked"] == []
    # Every module of the slice was imported (a module that failed to
    # import would have raised above).
    for mod in ("ops.scan_body", "ops.fuse", "models.vqc", "serve.engine",
                "serve.batcher", "utils.retry", "utils.trees", "fed.config",
                "fed.sampling", "fed.client", "fed.round", "fed.evaluate",
                "data.stream", "utils.faults", "utils.host",
                "data.idx", "data._iris", "data.synthetic", "data.datasets",
                "data.partition", "data.pipeline", "run.config",
                "run.metrics", "run.checkpoint", "run.trainer", "run.cli",
                "__main__"):
        assert f"qfedx_tpu_torch.{mod}" in report["modules"]
