"""Nothing the benchmark runs loads JAX or the JAX package, and its
reference loads nothing of the port.  Module names are compared by their
top-level part whole: stellar_core_tpu_torch begins with stellar_core_tpu."""

import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {root!r})
names = []
for base in {packages!r}:
    pkg = importlib.import_module(base)
    names.append(base)
    for m in pkgutil.walk_packages(pkg.__path__, base + "."):
        if ".tests" in m.name:
            continue
        importlib.import_module(m.name)
        names.append(m.name)
{extra}
print(json.dumps({{"imported": names,
                   "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def _probe(packages, extra=""):
    code = _PROBE.format(root=str(ROOT), packages=packages, extra=extra)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(ROOT), timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_benchmark_loads_no_jax():
    """Every module of portbench, the runners' program modules with them,
    in a fresh interpreter."""
    extra = ("from portbench.runners import catchup, validator\n"
             "import stellar_core_tpu_torch.catchup.catchup\n"
             "import stellar_core_tpu_torch.main.commandline\n"
             "for f in sorted((__import__('pathlib').Path({b!r}) / 'metrics')"
             ".glob('*.py')):\n"
             "    from portbench.lib import harness\n"
             "    harness.metric_reader(f.stem)\n").format(b=str(BENCH))
    got = _probe(["portbench"], extra)
    assert "portbench.run" in got["imported"]
    assert "portbench.refcore.ledger.manager" in got["imported"]
    for name in ("jax", "jaxlib", "flax", "stellar_core_tpu"):
        assert name not in got["top"], name


def test_reference_loads_nothing_of_the_port():
    """The frozen reference and the benchmark's own arithmetic and inputs
    (lib/ but the harness, which reads the port's counters) import nothing
    whose top-level name is stellar_core_tpu_torch, nor torch."""
    extra = ("from portbench.lib import (archive, ledgers, peaks, signer, "
             "txclient)\n")
    got = _probe(["portbench.refcore"], extra)
    assert "stellar_core_tpu_torch" not in got["top"]
    assert "torch" not in got["top"]
    assert "stellar_core_tpu" not in got["top"]
