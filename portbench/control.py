#!/usr/bin/env python3
"""Run one cell with a fault planted in the port (lib/faults.py), to show
that its comparison comes out not correct:

    python3 portbench/control.py --fault control --workload <cell> \
        --seed <n> --seconds <s>

The control (`--fault control`) breaks the guarantee the configurations
state, exact signature verification: every signature reads valid.  The
other faults are those the tests under portbench/tests/ plant on the CPU.
The result line is run.py's; the benchmark's own runs never plant one."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import run  # noqa: E402
from portbench.lib import faults  # noqa: E402


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--fault" not in argv:
        print("control.py: --fault NAME is required", file=sys.stderr)
        return 2
    i = argv.index("--fault")
    name = argv[i + 1]
    del argv[i:i + 2]
    import stellar_core_tpu_torch  # noqa: F401
    with faults.plant(name):
        return run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
