"""``python -m stellar_core_tpu_torch <command>``: the command line
(main/commandline.py)."""

import sys

from .main.commandline import main

if __name__ == "__main__":
    sys.exit(main())
