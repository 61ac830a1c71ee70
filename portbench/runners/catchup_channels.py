"""Catchup replay of an archive in which payment services submit through
channel accounts (lib/channels.py), by the port's CatchupManager: the
window, the passes and the comparison are runners/catchup.py's; only the
archive that set-up makes differs."""

from __future__ import annotations

import os
import shutil

from ..lib import channels
from . import catchup


class Cell(catchup.Cell):
    def setup(self) -> None:
        shutil.rmtree(self.workdir, ignore_errors=True)
        os.makedirs(self.workdir)
        self.ref = channels.generate(self.cfg["archive"], self.seed,
                                     self.workdir)
        from stellar_core_tpu_torch.history.archive import FileHistoryArchive
        self.fa = FileHistoryArchive(self.ref["archive"])
        self.first, self.last = self.ref["replay"]
        # the warm pass: builds and loads the kernels, and every key table
        # the window uses, since its one verify group holds the whole
        # checkpoint's signatures, so no pass of the window launches K-B
        # (its closes are not recorded)
        self._replay(self.first - 1 + self.mix["warm_ledgers"])
