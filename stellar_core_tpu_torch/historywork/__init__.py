"""Work units for history archive I/O and catchup (reference: src/historywork/)."""

from .works import (ApplyCheckpointWork, CatchupWork,
                    GetAndVerifyCheckpointWork)

__all__ = ["ApplyCheckpointWork", "CatchupWork",
           "GetAndVerifyCheckpointWork"]
