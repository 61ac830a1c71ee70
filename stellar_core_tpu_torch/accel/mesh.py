"""Device-per-range mesh assignment for parallel catchup.

The production path that multiplies throughput is N `catchup-range`
subprocess workers, each pinned to ONE card so that ranges do not all
contend for card 0.  Pinning happens entirely through the worker's
environment, threaded into the subprocess command line by
catchup/parallel.py like the PYTHONPATH pin: the variables are in place
before the worker's Python starts, so torch sees only its assigned card.

The port's own counterpart of stellar_core_tpu/accel/mesh.py, for CUDA:

* ``cuda`` — ``CUDA_VISIBLE_DEVICES=<card>``, where the card is the
  index-th of the cards this process sees (its own
  ``CUDA_VISIBLE_DEVICES`` list, else 0..device_count-1), round-robin:
  with one card every worker gets that card.
* ``cpu``  — ``CUDA_VISIBLE_DEVICES=`` (empty): the worker sees no card
  and runs the plain versions it is asked for (``--accel cpu``).

``STPU_DEVICE_INDEX`` / ``STPU_DEVICE_COUNT`` always ride along so the
worker can report its assignment in the stitch record.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

ENV_DEVICE_INDEX = "STPU_DEVICE_INDEX"
ENV_DEVICE_COUNT = "STPU_DEVICE_COUNT"
ENV_VISIBLE = "CUDA_VISIBLE_DEVICES"


def resolve_platform(explicit: str = "auto") -> str:
    """The platform the mesh env should pin for: an explicit choice wins
    ("gpu" is taken for "cuda"); "auto" is "cuda" where torch sees a card,
    else "cpu"."""
    if explicit and explicit != "auto":
        return "cuda" if explicit == "gpu" else explicit
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


def visible_cards() -> List[str]:
    """The ids of the cards this process may hand out: its own
    CUDA_VISIBLE_DEVICES entries, else one a card torch counts."""
    raw = os.environ.get(ENV_VISIBLE)
    if raw is not None:
        return [c.strip() for c in raw.split(",") if c.strip()]
    import torch
    return [str(i) for i in range(torch.cuda.device_count())]


def worker_device_env(index: int, total: int,
                      platform: str = "auto") -> Dict[str, str]:
    """Environment additions pinning one range worker to one card
    (round-robin callers pass index = spec.index % total)."""
    platform = resolve_platform(platform)
    env = {ENV_DEVICE_INDEX: str(index), ENV_DEVICE_COUNT: str(total)}
    if platform == "cuda":
        cards = visible_cards()
        env[ENV_VISIBLE] = cards[index % len(cards)] if cards else str(index)
    elif platform == "cpu":
        env[ENV_VISIBLE] = ""
    else:
        raise ValueError(f"unknown mesh platform {platform!r} "
                         "(know: auto, cuda, gpu, cpu)")
    return env


def assigned_device_index() -> Optional[int]:
    """The worker side: the device index this process was pinned to by
    worker_device_env, or None when unpinned."""
    raw = os.environ.get(ENV_DEVICE_INDEX)
    if raw is None:
        return None
    try:
        return int(raw)
    except ValueError:
        return None
