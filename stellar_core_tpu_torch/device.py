"""Where the port runs: one place that resolves the device, and the split
of a batch over several.

Entry points run on CUDA unless the caller passes ``device="cpu"``, which
selects the plain PyTorch versions of the kernels.  With no device and no
CUDA, ``resolve`` raises: the port never falls back to the CPU on its own.

The sharded forms (the JAX package's ``shard_map`` programs) split a batch
into contiguous parts, one a device of a list (``parts``); a device may
appear more than once, and its shards then share the card, each on a
stream of its own (``Shards``).
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple

import numpy as np
import torch


def resolve(device=None) -> torch.device:
    """The torch.device an entry point runs on.  None means the current
    CUDA device, and raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on CUDA unless the caller "
                "passes device='cpu'")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy array -> tensor on `device`.  A CUDA copy goes through pinned
    memory and is only enqueued on the current stream (no host sync)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def resolve_all(devices: Sequence) -> Tuple[torch.device, ...]:
    """Each of `devices` resolved; all CPU or all CUDA."""
    devs = tuple(resolve(d) for d in devices)
    if not devs:
        raise ValueError("devices is empty")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"devices mixes the CPU and CUDA: {devs}")
    return devs


def resolve_shards(device=None, devices=None) -> Tuple[torch.device, ...]:
    """The devices a sharded entry point splits its batch over: `devices`
    (resolve_all), else `device` alone, else every visible card (the JAX
    package's default mesh over all devices, stellar_core_tpu/accel/
    ed25519.py:187-197; with one card, the current one, and without CUDA
    resolve's error)."""
    if devices is not None:
        if device is not None:
            raise ValueError("pass device or devices, not both")
        return resolve_all(devices)
    if device is not None:
        return (resolve(device),)
    first = resolve(None)
    count = torch.cuda.device_count()
    if count == 1:
        return (first,)
    return tuple(torch.device("cuda", i) for i in range(count))


def on_device(dev: torch.device):
    """A context with `dev` the current CUDA device (nothing on the CPU):
    the kernels launch on the current device."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def current_streams(devices: Sequence[torch.device]) -> dict:
    """{card: the calling thread's current stream on it} for the CUDA
    devices of `devices` (empty on the CPU).  Torch keeps the current
    stream per thread: a job handed to another thread takes these along
    and runs under them (``using``)."""
    return {d: torch.cuda.current_stream(d)
            for d in dict.fromkeys(devices) if d.type == "cuda"}


@contextlib.contextmanager
def using(devices: Sequence[torch.device], streams: dict):
    """Run the body with `streams` (current_streams of another thread) the
    current streams of their cards and the first of `devices` the current
    device, whatever thread runs it."""
    with contextlib.ExitStack() as stack:
        for stream in streams.values():
            stack.enter_context(torch.cuda.stream(stream))
        stack.enter_context(on_device(devices[0]))
        yield


def parts(n: int, k: int) -> List[Tuple[int, int]]:
    """k contiguous (lo, hi) parts of range(n), in order, sizes differing
    by at most one (the larger first); a part may be empty."""
    q, r = divmod(n, k)
    out, lo = [], 0
    for i in range(k):
        hi = lo + q + (i < r)
        out.append((lo, hi))
        lo = hi
    return out


class Shards:
    """One shard a device of `devices`.  A lone shard runs on its device's
    current stream, as an unsharded call does.  Several shards each get a
    side stream of their own, so that shards sharing a card run
    concurrently: ``on`` forks a shard's stream from the device's current
    stream, ``join`` joins it back, and ``use`` marks the tensors made
    elsewhere that a side stream reads."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = tuple(devices)
        many = len(self.devices) > 1
        self.streams = tuple(
            torch.cuda.Stream(device=d) if many and d.type == "cuda" else None
            for d in self.devices)

    def __len__(self) -> int:
        return len(self.devices)

    @contextlib.contextmanager
    def on(self, k: int):
        """Run the body as shard k: its device current and its stream the
        current stream, after the work already queued on the device's
        current stream (tables built there).  Tensors made in the body
        belong to the shard's stream.  Yields the device."""
        dev, stream = self.devices[k], self.streams[k]
        with contextlib.ExitStack() as stack:
            stack.enter_context(on_device(dev))
            if stream is not None:
                stream.wait_stream(torch.cuda.current_stream(dev))
                stack.enter_context(torch.cuda.stream(stream))
            yield dev

    def use(self, k: int, *tensors: torch.Tensor) -> None:
        """Mark tensors made on another stream as used by shard k's side
        stream (record_stream), so the caching allocator does not hand
        their memory out again before that stream is done with them."""
        stream = self.streams[k]
        if stream is not None:
            for t in tensors:
                t.record_stream(stream)

    def join(self, k: int, *outputs: torch.Tensor):
        """After shard k's launches: an event recorded on its stream (None
        on the CPU).  The device's current stream waits for it, so what is
        queued there later (a table rebuilt in place, a copy of the
        outputs) runs after the shard's work, and `outputs` are marked as
        used on that stream too."""
        dev, stream = self.devices[k], self.streams[k]
        if dev.type != "cuda":
            return None
        current = torch.cuda.current_stream(dev)
        event = torch.cuda.Event()
        event.record(current if stream is None else stream)
        if stream is not None:
            current.wait_event(event)
            for t in outputs:
                t.record_stream(current)
        return event
