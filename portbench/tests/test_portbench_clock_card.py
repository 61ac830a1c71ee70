"""The program's spans and the device trace share one clock.  A probe
span opens right before a K-G launch whose inputs are already on the card,
and closes when the card has finished it; a child span brackets the launch
call alone.  On one clock, torch.profiler's interval of the kernel cannot
start before the launch call starts, nor end after the probe span ends:
each within 50 us, so a clock that reads the card early, or late, by more
than that fails.  Against a late reading the start's check allows the
launch call's own time besides; so both latencies the two checks leave
open, the kernel's start after the launch call returns and the span's end
after the kernel ends, are held under 200 us.  It probes at the process's
start, and again once the process is 90 s old, so that a drift between
the clocks would show.  Run on the card with

    python -m pytest portbench/tests -m card
"""

import gc
import hashlib
import time

import numpy as np
import pytest

_T0 = time.monotonic()
TOLERANCE_NS = 50_000
LATENCY_NS = 200_000
PROBES = 3           # at each age


def _batch(n: int):
    from portbench.lib import signer
    seeds = [bytes([i % 251, i // 251]) + bytes(30) for i in range(n)]
    pks = signer.public_keys(seeds)
    msgs = [b"clock probe %d" % i for i in range(n)]
    sigs = signer.sign_all(list(zip(seeds, pks, msgs)))
    return pks, sigs, msgs


def _kg_inputs(n: int, dev):
    """K-G's five inputs for n valid signatures, each key its own row, on
    `dev`: what the verify entry's host prep hands the kernel."""
    import torch
    from stellar_core_tpu_torch.accel.ed25519 import L, Ed25519BatchVerifier
    pks, sigs, msgs = _batch(n)
    sig = np.frombuffer(b"".join(sigs), dtype=np.uint8).reshape(n, 64)
    h = b"".join((int.from_bytes(hashlib.sha512(s[:32] + pk + m).digest(),
                                 "little") % L).to_bytes(32, "little")
                 for pk, s, m in zip(pks, sigs, msgs))
    keys = np.stack([Ed25519BatchVerifier._decode_pk(pk) for pk in pks])
    host = (sig[:, 32:], np.frombuffer(h, dtype=np.uint8).reshape(n, 32),
            np.arange(n, dtype=np.int32), keys, sig[:, :32])
    return [torch.from_numpy(np.array(a)).to(dev) for a in host]


@pytest.mark.card
def test_kernel_interval_on_the_span_clock(card):
    """One profiler session, as a traced window has: PROBES probes at the
    process's start, and PROBES once the process is 90 s old."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from stellar_core_tpu_torch.accel.ed25519 import verify_generic
    from stellar_core_tpu_torch.util import tracing

    s_raw, hh, kidx, keys, rb = _kg_inputs(2048, torch.device("cuda"))
    assert verify_generic(s_raw, hh, kidx, keys, rb).all()   # builds K-G
    torch.cuda.synchronize()
    probes = [(f"portbench.clock-probe-{age}s", age)
              for age in (0, 90) for _ in range(PROBES)]
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i, (name, age_s) in enumerate(probes):
                time.sleep(max(0.0, _T0 + age_s - time.monotonic()))
                with tracing.span(name, probe=i):
                    with tracing.span("portbench.clock-probe-launch"):
                        out = verify_generic(s_raw, hh, kidx, keys, rb)
                    torch.cuda.synchronize()
                assert out.all()
    finally:
        gc.enable()
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type().name == "CUDA"
                     and "verify_generic" in e.name())
    assert len(kernels) == len(probes), kernels
    roots = {r.args["probe"]: r for r in tracing.trace_buffer().roots()
             if r.name.startswith("portbench.clock-probe-")}
    rows = []
    for i, ((name, _), (ka, kb)) in enumerate(zip(probes, kernels)):
        [(sa, sb, _)] = [w for w in tracing.spans_between(0, 2 ** 63, name)
                         if w[2]["probe"] == i]
        launch = roots[i].children[0]
        la = sa + round((launch.start_s - roots[i].start_s) * 1e9)
        lb = la + round(launch.dur_s * 1e9)
        rows.append((la, lb, ka, kb, sb))
        print(f"{name} #{i} on {card}: kernel {(kb - ka) / 1e3:.1f} us; its "
              f"start {(ka - la) / 1e3:.1f} us after the launch call's "
              f"start and {(ka - lb) / 1e3:.1f} us after its end (the call "
              f"{(lb - la) / 1e3:.1f} us); its end {(sb - kb) / 1e3:.1f} us "
              f"before the span's end")
    for la, lb, ka, kb, sb in rows:
        assert la - TOLERANCE_NS <= ka and kb <= sb + TOLERANCE_NS
        assert ka - lb <= LATENCY_NS and sb - kb <= LATENCY_NS
