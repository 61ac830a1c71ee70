"""Which keys the port's verifier gives a key table (K-B + K-T) when more
keys qualify as hot than it has slots, on the plain versions on the CPU:
the most used first, ties broken by the key bytes, whatever the
process's hash seed; the signatures of hot keys that found no slot go to
K-G and count in `accel.ed25519.hot-no-slot`; the install is the
`accel.ed25519.tables-install` span inside the prep span."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from stellar_core_tpu_torch.accel import ed25519 as TE
from stellar_core_tpu_torch.crypto import sodium
from stellar_core_tpu_torch.util import metrics, tracing

ROOT = Path(__file__).resolve().parent.parent


def _batch(uses):
    """(pks, sigs, msgs, truth): key k signs uses[k] messages; every
    third signature of a key is made by another key, so it is invalid."""
    keys = [sodium.sign_seed_keypair(bytes([k + 1]) * 32)
            for k in range(len(uses))]
    pks, sigs, msgs, truth = [], [], [], []
    for k, n in enumerate(uses):
        for i in range(n):
            msg = bytes([k, i]) * 5
            signer = keys[(k + 1) % len(keys)] if i % 3 == 2 else keys[k]
            pks.append(keys[k][0])
            sigs.append(sodium.sign_detached(msg, signer[1]))
            msgs.append(msg)
            truth.append(i % 3 != 2)
    return pks, sigs, msgs, np.array(truth), [pk for pk, _ in keys]


def _counter(name):
    m = dict(metrics.registry().items()).get(name)
    return m.value if m is not None else 0


def test_most_used_keys_get_the_slots_ties_by_key_bytes():
    uses = [3, 5, 3, 4, 3, 2]
    pks, sigs, msgs, truth, keys = _batch(uses)
    v = TE.Ed25519BatchVerifier(chunk_size=64, table_slots=3,
                                hot_threshold=2, device="cpu")
    left0 = _counter("accel.ed25519.hot-no-slot")
    assert (v.verify(pks, sigs, msgs) == truth).all()
    tied = sorted(k for k, n in zip(keys, uses) if n == 3)
    want = {keys[1], keys[3], tied[0]}
    assert set(v._tables.slot_of) == want
    # the other two keys of three uses and the key of two found no slot
    assert _counter("accel.ed25519.hot-no-slot") - left0 == 3 + 3 + 2
    assert v.stats["table_sigs"] == 5 + 4 + 3
    assert v.stats["generic_sigs"] == 3 + 3 + 2
    prep = next(r for r in reversed(tracing.trace_buffer().roots())
                if r.name == "accel.ed25519.prep")
    install = [c for c in prep.children
               if c.name == "accel.ed25519.tables-install"]
    assert len(install) == 1
    assert {k: install[0].args[k] for k in ("asked", "built", "no_slot")} \
        == {"asked": 6, "built": 3, "no_slot": 3}


def test_every_key_that_found_a_slot_keeps_it_while_it_is_used():
    """A second batch of the same keys builds nothing: every installed key
    is in the batch, so none is evicted, and the keys left without a slot
    stay on K-G."""
    uses = [3, 5, 3, 4, 3, 2]
    pks, sigs, msgs, truth, _ = _batch(uses)
    v = TE.Ed25519BatchVerifier(chunk_size=64, table_slots=3,
                                hot_threshold=2, device="cpu")
    v.verify(pks, sigs, msgs)
    slots = dict(v._tables.slot_of)
    left0 = _counter("accel.ed25519.hot-no-slot")
    assert (v.verify(pks, sigs, msgs) == truth).all()
    assert v._tables.slot_of == slots and v.stats["tables_built"] == 3
    assert _counter("accel.ed25519.hot-no-slot") - left0 == 8


def test_a_batch_with_no_room_installs_nothing():
    """Two slots, both held by keys of the next batch: its two new hot keys
    find no room, so no install is made (no span) and their signatures
    count as left on K-G."""
    pks, sigs, msgs, truth, keys = _batch([3, 3])
    v = TE.Ed25519BatchVerifier(chunk_size=64, table_slots=2,
                                hot_threshold=2, device="cpu")
    v.verify(pks, sigs, msgs)
    assert set(v._tables.slot_of) == set(keys)
    more = _batch([3, 3, 3, 3])
    left0 = _counter("accel.ed25519.hot-no-slot")
    assert (v.verify(*more[:3]) == more[3]).all()
    assert set(v._tables.slot_of) == set(keys)
    assert v.stats["tables_built"] == 2
    assert _counter("accel.ed25519.hot-no-slot") - left0 == 3 + 3
    prep = next(r for r in reversed(tracing.trace_buffer().roots())
                if r.name == "accel.ed25519.prep")
    assert not [c for c in prep.children
                if c.name == "accel.ed25519.tables-install"]


def test_the_process_registry_holds_the_counter_at_zero(monkeypatch):
    """The counter is made with the process registry, so that a window in
    which every hot key found a slot reads 0, not nothing."""
    monkeypatch.setattr(metrics, "_registry", metrics.registry())
    metrics.reset_registry()
    made = dict(metrics.registry().items())
    assert made[metrics.HOT_NO_SLOT_COUNTER].value == 0


_PROBE = """
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from test_torch_table_install import _batch
from stellar_core_tpu_torch.accel import ed25519 as TE
pks, sigs, msgs, truth, keys = _batch([2] * 12)
v = TE.Ed25519BatchVerifier(chunk_size=64, table_slots=4, hot_threshold=2,
                            device="cpu")
assert (v.verify(pks, sigs, msgs) == truth).all()
print(json.dumps(sorted(pk.hex() for pk in v._tables.slot_of)))
"""


def test_the_chosen_keys_do_not_follow_the_hash_seed():
    """Twelve keys of equal use for four slots: the four smallest keys by
    their bytes, in two processes whose string hashes differ."""
    code = _PROBE.format(root=str(ROOT), tests=str(ROOT / "tests"))
    chosen = []
    for hash_seed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=hash_seed, OMP_NUM_THREADS="1",
                   PYTHONPATH=str(ROOT))
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             cwd=str(ROOT), capture_output=True, text=True,
                             timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        chosen.append(json.loads(out.stdout.strip().splitlines()[-1]))
    keys = _batch([2] * 12)[4]
    assert chosen[0] == chosen[1] == sorted(pk.hex() for pk in keys)[:4]
