"""The port's SignatureChecker against the JAX package's, on the same
seeded transactions, with each side's verify cache seeded the way catchup
replay seeds it: the port's by its ``verify_batch(..., device="cpu")``,
the reference's by its own ``verify_batch``.

Each transaction carries ed25519 signatures (some corrupted, some from
keys that are not signers, one with a wrong hint), hashX preimages and
preAuthTx signers; the checks ask for several signer sets and weights.
``check_signature``, ``used`` and ``check_all_signatures_used`` must agree,
and so must the cache-hit and recompute counts: every seeded pair is a
hit, and the one transaction left out of the batch is recomputed.
"""

import random

import numpy as np
import pytest

from stellar_core_tpu import xdr as RX
from stellar_core_tpu.crypto import keys as r_keys
from stellar_core_tpu.crypto import sha as r_sha
from stellar_core_tpu.crypto import sodium
from stellar_core_tpu.transactions import signature_checker as r_sc
from stellar_core_tpu.util.metrics import registry as r_registry
from stellar_core_tpu_torch import xdr as PX
from stellar_core_tpu_torch.accel import ed25519 as TE
from stellar_core_tpu_torch.crypto import keys as p_keys
from stellar_core_tpu_torch.crypto import sha as p_sha
from stellar_core_tpu_torch.transactions import signature_checker as p_sc
from stellar_core_tpu_torch.util.metrics import registry as p_registry

pytestmark = pytest.mark.skipif(not sodium.available(),
                                reason="libsodium signs the inputs")

CHUNK = 32
COLD = 1 << 62           # the replay default: every key on the generic path


class Side:
    """One package's XDR, keys, sha, checker, registry and batch verify."""

    def __init__(self, X, keys, sha, sc, registry, verify):
        self.X, self.keys, self.sha, self.sc = X, keys, sha, sc
        self.registry, self.verify = registry, verify


def ref_verify(pks, sigs, msgs):
    Ej = pytest.importorskip("stellar_core_tpu.accel.ed25519")
    return Ej.verify_batch(pks, sigs, msgs, chunk_size=CHUNK,
                           tail_floor=CHUNK, hot_threshold=COLD)


def port_verify(pks, sigs, msgs):
    return TE.verify_batch(pks, sigs, msgs, chunk_size=CHUNK,
                           tail_floor=CHUNK, hot_threshold=COLD, device="cpu")


REF = Side(RX, r_keys, r_sha, r_sc, r_registry, ref_verify)
PORT = Side(PX, p_keys, p_sha, p_sc, p_registry, port_verify)


def make_transactions(s: Side, seed: int):
    """[(content hash, [DecoratedSignature], [(signers, weight)])]."""
    X, keys, sha = s.X, s.keys, s.sha
    rng = random.Random(seed)
    sks = [keys.SecretKey(bytes([seed, i]) * 16) for i in range(6)]

    def ed(sk, w):
        return X.Signer(key=X.SignerKey.ed25519(sk.public_key.ed25519),
                        weight=w)

    def dsig(sk, h):
        return X.DecoratedSignature(hint=sk.public_key.hint(),
                                    signature=sk.sign(h))

    txs = []
    for t in range(6):
        h = bytes(rng.randrange(256) for _ in range(32))
        a, b, c, stranger = rng.sample(sks, 4)
        preimage = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 40)))
        hx = sha.sha256(preimage)
        hashx = X.Signer(key=X.SignerKey.hash_x(hx), weight=2)
        preauth = X.Signer(key=X.SignerKey.pre_auth_tx(h), weight=1)
        other_preauth = X.Signer(key=X.SignerKey.pre_auth_tx(sha.sha256(h)),
                                 weight=5)
        sigs = [dsig(a, h), dsig(b, h)]
        if t % 2:
            bad = dsig(c, h)                                    # corrupted
            bad.signature = bytes([bad.signature[0] ^ 1]) + bad.signature[1:]
            sigs.append(bad)
        if t % 3 == 0:
            sigs.append(dsig(stranger, h))                      # not a signer
        if t % 3 == 1:
            sigs.append(X.DecoratedSignature(hint=hx[28:32], signature=preimage))
        if t == 4:
            wrong = dsig(a, h)
            wrong.hint = bytes(4)                               # wrong hint
            sigs.append(wrong)
        rng.shuffle(sigs)
        checks = [([ed(a, 1)], 1), ([ed(a, 1), ed(b, 1)], 2),
                  ([ed(a, 1), ed(b, 1), ed(c, 1)], 3), ([ed(c, 3)], 1),
                  ([preauth], 1), ([other_preauth, ed(b, 1)], 1),
                  ([hashx], 2), ([hashx, ed(a, 1)], 3), ([ed(a, 2)], 0),
                  ([], 0)]
        txs.append((h, sigs, checks))
    return txs


def pairs_of(s: Side, txs, skip):
    """(pk, sig, hash) of every ed25519 signature and each signer whose
    hint it carries: what catchup replay sends to the batch verifier."""
    out = []
    for t, (h, sigs, checks) in enumerate(txs):
        if t == skip:
            continue
        keys = {sg.key.value for signers, _ in checks for sg in signers
                if sg.key.switch == s.X.SignerKeyType.SIGNER_KEY_TYPE_ED25519}
        for d in sigs:
            for pk in sorted(keys):
                if d.hint == pk[28:32] and (pk, d.signature, h) not in out:
                    out.append((pk, d.signature, h))
    return out


def run_checks(s: Side, seed: int, skip: int):
    txs = make_transactions(s, seed)
    pairs = pairs_of(s, txs, skip)
    assert len(pairs) <= 64
    verdicts = s.verify([p for p, _, _ in pairs], [g for _, g, _ in pairs],
                        [h for _, _, h in pairs])
    s.keys.clear_verify_cache()
    s.keys.seed_verify_cache((p, g, h, bool(v))
                             for (p, g, h), v in zip(pairs, verdicts))
    hit = s.registry().counter("crypto.verify.cache-hit")
    rec = s.registry().counter("crypto.verify.recompute")
    hit0, rec0 = hit.value, rec.value
    out = []
    for h, sigs, checks in txs:
        checker = s.sc.SignatureChecker(23, h, sigs)
        results = [checker.check_signature(signers, w) for signers, w in checks]
        out.append((results, list(checker.used),
                    checker.check_all_signatures_used()))
    s.keys.clear_verify_cache()
    return (np.asarray(verdicts).tolist(), out, hit.value - hit0,
            rec.value - rec0)


@pytest.mark.parametrize("seed", [1, 2])
def test_signature_checker_equals_the_reference(seed):
    want = run_checks(REF, seed, skip=5)
    got = run_checks(PORT, seed, skip=5)
    assert got == want
    verdicts, out, hits, recomputes = got
    assert 0 < sum(verdicts) < len(verdicts)
    assert hits > 0 and recomputes > 0
    flat = [r for results, _, _ in out for r in results]
    assert any(flat) and not all(flat)
    assert any(all_used for _, _, all_used in out)
    assert not all(all_used for _, _, all_used in out)


def test_every_pair_seeded_means_no_recompute():
    """With the whole batch seeded, the checks are answered from the
    cache alone, on both sides, with the same number of hits."""
    want = run_checks(REF, 3, skip=None)
    got = run_checks(PORT, 3, skip=None)
    assert got == want
    assert got[3] == 0 and got[2] > 0


def test_checker_fields_and_empty_signatures():
    def run(s):
        c = s.sc.SignatureChecker(19, bytes(32), [])
        return (c.protocol_version, c.content_hash, c.used,
                c.check_signature([], 0), c.check_all_signatures_used())

    assert run(PORT) == run(REF) == (19, bytes(32), [], False, True)
