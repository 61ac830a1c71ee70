"""The port's crypto copies against the JAX package's, on the same inputs.

sha and strkey give the same bytes and reject the same corrupt strkeys;
sodium (libsodium, and the port's RFC 8032 fallback where libsodium is
absent) gives the same keys, signatures and verdicts; keys gives the same
verdicts and the same cache-hit and recompute counts; and the port's
pure-Python ``rfc8032.verify`` equals libsodium on every adversarial case
of chip_smoke.py and on a few hundred seeded signatures, some corrupted.
"""

import random

import pytest

import chip_smoke
from stellar_core_tpu.crypto import keys as r_keys
from stellar_core_tpu.crypto import sha as r_sha
from stellar_core_tpu.crypto import sodium as r_sodium
from stellar_core_tpu.crypto import strkey as r_strkey
from stellar_core_tpu.util.metrics import registry as r_registry
from stellar_core_tpu_torch.crypto import keys as p_keys
from stellar_core_tpu_torch.crypto import rfc8032
from stellar_core_tpu_torch.crypto import sha as p_sha
from stellar_core_tpu_torch.crypto import sodium as p_sodium
from stellar_core_tpu_torch.crypto import strkey as p_strkey
from stellar_core_tpu_torch.util.metrics import registry as p_registry

pytestmark = pytest.mark.skipif(not r_sodium.available(),
                                reason="libsodium is the oracle of these tests")


def rand_bytes(rng, n):
    return bytes(rng.randrange(256) for _ in range(n))


# -- sha -----------------------------------------------------------------------

def sha_scenario(m, seed):
    rng = random.Random(seed)
    out = []
    for n in (0, 1, 31, 32, 55, 56, 64, 119, 200, 1000):
        data = rand_bytes(rng, n)
        key = rand_bytes(rng, 32)
        h = m.SHA256()
        for i in range(0, n, 17):
            h.add(data[i:i + 17])
        mac = m.hmac_sha256(key, data)
        out.append((m.sha256(data), m.sha512(data), h.finish(), mac,
                    m.hmac_sha256_verify(key, data, mac),
                    m.hmac_sha256_verify(key, data, bytes(32)),
                    m.hkdf_extract(key), m.hkdf_expand(key, data[:20]),
                    m.siphash24(key[:16], data)))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_sha_family(seed):
    assert sha_scenario(p_sha, seed) == sha_scenario(r_sha, seed)


# -- strkey --------------------------------------------------------------------

def _corruptions(rng, s):
    yield s.lower()
    yield s[:-1]
    yield s + "A"
    yield ""
    i = rng.randrange(len(s))
    yield s[:i] + ("A" if s[i] != "A" else "B") + s[i + 1:]
    yield s[:-1] + ("A" if s[-1] != "A" else "B")         # trailing bits
    yield "G" + s[1:]                                       # version byte


def _decoded(call):
    try:
        return ("accepted", call())
    except ValueError as e:
        return ("rejected", str(e))


def strkey_scenario(m, seed):
    rng = random.Random(seed)
    out = []
    for version in m.StrKeyVersion:
        n = 40 if version == m.StrKeyVersion.MUXED_ED25519 else (
            44 if version == m.StrKeyVersion.SIGNED_PAYLOAD else 32)
        payload = rand_bytes(rng, n)
        s = m.encode(version, payload)
        other = (m.StrKeyVersion.PRE_AUTH_TX
                 if version != m.StrKeyVersion.PRE_AUTH_TX
                 else m.StrKeyVersion.HASH_X)
        # (a muxed key's 69 characters are refused as a length: the
        # reference's decode_any does so too)
        out.append((s, _decoded(lambda: m.decode(version, s)),
                    _decoded(lambda: m.decode(other, s)),
                    m.crc16_xmodem(payload)))
        out.extend(_decoded(lambda: m.decode_any(bad))
                   for bad in _corruptions(rng, s))
    pk = rand_bytes(rng, 32)
    out.append((m.encode_public_key(pk), m.decode_public_key(
        m.encode_public_key(pk)), m.encode_seed(pk),
        m.decode_seed(m.encode_seed(pk))))
    return out


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_strkey_round_trips_and_rejections(seed):
    got = strkey_scenario(p_strkey, seed)
    assert got == strkey_scenario(r_strkey, seed)
    assert sum(1 for o in got if o[0] == "rejected") >= 6 * 7


# -- sodium --------------------------------------------------------------------

def sodium_scenario(m, seed):
    rng = random.Random(seed)
    out = []
    for _ in range(6):
        seed32 = rand_bytes(rng, 32)
        pk, sk = m.sign_seed_keypair(seed32)
        msg = rand_bytes(rng, rng.randrange(0, 150))
        sig = m.sign_detached(msg, sk)
        bad = bytes([sig[0] ^ 1]) + sig[1:]
        out.append((pk, sk, sig, m.verify_detached(sig, msg, pk),
                    m.verify_detached(bad, msg, pk),
                    m.verify_detached(sig[:63], msg, pk)))
    with pytest.raises(ValueError):
        m.sign_seed_keypair(bytes(31))
    with pytest.raises(ValueError):
        m.sign_detached(b"m", bytes(32))
    return out


def scalarmult_scenario(m):
    a, b = bytes(range(32)), bytes(range(1, 33))
    pub = m.scalarmult_curve25519_base(a)
    return pub, m.scalarmult_curve25519(b, pub)


def test_sodium_equals_the_reference():
    assert p_sodium.available() and p_sodium.SIGN_BYTES == 64
    assert sodium_scenario(p_sodium, 5) == sodium_scenario(r_sodium, 5)
    assert scalarmult_scenario(p_sodium) == scalarmult_scenario(r_sodium)


def test_sodium_fallback_is_rfc8032(monkeypatch):
    """Without libsodium, key generation, signing and verification go to
    crypto/rfc8032.py and make libsodium's bytes and verdicts; the
    scalarmult calls raise, as the reference's do."""
    want = sodium_scenario(r_sodium, 6)
    monkeypatch.setattr(p_sodium, "_lib", None)
    assert not p_sodium.available()
    assert sodium_scenario(p_sodium, 6) == want
    with pytest.raises(RuntimeError):
        p_sodium.scalarmult_curve25519_base(bytes(32))
    with pytest.raises(RuntimeError):
        p_sodium.scalarmult_curve25519(bytes(32), bytes(32))
    for name, cases, expected in chip_smoke.adversarial_cases():
        assert [p_sodium.verify_detached(s, m, p) for p, s, m in cases] \
            == expected, name


# -- rfc8032.verify against libsodium ------------------------------------------

def test_rfc8032_verify_equals_libsodium_on_the_adversarial_cases():
    n = 0
    for name, cases, expected in chip_smoke.adversarial_cases():
        lib = [r_sodium.verify_detached(s, m, p) for p, s, m in cases]
        assert [rfc8032.verify(s, m, p) for p, s, m in cases] == lib, name
        assert lib == expected, name
        n += len(cases)
    assert n == 112


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rfc8032_verify_equals_libsodium_on_random_signatures(seed):
    rng = random.Random(1000 + seed)
    verdicts = []
    for i in range(100):
        pk, sk = r_sodium.sign_seed_keypair(rand_bytes(rng, 32))
        msg = rand_bytes(rng, rng.randrange(0, 200))
        sig = r_sodium.sign_detached(msg, sk)
        kind = i % 5
        if kind == 1:                               # a bit of R or S
            j = rng.randrange(64)
            sig = sig[:j] + bytes([sig[j] ^ (1 << rng.randrange(8))]) + sig[j + 1:]
        elif kind == 2:                             # the message
            msg = msg + b"\x00"
        elif kind == 3:                             # a random key
            pk = rand_bytes(rng, 32)
        elif kind == 4:                             # S + L, S + k L
            s_int = int.from_bytes(sig[32:], "little") + rng.randrange(1, 16) \
                * rfc8032.L
            if s_int < 1 << 256:
                sig = sig[:32] + s_int.to_bytes(32, "little")
        lib = r_sodium.verify_detached(sig, msg, pk)
        assert rfc8032.verify(sig, msg, pk) == lib, (i, kind)
        verdicts.append(lib)
    assert 20 <= sum(verdicts) < 100


def test_rfc8032_blocklist_is_the_verifiers():
    """The small-order y values are the batch verifier's own."""
    from stellar_core_tpu_torch.accel import ed25519
    assert rfc8032._SMALL_ORDER_Y == {0, 1, ed25519._Y8A, ed25519._Y8B,
                                      rfc8032.P - 1, rfc8032.P, rfc8032.P + 1}


# -- keys and the verify cache -------------------------------------------------

def keys_scenario(k, reg, seed):
    rng = random.Random(seed)
    k.clear_verify_cache()
    hit0 = reg().counter("crypto.verify.cache-hit").value
    rec0 = reg().counter("crypto.verify.recompute").value
    sks = [k.SecretKey(rand_bytes(rng, 32)) for _ in range(4)]
    triples = []
    for i in range(24):
        sk = sks[i % 4]
        msg = rand_bytes(rng, 32 if i % 3 else 100)     # > 64: digested key
        sig = sk.sign(msg)
        if i % 5 == 4:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        triples.append((sk.public_key, sig, msg))
    # a wrong verdict seeded for one triple: the cache answers, no recompute
    pk0, sig0, msg0 = triples[0]
    k.seed_verify_cache([(pk0.ed25519, sig0, msg0, False)])
    verdicts = [k.verify_sig(pk, sig, msg) for pk, sig, msg in triples * 2]
    pk = sks[1].public_key
    out = (verdicts, reg().counter("crypto.verify.cache-hit").value - hit0,
           reg().counter("crypto.verify.recompute").value - rec0,
           pk.to_strkey(), k.PublicKey.from_strkey(pk.to_strkey()) == pk,
           pk.hint(), repr(pk), repr(sks[2]), sks[3].to_strkey_seed(),
           k.SecretKey.from_strkey_seed(sks[3].to_strkey_seed()).public_key
           == sks[3].public_key,
           k.SecretKey.pseudo_random_for_testing(random.Random(seed))
           .public_key.ed25519, k.VERIFY_CACHE_SIZE)
    with pytest.raises(ValueError):
        k.PublicKey(bytes(31))
    with pytest.raises(ValueError):
        k.SecretKey(bytes(33))
    k.clear_verify_cache()
    return out


@pytest.mark.parametrize("seed", [7, 8])
def test_keys_verdicts_and_cache_counts(seed):
    got = keys_scenario(p_keys, p_registry, seed)
    assert got == keys_scenario(r_keys, r_registry, seed)
    verdicts, hits, recomputes = got[:3]
    assert verdicts[0] is False and hits == 25 and recomputes == 23
