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
    scalarmult calls go to crypto/rfc7748.py and make libsodium's bytes,
    and refuse a low-order u as libsodium does."""
    want = sodium_scenario(r_sodium, 6)
    want_x = scalarmult_scenario(r_sodium)
    monkeypatch.setattr(p_sodium, "_lib", None)
    assert not p_sodium.available()
    assert sodium_scenario(p_sodium, 6) == want
    assert scalarmult_scenario(p_sodium) == want_x
    assert p_sodium.scalarmult_curve25519_base(bytes(32)) \
        == r_sodium.scalarmult_curve25519_base(bytes(32))
    with pytest.raises(RuntimeError, match="low order"):
        p_sodium.scalarmult_curve25519(bytes(32), bytes(32))
    for name, cases, expected in chip_smoke.adversarial_cases():
        assert [p_sodium.verify_detached(s, m, p) for p, s, m in cases] \
            == expected, name


# -- X25519 without libsodium (crypto/rfc7748.py) -------------------------------

# u of the points of order 1, 2, 4 and 8 (the order-8 pair, and 0, 1, p - 1),
# and the non-canonical p and p + 1
_P25519 = 2 ** 255 - 19
LOW_ORDER_U = [0, 1, _P25519 - 1, _P25519, _P25519 + 1,
               0x00b8495f16056286fdb1329ceb8d09da6ac49ff1fae35616aeb8413b7c7aebe0,
               0x57119fd0dd4e22d8868e1c58c45c44045bef839c55b1d0b1248c50a3bc959c5f]


def _x25519_both(k, u, monkeypatch):
    """(libsodium's result, the fallback's): 32 bytes, or "refused"."""
    out = []
    for lib in (p_sodium._lib, None):
        monkeypatch.setattr(p_sodium, "_lib", lib)
        try:
            out.append(p_sodium.scalarmult_curve25519(k, u))
        except RuntimeError as e:
            assert "low order" in str(e)
            out.append("refused")
    return out


def test_x25519_fallback_equals_libsodium_on_random_pairs(monkeypatch):
    """256 seeded (scalar, u) pairs, the top bit of u set in half of them
    and u >= p in some, and the base point: the fallback's bytes are
    libsodium's, and cryptography's X25519 agrees."""
    from stellar_core_tpu_torch.crypto import rfc7748
    rng = random.Random(7748)
    for i in range(256):
        k = rand_bytes(rng, 32)
        u = bytearray(rand_bytes(rng, 32))
        if i % 2:
            u[31] |= 0x80
        if i % 17 == 0:             # a non-canonical u, p + 2 to p + 18
            u = bytearray((_P25519 + 2 + rng.randrange(17)).to_bytes(
                32, "little"))
        want, got = _x25519_both(k, bytes(u), monkeypatch)
        assert got == want != "refused", (i, k.hex(), bytes(u).hex())
        monkeypatch.setattr(p_sodium, "_lib", r_sodium._lib)
        base = p_sodium.scalarmult_curve25519_base(k)
        monkeypatch.setattr(p_sodium, "_lib", None)
        assert p_sodium.scalarmult_curve25519_base(k) == base
        assert rfc7748.scalarmult(k, (9).to_bytes(32, "little")) == base
    try:
        from cryptography.hazmat.primitives.asymmetric.x25519 import (
            X25519PrivateKey, X25519PublicKey)
    except ImportError:             # the comparison with libsodium stands
        return
    for _ in range(32):
        k, u = rand_bytes(rng, 32), rand_bytes(rng, 32)
        ours = rfc7748.scalarmult(k, u)
        theirs = X25519PrivateKey.from_private_bytes(k).exchange(
            X25519PublicKey.from_public_bytes(u))
        assert ours == theirs
        pub = X25519PrivateKey.from_private_bytes(k).public_key()
        assert rfc7748.scalarmult_base(k) == pub.public_bytes_raw()


@pytest.mark.parametrize("u", LOW_ORDER_U, ids=lambda u: hex(u)[:10])
@pytest.mark.parametrize("top", [0, 1], ids=["top-clear", "top-set"])
def test_x25519_fallback_refuses_low_order_points(u, top, monkeypatch):
    """Each low-order u, with the top bit clear or set, is refused by
    libsodium and by the fallback alike, with the binding's error."""
    enc = (u | (top << 255)).to_bytes(32, "little")
    for k in (bytes(range(32)), b"\xff" * 32):
        assert _x25519_both(k, enc, monkeypatch) == ["refused", "refused"]


def test_x25519_fallback_handshakes_with_libsodium(monkeypatch):
    """A loopback handshake between a port overlay whose X25519 runs on
    the fallback and one on libsodium authenticates both sides, and a
    transaction floods across."""
    import contextlib

    from stellar_core_tpu_torch import xdr as X
    from stellar_core_tpu_torch.crypto.keys import SecretKey
    from stellar_core_tpu_torch.herder.herder import Herder
    from stellar_core_tpu_torch.ledger.manager import LedgerManager
    from stellar_core_tpu_torch.overlay import (OverlayManager,
                                                make_loopback_pair)
    from stellar_core_tpu_torch.overlay.peer_auth import PeerAuth
    from stellar_core_tpu_torch.simulation.simulation import qset_of
    from stellar_core_tpu_torch.testutils import network_id
    from stellar_core_tpu_torch.util.clock import ClockMode, VirtualClock

    lib = p_sodium._lib

    @contextlib.contextmanager
    def no_libsodium():
        p_sodium._lib = None
        try:
            yield
        finally:
            p_sodium._lib = lib

    calls = {"fallback": 0}
    shared = PeerAuth.shared_keys

    def shared_keys(self, *args):
        if getattr(self, "on_fallback", False):
            calls["fallback"] += 1
            with no_libsodium():
                return shared(self, *args)
        return shared(self, *args)

    monkeypatch.setattr(PeerAuth, "shared_keys", shared_keys)
    nid = network_id("x25519 fallback net")
    clock = VirtualClock(ClockMode.VIRTUAL_TIME)
    sks = [SecretKey(bytes([0x0c]) * 32), SecretKey(bytes([0x0d]) * 32)]
    q = qset_of([s.public_key.ed25519 for s in sks], 2)
    nodes = []
    for i, sk in enumerate(sks):
        lm = LedgerManager(nid)
        lm.start_new_ledger()
        herder = Herder(clock, lm, sk, q)
        with (no_libsodium() if i == 0 else contextlib.nullcontext()):
            overlay = OverlayManager(clock, herder, nid, sk,
                                     auth_seed=bytes([i + 1]) * 32)
        overlay.peer_auth.on_fallback = i == 0
        nodes.append(overlay)
    monkeypatch.setattr(p_sodium, "_lib", lib)
    want_pub = r_sodium.scalarmult_curve25519_base(
        nodes[0].peer_auth.auth_secret)
    assert nodes[0].peer_auth.auth_public == want_pub
    pa, pb = make_loopback_pair(nodes[0], nodes[1])
    for _ in range(50):
        clock.crank()
    assert pa.is_authenticated() and pb.is_authenticated()
    assert pa.peer_id == sks[1].public_key.ed25519
    assert pb.peer_id == sks[0].public_key.ed25519
    assert calls["fallback"] == 1
    assert isinstance(X.StellarMessage.getPeers(), X.StellarMessage)


def test_box_seal_round_trips_across_the_fallback(monkeypatch):
    """A box sealed on the fallback opens on libsodium and one sealed on
    libsodium opens on the fallback; a changed byte fails the MAC."""
    from stellar_core_tpu_torch.crypto import box
    lib = p_sodium._lib
    rng = random.Random(74)
    for seal_lib, open_lib in ((None, lib), (lib, None), (None, None)):
        monkeypatch.setattr(p_sodium, "_lib", open_lib)
        pk, sk = box.keypair(rand_bytes(rng, 32))
        monkeypatch.setattr(p_sodium, "_lib", seal_lib)
        msg = rand_bytes(rng, rng.randrange(1, 300))
        blob = box.seal(pk, msg)
        monkeypatch.setattr(p_sodium, "_lib", open_lib)
        assert box.seal_open(sk, blob) == msg
        bad = blob[:70] + bytes([blob[70] ^ 1]) + blob[71:]
        with pytest.raises(ValueError, match="MAC"):
            box.seal_open(sk, bad)
    # keys agree with the reference's box, whichever side made them
    from stellar_core_tpu.crypto import box as r_box
    monkeypatch.setattr(p_sodium, "_lib", None)
    assert box.keypair(b"\x42" * 32) == r_box.keypair(b"\x42" * 32)


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
