"""The CUDA kernels' device code, compiled as host C++, against the plain
PyTorch versions and python big-int ground truth (CPU, exact equality).

csrc/*.cuh hold every kernel's per-thread body and compile with a host C++
compiler as well as with nvcc; tests/torch_csrc_host.cpp loops over rows the
way the kernels' threads do.  This checks the kernels' arithmetic here,
without a card; chip_smoke.py checks the kernels themselves on the card.
"""

import ctypes
import hashlib
import mmap
import random
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from stellar_core_tpu_torch import testutils
from stellar_core_tpu_torch.accel import curve, ed25519, field, quorum, tables
from stellar_core_tpu_torch.crypto import sodium

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "stellar_core_tpu_torch" / "csrc"
P = field.P
VP = ctypes.c_void_p
# fe25519.cuh's limb i starts at bit ceil(25.5 i)
OFFSETS = [(51 * i + 1) // 2 for i in range(10)]


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernels' device code")
    so = tmp_path_factory.mktemp("csrc") / "host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall",
                    "-Werror", "-Wno-unknown-pragmas", "-I", str(CSRC), "-o",
                    str(so), str(ROOT / "tests" / "torch_csrc_host.cpp")],
                   check=True)
    lib = ctypes.CDLL(str(so))
    i64 = ctypes.c_int64
    lib.host_fe_check.argtypes = [VP, VP, ctypes.c_int, i64, VP]
    lib.host_verify_generic.argtypes = [VP, VP, VP, VP, i64, VP, i64, VP]
    lib.host_verify_windows.argtypes = [VP, VP, VP, i64, VP, VP]
    lib.host_build_tables.argtypes = [VP, VP, i64, VP, i64]
    lib.host_quad_point_ops.argtypes = [VP, i64, VP]
    lib.host_verify_tables.argtypes = [VP, VP, VP, VP, i64, VP, i64, VP, VP]
    lib.host_dbl_chain.argtypes = [VP, i64, i64, VP]
    c_int = ctypes.c_int
    lib.host_quorum_flags.argtypes = [VP, i64, VP, VP, VP] + [c_int] * 6 \
        + [VP]
    lib.host_quorum_sizes.argtypes = [c_int] * 6 + [VP]
    return lib


def _ptr(a: np.ndarray):
    assert a.flags.c_contiguous
    return a.ctypes.data


def _enc(xs) -> np.ndarray:
    return np.frombuffer(b"".join(x.to_bytes(32, "little") for x in xs),
                         dtype=np.uint8).reshape(len(xs), 32).copy()


def _ints(rows: np.ndarray):
    return [int.from_bytes(r.tobytes(), "little") for r in rows]


def _header_fes(name: str):
    """The field constants `name` of ge25519.cuh as python ints."""
    text = (CSRC / "ge25519.cuh").read_text()
    body = re.search(rf"{name}(?:\[3\]\[3\])? = (.*?);", text, re.S).group(1)
    limbs = [int(v, 16) for v in re.findall(r"0x[0-9a-f]+", body)]
    return [sum(l << o for l, o in zip(limbs[k:k + 10], OFFSETS))
            for k in range(0, len(limbs), 10)]


def test_header_constants_match_curve():
    assert _header_fes("GE_D2") == [curve.D2]
    want = []
    for k in (1, 2, 3):
        x, y = curve._B_MULTS[k]
        want += [x, y, x * y % P]
    assert _header_fes("GE_B_MULTS") == want


EDGE = [0, 1, 2, 19, P - 2, P - 1, P, P + 1, P + 18, (1 << 255) - 1,
        1 << 254, (1 << 255) - 20]


def _chain(x, y):
    for _ in range(60):
        x = (x * y - y) % P
    return x


@pytest.mark.parametrize("op,ref", [
    (0, lambda x, y: x * y % P),
    (1, lambda x, y: x * x % P),
    (2, lambda x, y: (x + y) % P),
    (3, lambda x, y: (x - y) % P),
    (4, lambda x, y: pow(x, P - 2, P)),
    (5, lambda x, y: x % P),
    (6, _chain),
], ids=["mul", "sq", "add", "sub", "invert", "canonical", "chain"])
def test_field_ops_match_bigint(host, op, ref):
    """Random 255-bit operands (values in [p, 2^255) included) plus edge
    values in both positions."""
    rng = random.Random(100 + op)
    n = 600 if op in (4, 6) else 3000
    xs = EDGE + [rng.randrange(1 << 255) for _ in range(n)]
    ys = EDGE[::-1] + [rng.randrange(1 << 255) for _ in range(n)]
    a, b = _enc(xs), _enc(ys)
    out = np.zeros_like(a)
    host.host_fe_check(_ptr(a), _ptr(b), op, len(xs), _ptr(out))
    got = _ints(out)
    bad = [i for i in range(len(xs)) if got[i] != ref(xs[i], ys[i])]
    assert not bad, bad[:5]


@pytest.mark.parametrize("op", range(len(field.FE_CHECK_OPS)),
                         ids=field.FE_CHECK_OPS)
def test_field_ops_match_plain_version(host, op):
    """The check kernel's body equals its plain version (the comparison
    chip_smoke.py makes on the card), bit 255 set or not."""
    rng = np.random.default_rng(5 + op)
    a = rng.integers(0, 256, size=(256, 32), dtype=np.uint8)
    b = rng.integers(0, 256, size=(256, 32), dtype=np.uint8)
    out = np.zeros_like(a)
    host.host_fe_check(_ptr(a), _ptr(b), op, len(a), _ptr(out))
    want = field.fe_check_plain(torch.from_numpy(a), torch.from_numpy(b), op)
    assert np.array_equal(out, want.numpy())


def _signed_batch(n_keys, n, seed, corrupt_every=5):
    rng = random.Random(seed)
    keys = [sodium.sign_seed_keypair(bytes([seed, i]) * 16)
            for i in range(n_keys)]
    pks, sigs, msgs = [], [], []
    for i in range(n):
        pk, sk = keys[i % n_keys]
        msg = rng.randbytes(rng.randrange(0, 80))
        sig = sodium.sign_detached(msg, sk)
        if i % corrupt_every == corrupt_every - 1:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        pks.append(pk)
        sigs.append(sig)
        msgs.append(msg)
    return pks, sigs, msgs


def _device_inputs(pks, sigs, msgs):
    """(s, h, r) byte matrices, key rows of -A and per-signature key
    indices, as the verifier's host prep makes them."""
    uniq = sorted(set(pks))
    keys = np.stack([ed25519.Ed25519BatchVerifier._decode_pk(pk) for pk in uniq])
    kidx = np.array([uniq.index(pk) for pk in pks], dtype=np.int32)
    s = np.stack([np.frombuffer(sig[32:], np.uint8) for sig in sigs])
    r = np.stack([np.frombuffer(sig[:32], np.uint8) for sig in sigs])
    h = _enc([int.from_bytes(hashlib.sha512(sig[:32] + pk + m).digest(),
                             "little") % ed25519.L
              for pk, sig, m in zip(pks, sigs, msgs)])
    return s, h, r, keys, kidx


def test_verify_generic_body_matches_plain_and_libsodium(host):
    pks, sigs, msgs = _signed_batch(3, 12, seed=11)
    s, h, r, keys, kidx = _device_inputs(pks, sigs, msgs)
    out = np.zeros(len(s), dtype=np.uint8)
    host.host_verify_generic(_ptr(s), _ptr(h), _ptr(r), _ptr(kidx), len(s),
                             _ptr(keys), len(keys), _ptr(out))
    plain = ed25519.verify_forward_raw(*map(torch.from_numpy, (s, h, kidx, keys, r)))
    expect = [sodium.verify_detached(sg, m, pk) for pk, sg, m in zip(pks, sigs, msgs)]
    assert out.astype(bool).tolist() == plain.tolist() == expect
    # an index outside the key rows is rejected, never read
    bad = np.full_like(kidx, len(keys))
    host.host_verify_generic(_ptr(s), _ptr(h), _ptr(r), _ptr(bad), len(s),
                             _ptr(keys), len(keys), _ptr(out))
    assert not out.any()


def _windows_inputs():
    """K-W's inputs for 12 signatures over 3 keys, every fifth R corrupted:
    the (127, n) windows, each signature's key rows, R; and libsodium's
    verdicts."""
    pks, sigs, msgs = _signed_batch(3, 12, seed=13)
    s, h, r, keys, kidx = _device_inputs(pks, sigs, msgs)
    expect = [sodium.verify_detached(sg, m, pk)
              for pk, sg, m in zip(pks, sigs, msgs)]
    return (ed25519._windows_msb_first(s, h), np.ascontiguousarray(keys[kidx]),
            r, expect)


def _host_windows(host, windows, rows, r):
    out = np.zeros(len(r), dtype=np.uint8)
    host.host_verify_windows(_ptr(windows), _ptr(rows), _ptr(r), len(r),
                             _ptr(out), None)
    return out.astype(bool).tolist()


def test_verify_windows_body_matches_plain_and_libsodium(host):
    """K-W's body (K-G's, with the windows given) equals the plain
    verify_windows and libsodium."""
    windows, rows, r, expect = _windows_inputs()
    plain = ed25519.verify_windows(*map(torch.from_numpy, (windows, rows, r)))
    assert _host_windows(host, windows, rows, r) == plain.tolist() == expect
    assert expect.count(False) == 2


@pytest.mark.parametrize("bad", [16, -1, 1 << 30])
def test_verify_windows_body_rejects_windows_outside_the_table(host, bad):
    """A window outside [0, 16) rejects its signature (the table is never
    read outside its 16 entries); the other signatures keep their verdicts.
    The plain version refuses such windows."""
    windows, rows, r, expect = _windows_inputs()
    windows[40, 1] = bad
    windows[126, 2] = bad
    want = list(expect)
    want[1] = want[2] = False
    assert expect[1] and expect[2]
    assert _host_windows(host, windows, rows, r) == want
    with pytest.raises(ValueError, match="outside"):
        ed25519.verify_windows(*map(torch.from_numpy, (windows, rows, r)))


SENTINEL = 0xA5
_libc = ctypes.CDLL(None, use_errno=True)
_libc.mprotect.argtypes = [VP, ctypes.c_size_t, ctypes.c_int]


def _guarded(a: np.ndarray) -> np.ndarray:
    """A copy of `a` that ends where a page with no access begins: a body
    that read a row past n would fault instead of reading garbage."""
    page = mmap.PAGESIZE
    size = -(-a.nbytes // page) * page
    buf = mmap.mmap(-1, size + page)
    base = np.frombuffer(buf, dtype=np.uint8)
    assert _libc.mprotect(base.ctypes.data + size, page, 0) == 0
    out = base[size - a.nbytes:size].view(a.dtype).reshape(a.shape)
    out[...] = a
    return out


def _host_generic(host, s, h, r, kidx, keys):
    """K-G's quad body on n rows, run in whole warps; out has 8 sentinel
    bytes past n, which no quad past n may overwrite."""
    n = len(s)
    out = np.full(n + 8, SENTINEL, dtype=np.uint8)
    host.host_verify_generic(_ptr(s), _ptr(h), _ptr(r), _ptr(kidx), n,
                             _ptr(keys), len(keys), _ptr(out))
    assert (out[n:] == SENTINEL).all()
    return out[:n].astype(bool)


def _host_windows_count(host, windows, rows, r, start=0):
    """K-W's quad body with the fused count (from `start`); as
    _host_generic, the verdicts and the count."""
    n = len(r)
    out = np.full(n + 8, SENTINEL, dtype=np.uint8)
    count = np.array([start], dtype=np.int32)
    host.host_verify_windows(_ptr(windows), _ptr(rows), _ptr(r), n,
                             _ptr(out), _ptr(count))
    assert (out[n:] == SENTINEL).all()
    return out[:n].astype(bool), int(count[0])


@pytest.mark.parametrize("n", [1, 3, 7, 9, 33])
@pytest.mark.parametrize("kernel", ["K-G", "K-W"])
def test_quad_bodies_on_ragged_sizes(host, kernel, n):
    """A quad of lanes a signature, 8 a warp: at these n the last warp is
    partial, its quads past n run on row n - 1 (no read past the inputs:
    each ends at a page with no access) and store nothing; every verdict
    equals the plain version's and libsodium's."""
    pks, sigs, msgs = _signed_batch(3, n, seed=20 + n, corrupt_every=3)
    s, h, r, keys, kidx = _device_inputs(pks, sigs, msgs)
    expect = [sodium.verify_detached(sg, m, pk)
              for pk, sg, m in zip(pks, sigs, msgs)]
    t = torch.from_numpy
    if kernel == "K-G":
        got = _host_generic(host, *map(_guarded, (s, h, r, kidx)), keys)
        plain = ed25519.verify_forward_raw(t(s), t(h), t(kidx), t(keys), t(r))
    else:
        windows = ed25519._windows_msb_first(s, h)
        rows = np.ascontiguousarray(keys[kidx])
        got, _ = _host_windows_count(host, *map(_guarded, (windows, rows, r)))
        plain = ed25519.verify_windows(t(windows), t(rows), t(r))
    assert got.tolist() == plain.tolist() == expect


@pytest.mark.parametrize("n", [9, 33])
def test_windows_fused_count_counts_each_signature_once(host, n):
    """The host emulation of K-W's per-warp ballot (lane 0 of each quad
    below n votes, a warp adds its votes) adds ok.sum() to the count."""
    pks, sigs, msgs = _signed_batch(2, n, seed=40 + n, corrupt_every=4)
    s, h, r, keys, kidx = _device_inputs(pks, sigs, msgs)
    windows = ed25519._windows_msb_first(s, h)
    ok, count = _host_windows_count(host, windows,
                                    np.ascontiguousarray(keys[kidx]), r,
                                    start=7)
    assert 0 < ok.sum() < n
    assert count == 7 + ok.sum()


def test_key_index_outside_the_rows_rejects_only_its_signature(host):
    """Out-of-range key indices in the middle of a warp: those signatures
    are rejected (their key is never read), their neighbours in the same
    warps keep their verdicts."""
    pks, sigs, msgs = _signed_batch(3, 33, seed=14, corrupt_every=7)
    s, h, r, keys, kidx = _device_inputs(pks, sigs, msgs)
    want = _host_generic(host, s, h, r, kidx, keys)
    bad = kidx.copy()
    bad[[10, 13, 17]] = [len(keys), -1, (1 << 31) - 1]
    want[[10, 13, 17]] = False
    assert _host_generic(host, s, h, r, bad, keys).tolist() == want.tolist()


@pytest.fixture(scope="module")
def adversarial():
    import chip_smoke
    return chip_smoke.adversarial_cases(chip_smoke.Signer())


@pytest.mark.parametrize("case", range(8))
def test_quad_body_on_adversarial_vectors(host, adversarial, monkeypatch,
                                          case):
    """chip_smoke's adversarial vectors through the verifier's host prep,
    its generic path running K-G's quad body as host C++ (checked against
    the plain version at every call): the verdicts are libsodium's.  Then
    every case whose key decodes, small-order and torsion-mixed keys
    included, straight into the body (no prep gates): equal to the plain
    version."""
    name, cases, expected = adversarial[case]
    t = torch.from_numpy
    calls = []

    def host_kg(s, h, kidx, keys, r):
        got = _host_generic(host, *(a.numpy() for a in (s, h, r, kidx, keys)))
        assert got.tolist() == ed25519.verify_forward_raw(
            s, h, kidx, keys, r).tolist()
        calls.append(len(got))
        return t(got)

    monkeypatch.setattr(ed25519, "verify_generic", host_kg)
    v = ed25519.Ed25519BatchVerifier(chunk_size=32, hot_threshold=1 << 62,
                                     device="cpu")
    pks, sigs, msgs = (list(c) for c in zip(*cases))
    assert v.verify(pks, sigs, msgs).tolist() == expected, name
    assert calls or not any(expected), name   # only the prep rejected
    keep = [(pk, sg, m) for pk, sg, m in cases if len(pk) == 32
            and len(sg) == 64
            and ed25519.Ed25519BatchVerifier._decode_pk(pk) is not None]
    s, h, r, keys, kidx = _device_inputs(*(list(c) for c in zip(*keep)))
    plain = ed25519.verify_forward_raw(t(s), t(h), t(kidx), t(keys), t(r))
    assert _host_generic(host, s, h, r, kidx, keys).tolist() \
        == plain.tolist(), name


# the largest limbs of a carried element (fe25519.cuh): 2^26 - 1 even,
# 2^25 - 1 odd, and limb 1 up to 2^25 + 2^15 - 1 after the last carry
CARRIED_MAX = [(1 << 26) - 1, (1 << 25) + (1 << 15) - 1] + [
    (1 << (26 - (i & 1))) - 1 for i in range(2, 10)]


@pytest.mark.parametrize("kind", ["random", "extreme"])
def test_quad_point_ops_match_single_thread(host, kind):
    """q_dbl and q_add_pre (four lanes, uncarried stage operands, 32-bit
    carries) equal ge_dbl and ge_add_pre mod p on carried limbs, among them
    every limb at its largest, where an uncarried operand is largest."""
    rng = np.random.default_rng(3)
    top = np.array(CARRIED_MAX, dtype=np.int64) + 1
    limbs = rng.integers(0, top, size=(400, 8, 10)).astype(np.uint32)
    if kind == "extreme":
        # every limb within 2^12 of its largest; in half the cases some
        # elements zero instead
        limbs = (top - 1 - rng.integers(0, 1 << 12, size=limbs.shape)
                 ).astype(np.uint32)
        limbs[0] = CARRIED_MAX
        limbs[200:] *= (rng.random((200, 8, 1)) < 0.7).astype(np.uint32)
    limbs = np.ascontiguousarray(limbs)
    # [case][dbl, add_pre][quad, single thread][coordinate]
    out = np.zeros((len(limbs), 2, 2, 4, 32), dtype=np.uint8)
    host.host_quad_point_ops(_ptr(limbs), len(limbs), _ptr(out))
    assert np.array_equal(out[:, :, 0], out[:, :, 1])
    # and the single-thread result is the big-int one for one case
    vals = [sum(int(l) << o for l, o in zip(e, OFFSETS)) % P
            for e in limbs[0]]
    x, y, z, t = vals[:4]
    a, b = x * x % P, y * y % P
    c, h = 2 * z * z % P, (a + b) % P
    e, g = (h - (x + y) ** 2) % P, (a - b) % P
    f = (c + g) % P
    assert _ints(out[0, 0, 0]) == [e * f % P, g * h % P, f * g % P, e * h % P]


def test_build_tables_body_matches_plain(host):
    """K-B's two-phase body (one chain of 252 doublings into the chain
    buffer, then a quad a window) writes entries equal to the plain
    build_tables' byte for byte, for keys of -A and for the base point
    (slots of one table, out of order); a slot outside the table is
    skipped."""
    neg = [ed25519.Ed25519BatchVerifier._decode_pk(
        sodium.sign_seed_keypair(bytes([i]) + bytes(range(31)))[0])
        for i in range(2)]
    xy = np.ascontiguousarray(np.stack([n[:2] for n in neg]
                                       + [tables.base_xy()[0], neg[0][:2]]))
    slots = np.array([2, 0, 1, 3], dtype=np.int32)
    table = tables.new_table(3, "cpu").numpy()
    host.host_build_tables(_ptr(xy), _ptr(slots), 4, _ptr(table), 3)
    plain = tables.build_tables(field.from_bytes(torch.from_numpy(xy[:3, 0])),
                                field.from_bytes(torch.from_numpy(xy[:3, 1])))
    assert np.array_equal(table[slots[:3]], field.to_bytes(plain).numpy())


def _tables_inputs(host, n_keys, n, seed, corrupt_every):
    """K-T's inputs for n signatures over n_keys keys: s, h, r, each
    signature's slot, the key table (slot k: key k) and the base table,
    both built by K-B's host body; and libsodium's verdicts."""
    pks, sigs, msgs = _signed_batch(n_keys, n, seed, corrupt_every)
    s, h, r, keys, kidx = _device_inputs(pks, sigs, msgs)
    xy = np.ascontiguousarray(np.concatenate([keys[:, :2], tables.base_xy()]))
    nk = len(keys)
    table = tables.new_table(nk + 1, "cpu").numpy()
    host.host_build_tables(_ptr(xy), _ptr(np.arange(nk + 1, dtype=np.int32)),
                           nk + 1, _ptr(table), nk + 1)
    expect = [sodium.verify_detached(sg, m, pk)
              for pk, sg, m in zip(pks, sigs, msgs)]
    return (s, h, r, kidx, np.ascontiguousarray(table[:nk]),
            np.ascontiguousarray(table[nk]), expect)


def _host_tables(host, s, h, r, slots, key_table, base):
    """K-T's pair body on n rows, run in whole warps of 16 pairs; as
    _host_generic, no pair past n may overwrite the sentinel bytes past n."""
    n = len(s)
    out = np.full(n + 16, SENTINEL, dtype=np.uint8)
    host.host_verify_tables(_ptr(s), _ptr(h), _ptr(r), _ptr(slots), n,
                            _ptr(key_table), len(key_table), _ptr(base),
                            _ptr(out))
    assert (out[n:] == SENTINEL).all()
    return out[:n].astype(bool)


def _plain_tables(s, h, r, slots, key_table, base):
    t = torch.from_numpy
    return tables.verify_tables_forward(t(s), t(h), t(slots), t(r),
                                        t(key_table), t(base))


def test_verify_tables_body_matches_plain_and_libsodium(host):
    """K-T's pair body (two halves of the 128 adds, joined by one complete
    add) equals the plain verify_tables_forward and libsodium."""
    s, h, r, slots, key_table, base, expect = _tables_inputs(
        host, 2, 10, seed=12, corrupt_every=4)
    got = _host_tables(host, s, h, r, slots, key_table, base)
    plain = _plain_tables(s, h, r, slots, key_table, base)
    assert got.tolist() == plain.tolist() == expect
    assert expect.count(False) == 2


@pytest.mark.parametrize("n", [1, 3, 7, 17, 33])
def test_table_pair_body_on_ragged_sizes(host, n):
    """K-T at n whose last warp of 16 pairs is partial: its pairs past n
    run on row n - 1, read nothing past the inputs (each ends at a page
    with no access) and store nothing; every verdict equals the plain
    version's and libsodium's."""
    s, h, r, slots, key_table, base, expect = _tables_inputs(
        host, 3, n, seed=60 + n, corrupt_every=3)
    got = _host_tables(host, *map(_guarded, (s, h, r, slots)), key_table,
                       base)
    plain = _plain_tables(s, h, r, slots, key_table, base)
    assert got.tolist() == plain.tolist() == expect


def test_table_slot_outside_the_rows_rejects_only_its_signature(host):
    """Slots outside [0, nslots) in the middle of a warp: those signatures
    are rejected (the key table is never read for them), their neighbours
    in the same warps keep their verdicts."""
    s, h, r, slots, key_table, base, expect = _tables_inputs(
        host, 3, 33, seed=15, corrupt_every=7)
    assert _host_tables(host, s, h, r, slots, key_table, base).tolist() \
        == expect
    bad = slots.copy()
    bad[[10, 12, 17]] = [len(key_table), -1, (1 << 31) - 1]
    want = np.array(expect)
    assert want[[10, 12, 17]].all()
    want[[10, 12, 17]] = False
    assert _host_tables(host, s, h, r, bad, key_table, base).tolist() \
        == want.tolist()


@pytest.mark.parametrize("steps", [0, 1, 4, 21])
def test_doubling_chain_body_matches_plain(host, steps):
    """The chain-floor check kernel's body (`steps` q_dbl of a quad, in
    precomputed form) equals the plain chain of point_dbl, at a ragged n
    whose inputs end at a page with no access."""
    xy = np.ascontiguousarray(np.concatenate(
        [_device_inputs(*_signed_batch(3, 3, seed=70, corrupt_every=9))[3][:, :2],
         tables.base_xy()]))
    n, guarded = len(xy), _guarded(xy)
    out = np.full((n + 1, 4, 32), SENTINEL, dtype=np.uint8)
    host.host_dbl_chain(_ptr(guarded), n, steps, _ptr(out))
    assert (out[n] == SENTINEL).all()
    assert np.array_equal(out[:n], tables.dbl_chain_plain(
        torch.from_numpy(xy), steps).numpy())


@pytest.mark.parametrize("case", range(8))
def test_table_bodies_on_adversarial_vectors(host, adversarial, monkeypatch,
                                             case):
    """chip_smoke's adversarial vectors through the verifier's host prep
    with hot_threshold 1, so that every key that passes the prep is hot:
    its table built by K-B's body and its signatures verified by K-T's, as
    host C++ (each call checked against the plain version).  The verdicts
    are libsodium's."""
    name, cases, expected = adversarial[case]
    t = torch.from_numpy
    calls = {"K-B": 0, "K-T": 0}

    def host_kb(table, slots, key_xy):
        plain = tables._build_tables_into_plain(table.clone(), slots, key_xy)
        host.host_build_tables(_ptr(key_xy.numpy()), _ptr(slots.numpy()),
                               len(slots), table.data_ptr(), len(table))
        assert torch.equal(table, plain)
        calls["K-B"] += 1
        return table

    def host_kt(s, h, slots, r, key_table, base):
        got = _host_tables(host, *(a.numpy() for a in
                                   (s, h, r, slots, key_table, base)))
        assert got.tolist() == tables.verify_tables_forward(
            s, h, slots, r, key_table, base).tolist()
        calls["K-T"] += 1
        return t(got)

    monkeypatch.setattr(tables, "build_tables_into", host_kb)
    monkeypatch.setattr(tables, "verify_tables", host_kt)
    monkeypatch.setattr(tables, "_base_tables", {})
    v = ed25519.Ed25519BatchVerifier(chunk_size=32, hot_threshold=1,
                                     device="cpu")
    pks, sigs, msgs = (list(c) for c in zip(*cases))
    assert v.verify(pks, sigs, msgs).tolist() == expected, name
    assert v.stats["generic_sigs"] == 0, name
    assert (calls["K-B"] and calls["K-T"]) or not any(expected), name


def random_quorum_rows(qmap, n_rows, seed):
    """A map's tables as the CUDA checker holds them, plus random child
    rows (each of its own density, so some are quorums), a random
    remaining-mask and the all-nodes scc, as int64 words."""
    ck = quorum.CudaQuorumIntersectionChecker(qmap, device="cpu")
    rng = np.random.default_rng(seed)
    n, w = ck.n, ck.n_words
    member = rng.random((n_rows, n)) < rng.uniform(0.2, 1.0, (n_rows, 1))
    rows = quorum._masks_to_words(
        [sum(1 << int(i) for i in np.nonzero(m)[0]) for m in member], w)
    rem = quorum._masks_to_words([int(rng.integers(1 << min(n, 62)))], w)[0]
    scc = quorum._masks_to_words([(1 << n) - 1], w)[0]
    return ck, rows, rem, scc


def _twice_held_map():
    """Six nodes whose qsets hold one inner set twice: 3 of [A, A, B]."""
    ids = [testutils.nid(i) for i in range(6)]
    a, b = testutils.qset(2, ids[:3]), testutils.qset(2, ids[3:])
    return {v: testutils.qset(3, inner=[a, a, b]) for v in ids}


def _tiered_map():
    """Nodes of three classes: a tier of 3 orgs needing 2 of them, a
    second tier needing all 3, and watchers with a top mask and fewer
    inner sets."""
    orgs = [[testutils.nid(10 * o + i) for i in range(3)] for o in range(3)]
    inner = [testutils.qset(2, org) for org in orgs]
    qmap = {}
    for o, org in enumerate(orgs):
        for v in org:
            qmap[v] = testutils.qset(2 + (o == 2), inner=inner)
    for j in range(3):
        v = testutils.nid(100 + j)
        qmap[v] = testutils.qset(2, [orgs[0][0]], inner=inner[:2])
    return qmap


QUORUM_CASES = [
    ("asym5-W1", testutils.asym_org_qmap(5)),
    ("flat40-W2", testutils.flat_qmap(40, 30)),
    ("org13-W2", testutils.org_qmap(13, 3, 7, 2)),
    ("split7-W1", testutils.org_qmap(7, 3, 3, 2)),
    ("split67-W7", testutils.org_qmap(67, 3, 20, 2)),
    ("rings16-W1", testutils.adversarial_quorum_map(16)),
    ("twice-W1", _twice_held_map()),
    ("tiers-W1", _tiered_map())]
# maps the fast body does not take: rows of 9 words (257 nodes), and
# tables too large for shared memory (each of 256 nodes its own qset)
WIDE_CASES = [
    ("watched-W9", testutils.watched_org_qmap(4, 3, 3, 2, 245)),
    ("split-watched-W9", testutils.watched_org_qmap(4, 3, 2, 2, 245)),
    ("scattered-W8", testutils.scattered_qmap(256, 16, seed=3))]


def _quorum_rows_and_want(name, qmap):
    """The checker, random rows, rem, scc, the plain child_flags packed as
    the body's bits, and the tables' blob and dims."""
    ck, rows, rem, scc = random_quorum_rows(qmap, 300, seed=len(name))
    t = torch.from_numpy
    dead, is_q, wit = quorum.child_flags(t(rows), t(rem), t(scc), ck.top_thr,
                                         ck.top_masks, ck.inner_thr,
                                         ck.inner_masks)
    want = ((~dead & ~is_q).int() | is_q.int() << 1 | wit.int() << 2).numpy()
    assert is_q.any() and (~dead & ~is_q).any(), name
    assert wit.any() == ("split" in name), name
    return ck, rows, rem, scc, want


def _host_flags(host, ck, rows, rem, scc, body):
    blob = np.ascontiguousarray(ck.tables.blob.numpy())
    out = np.zeros(len(rows), dtype=np.uint8)
    rc = host.host_quorum_flags(_ptr(rows), len(rows), _ptr(rem), _ptr(scc),
                                _ptr(blob), *ck.tables.dims, body,
                                _ptr(out))
    return rc, out


@pytest.mark.parametrize("name,qmap", QUORUM_CASES)
def test_quorum_flags_body_matches_plain(host, name, qmap):
    """K-QF's fast body (csrc/quorum.cuh: node classes, the slice-pass
    results in registers where the map allows, else in memory) on the
    tables flag_tables makes equals the plain child_flags on the padded
    ones; the shared memory and blob the wrapper sizes are the kernel's."""
    ck, rows, rem, scc, want = _quorum_rows_and_want(name, qmap)
    tabs = ck.tables
    regs = quorum.regs_fit(tabs)
    for body in (0, 1):
        rc, out = _host_flags(host, ck, rows, rem, scc, body)
        if body == 0 and not regs:
            assert rc == -1, name
            continue
        assert rc == 0 and out.tolist() == want.tolist(), (name, body)
    sizes = np.zeros(5, dtype=np.int64)
    host.host_quorum_sizes(*tabs.dims, quorum.QF_THREADS, _ptr(sizes))
    assert sizes[0] == len(tabs.blob), name
    assert bool(sizes[1]) == regs, name
    assert quorum.flags_smem_bytes(tabs) == sizes[3 if regs else 2], name
    assert quorum.flags_path(tabs) == "fast", name


@pytest.mark.parametrize("name,qmap", QUORUM_CASES + WIDE_CASES)
@pytest.mark.parametrize("body", [2, 3], ids=["wide", "global"])
def test_quorum_wide_bodies_match_plain(host, name, qmap, body):
    """K-QF's wide body (any width, a thread's rows and results in a
    scratch array interleaved by thread) with the tables read as from
    shared memory and through the global-table accessor equals the plain
    child_flags; the wrapper picks the wide path for 9-word rows and the
    global one for tables past FLAGS_SMEM_MAX."""
    ck, rows, rem, scc, want = _quorum_rows_and_want(name, qmap)
    rc, out = _host_flags(host, ck, rows, rem, scc, body)
    assert rc == 0 and out.tolist() == want.tolist(), name
    path = quorum.flags_path(ck.tables)
    if name.endswith("W9"):
        assert ck.n_words == 9 and path == "wide"
        assert quorum.flags_smem_bytes(ck.tables) == 4 * len(ck.tables.blob)
    if name.startswith("scattered"):
        assert path == "global"
        assert quorum.flags_smem_bytes(ck.tables) > quorum.FLAGS_SMEM_MAX
        assert _host_flags(host, ck, rows, rem, scc, 1)[1].tolist() == \
            want.tolist()


def _mask(words) -> int:
    return sum(int(x) << (32 * i) for i, x in enumerate(words))


@pytest.mark.parametrize("name,qmap", QUORUM_CASES + WIDE_CASES[:1]
                         + [("asym7", testutils.asym_org_qmap(7))])
def test_flag_tables_classes_partition_the_nodes(name, qmap):
    """The node classes partition the nodes, and every member of a class
    has the class's top threshold, top mask and pairs; asym7 (and every
    map whose nodes share one qset shape) is one class."""
    ck = quorum.CudaQuorumIntersectionChecker(qmap, device="cpu")
    t = quorum.flag_arrays(*ck._map())
    assert ck.tables.dims[0] == len(t.class_thr), name
    masks = [_mask(m) for m in t.class_members.tolist()]
    assert sum(masks) == (1 << ck.n) - 1, name
    assert all(a & b == 0 for i, a in enumerate(masks) for b in masks[i + 1:])
    for c, m in enumerate(masks):
        for i in range(ck.n):
            if m >> i & 1:
                assert int(t.top_thr[i]) == int(t.class_thr[c])
                assert int(t.top_of[i]) == int(t.class_top[c])
                assert t.node_pairs[i].tolist() == t.class_pairs[c].tolist()
    n_classes = len(masks)
    if name in ("asym7", "asym5-W1", "split7-W1", "org13-W2", "flat40-W2",
                "watched-W9"):
        assert n_classes == 1, name
    if name == "tiers-W1":
        assert n_classes == 3
    if name == "rings16-W1":
        assert n_classes == 16


def test_flag_tables_hold_each_set_once():
    """asym7: 27 nodes, one (empty) top mask and the 7 orgs' inner sets;
    a set a qset holds twice is two pairs; padding is left out."""
    def arrays(qmap):
        ck = quorum.CudaQuorumIntersectionChecker(qmap, device="cpu")
        return quorum.flag_arrays(*ck._map())

    asym7 = arrays(testutils.asym_org_qmap(7))
    assert (len(asym7.tops), len(asym7.pairs)) == (1, 7)
    assert asym7.node_pairs.tolist() == [[0x7F]] * 27
    twice = arrays(_twice_held_map())
    assert twice.pair_thr.tolist() == [2, 2, 2]
    assert twice.node_pairs.tolist() == [[0b111]] * 6
    flat = arrays(testutils.flat_qmap(5, 3))
    assert flat.pairs.shape == (0, 1) and flat.node_pairs.shape == (5, 0)


@pytest.mark.parametrize("source,entry", [
    ("verify_generic", ed25519._K_G), ("verify_generic", ed25519._K_W),
    ("tables", tables._K_B),
    ("tables", tables._K_T), ("fe_check", field._FE_CHECK),
    ("fe_check", tables._DBL_CHAIN),
    ("quorum", quorum._K_QF), ("quorum", quorum._K_QC)],
    ids=lambda v: v if isinstance(v, str) else v[0])
def test_ctypes_argtypes_match_the_c_entry(source, entry):
    """Each wrapper's ctypes argtypes follow its C entry's parameters one
    for one (pointer, int64_t, int; the stream last): a missing one would
    pass the stream, a 64-bit pointer, as a 32-bit int."""
    name, argtypes = entry
    text = (CSRC / f"{source}.cu").read_text()
    params = re.search(rf'extern "C" int {name}\((.*?)\)', text,
                       re.S).group(1).split(",")
    kinds = [ctypes.c_void_p if "*" in p else
             ctypes.c_int64 if "int64_t" in p else ctypes.c_int
             for p in params]
    assert argtypes == kinds
