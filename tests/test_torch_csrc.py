"""The CUDA kernels' device code, compiled as host C++, against the plain
PyTorch versions and python big-int ground truth (CPU, exact equality).

csrc/*.cuh hold every kernel's per-thread body and compile with a host C++
compiler as well as with nvcc; tests/torch_csrc_host.cpp loops over rows the
way the kernels' threads do.  This checks the kernels' arithmetic here,
without a card; chip_smoke.py checks the kernels themselves on the card.
"""

import ctypes
import hashlib
import random
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from stellar_core_tpu_torch.accel import curve, ed25519, field, tables
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
    lib.host_build_tables.argtypes = [VP, VP, i64, VP, i64]
    lib.host_verify_tables.argtypes = [VP, VP, VP, VP, i64, VP, i64, VP, VP]
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


def test_build_tables_body_matches_plain(host):
    """K-B's entries equal the plain build_tables' as canonical values, for
    a key of -A and for the base point (two slots of one table)."""
    pk, _ = sodium.sign_seed_keypair(bytes(range(32)))
    neg = ed25519.Ed25519BatchVerifier._decode_pk(pk)
    xy = np.ascontiguousarray(np.stack([neg[:2], tables.base_xy()[0]]))
    slots = np.array([1, 0], dtype=np.int32)
    table = tables.new_table(2, "cpu").numpy()
    host.host_build_tables(_ptr(xy), _ptr(slots), 2, _ptr(table), 2)
    plain = tables.build_tables(field.from_bytes(torch.from_numpy(xy[:, 0])),
                                field.from_bytes(torch.from_numpy(xy[:, 1])))
    assert np.array_equal(table[slots], field.to_bytes(plain).numpy())


def test_verify_tables_body_matches_plain_and_libsodium(host):
    pks, sigs, msgs = _signed_batch(2, 10, seed=12, corrupt_every=4)
    s, h, r, keys, kidx = _device_inputs(pks, sigs, msgs)
    xy = np.ascontiguousarray(np.concatenate([keys[:, :2], tables.base_xy()]))
    nk = len(keys)
    slots = np.arange(nk + 1, dtype=np.int32)
    table = tables.new_table(nk + 1, "cpu").numpy()
    host.host_build_tables(_ptr(xy), _ptr(slots), nk + 1, _ptr(table), nk + 1)
    base = np.ascontiguousarray(table[nk])
    out = np.zeros(len(s), dtype=np.uint8)
    host.host_verify_tables(_ptr(s), _ptr(h), _ptr(r), _ptr(kidx), len(s),
                            _ptr(table), nk, _ptr(base), _ptr(out))
    t = torch.from_numpy
    plain = tables.verify_tables_forward(t(s), t(h), t(kidx), t(r),
                                         t(table[:nk]), t(base))
    expect = [sodium.verify_detached(sg, m, pk) for pk, sg, m in zip(pks, sigs, msgs)]
    assert out.astype(bool).tolist() == plain.tolist() == expect
