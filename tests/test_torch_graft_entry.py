"""The port's graft entry (stellar_core_tpu_torch/graft_entry.py) against
the JAX package's __graft_entry__.py, on the CPU.

* ``_example_batch`` makes the reference's inputs exactly: the windows,
  the key limbs as the port's key rows, the R bytes; with libsodium or
  with the port's RFC 8032 signer.
* ``verify_windows``'s plain version (K-W's, what the wrapper runs on a
  CPU tensor) gives the reference's ``verify_forward`` verdicts, with an R
  corrupted, a window altered and a key swapped, and its count is their
  sum.
* ``entry`` and ``dryrun_multigpu(4, device="cpu")`` run.
"""

import numpy as np
import pytest
import torch

from stellar_core_tpu_torch import convert, graft_entry
from stellar_core_tpu_torch.accel import ed25519 as TE
from stellar_core_tpu_torch.crypto import rfc8032, sodium

jnp = pytest.importorskip("jax.numpy")
Ej = pytest.importorskip("stellar_core_tpu.accel.ed25519")
import __graft_entry__ as ref_entry  # noqa: E402


@pytest.fixture
def libsodium():
    if not sodium.available():
        pytest.skip("libsodium is the oracle of these checks")


@pytest.mark.parametrize("n", [8, 40])
def test_example_batch_equals_the_jax_packages(n):
    windows, cx, cy, ct, r_bytes = ref_entry._example_batch(n)
    got_windows, keys, got_r = graft_entry._example_batch(n)
    assert got_windows.dtype == np.int32 and got_windows.shape == (127, n)
    assert np.array_equal(got_windows, np.asarray(windows))
    assert np.array_equal(keys, convert.key_rows_from_jax(cx, cy, ct))
    assert np.array_equal(got_r, np.asarray(r_bytes))


def test_example_batch_is_the_same_without_libsodium(libsodium, monkeypatch):
    with_sodium = graft_entry._example_batch(8, seed=3)
    monkeypatch.setattr(sodium, "_lib", None)
    assert not sodium.available()
    without = graft_entry._example_batch(8, seed=3)
    assert all(np.array_equal(a, b) for a, b in zip(with_sodium, without))


def test_rfc8032_signer_equals_libsodium(libsodium):
    for i in range(4):
        seed = bytes([i]) * 32
        pk, sk = rfc8032.keypair(seed)
        assert (pk, sk) == sodium.sign_seed_keypair(seed)
        for msg in (b"", b"m", bytes(range(64)), bytes(200)):
            assert rfc8032.sign(msg, sk) == sodium.sign_detached(msg, sk)
    assert sodium.available()


def test_verdicts_equal_jax_verify_forward():
    """40 signatures: R of 1 corrupted, a window of 2 altered, the key of 3
    swapped for 4's; all exact, and the count is the sum."""
    windows, cx, cy, ct, r_bytes = (np.array(a) for a in
                                    ref_entry._example_batch(40))
    r_bytes[1, 0] ^= 1
    windows[60, 2] = (windows[60, 2] + 1) % 16
    cx[3], cy[3], ct[3] = cx[4], cy[4], ct[4]
    want = np.asarray(Ej._verify_kernel(*(jnp.asarray(a) for a in (
        windows, cx, cy, ct, r_bytes))))
    assert np.nonzero(~want)[0].tolist() == [1, 2, 3]
    keys = convert.key_rows_from_jax(cx, cy, ct)
    count = torch.full((1,), 5, dtype=torch.int32)
    launches = TE.verify_windows.launches
    got = TE.verify_windows(torch.from_numpy(windows), torch.from_numpy(keys),
                            torch.from_numpy(r_bytes), count=count)
    assert got.tolist() == want.tolist()
    assert int(count) == 5 + 37          # the count is added to
    assert TE.verify_windows.launches == launches   # CPU: plain, no launch
    assert TE.verify_windows_plain(torch.from_numpy(windows),
                                   torch.from_numpy(keys),
                                   torch.from_numpy(r_bytes)).tolist() == \
        want.tolist()


@pytest.mark.parametrize("bad", [16, -1])
def test_plain_version_refuses_windows_outside_the_table(bad):
    windows, keys, r_bytes = graft_entry._example_batch(4)
    windows[0, 2] = bad
    with pytest.raises(ValueError, match=r"outside \[0, 16\)"):
        TE.verify_windows(*map(torch.from_numpy, (windows, keys, r_bytes)))


def test_windows_msb_first_equals_the_references():
    rng = np.random.default_rng(9)
    s = rng.integers(0, 256, (6, 32), dtype=np.uint8)
    h = rng.integers(0, 256, (6, 32), dtype=np.uint8)
    s[:, 31] &= 0x1F   # scalars below 2^253, as S < L and h mod L are
    h[:, 31] &= 0x1F
    assert np.array_equal(TE._windows_msb_first(s, h),
                          Ej._windows_msb_first(s, h))
    # the kernel's window source derives the same windows (K-G's form)
    assert np.array_equal(TE._windows(torch.from_numpy(s),
                                      torch.from_numpy(h)).numpy(),
                          TE._windows_msb_first(s, h))


def test_entry_on_the_cpu():
    fn, args = graft_entry.entry(device="cpu")
    assert fn is TE.verify_windows
    assert [tuple(a.shape) for a in args] == [(127, 8), (8, 3, 32), (8, 32)]
    assert [a.dtype for a in args] == [torch.int32, torch.uint8, torch.uint8]
    assert fn(*args).tolist() == [True] * 8


def test_shard_devices():
    cpu = torch.device("cpu")
    assert graft_entry.shard_devices(4, "cpu") == (cpu,) * 4


def test_dryrun_multigpu_on_four_cpu_shards(capsys):
    """The dry run's two checks: 128 signatures in 4 shards, the shards'
    counts summed; the safe and splitting maps through the checker sharded
    over the same 4 shards with batch_size 8."""
    summary = graft_entry.dryrun_multigpu(4, device="cpu")
    assert summary == {"signatures": 128, "shards": 4, "cards": 0,
                       "accept_total": 128, "safe_intersects": True,
                       "split_intersects": False,
                       "split_max_quorums_found": 16}
    assert "dryrun_multigpu OK" in capsys.readouterr().out
