"""Philox4x32-10, the generator of the kernels' ``prng='hw'`` path, on the
CPU: ``ops.philox.philox4x32_10`` against Random123's known answers and
against a written-out Python version on Python integers, and its 16-bit
split multiply against exact products. Tolerance: bitwise."""

import numpy as np
import pytest
import torch

from deap_tpu_torch.ops import philox

KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]
M = 0xFFFFFFFF


def _philox_python(ctr, key):
    """Philox4x32-10 on Python integers (Random123, philox.h)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & M, (k1 + 0xBB67AE85) & M
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & M, (p0 >> 32) ^ c3 ^ k1,
                          p0 & M)
    return c0, c1, c2, c3


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_known_answers(ctr, key, want):
    got = philox.philox4x32_10(torch.tensor(ctr), torch.tensor(key))
    assert got.dtype == torch.int64
    assert tuple(got.tolist()) == want
    assert _philox_python(ctr, key) == want


@pytest.mark.parametrize("dtype", [torch.int64, torch.uint32])
def test_known_answers_batched_from_uint32(dtype):
    ctr = torch.tensor([c for c, _, _ in KAT]).to(dtype)
    key = torch.tensor([k for _, k, _ in KAT]).to(dtype)
    assert philox.philox4x32_10(ctr, key).tolist() == [list(w)
                                                        for _, _, w in KAT]


def test_random_counters_match_the_python_version():
    rng = np.random.default_rng(0)
    ctr = rng.integers(0, 2**32, (300, 4), dtype=np.int64)
    key = rng.integers(0, 2**32, (300, 2), dtype=np.int64)
    got = philox.philox4x32_10(torch.from_numpy(ctr), torch.from_numpy(key))
    want = [_philox_python(tuple(c), tuple(k))
            for c, k in zip(ctr.tolist(), key.tolist())]
    assert got.tolist() == [list(w) for w in want]


@pytest.mark.parametrize("seed", [0, 1])
def test_mulhilo32_against_python_integers(seed):
    rng = np.random.default_rng(seed)
    edges = np.array([0, 1, 2**16 - 1, 2**16, 2**31 - 1, 2**31, 2**32 - 1],
                     dtype=np.int64)
    a = np.concatenate([rng.integers(0, 2**32, 5000, dtype=np.int64),
                        np.repeat(edges, len(edges))])
    b = np.concatenate([rng.integers(0, 2**32, 5000, dtype=np.int64),
                        np.tile(edges, len(edges))])
    hi, lo = philox.mulhilo32(torch.from_numpy(a), torch.from_numpy(b))
    prod = [x * y for x, y in zip(a.tolist(), b.tolist())]
    assert hi.tolist() == [p >> 32 for p in prod]
    assert lo.tolist() == [p & M for p in prod]
    # a product past 2^63 is where a plain int64 multiply would overflow
    assert max(prod) >= 2**63


def test_draws_are_philox_of_the_layout_counters():
    key = torch.tensor([12345, 0xDEADBEEF])
    rows, calls = torch.arange(5)[:, None], torch.arange(3)[None, :]
    got = philox.draws(key, rows, calls, 7, philox.GENES)
    assert got.shape == (5, 3, 4)
    for i in range(5):
        for j in range(3):
            assert tuple(got[i, j].tolist()) == _philox_python(
                (i, j, 7, philox.GENES), (12345, 0xDEADBEEF))
