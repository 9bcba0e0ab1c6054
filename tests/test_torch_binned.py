"""The binned tournament selector on the CPU: ``counting_order_desc`` in
both its modes bitwise against the JAX package's and against the port's
``lex_sort_desc``, and ``sel_tournament_binned`` against
``sel_tournament_sorted`` from the same generator state. Tolerance:
bitwise (integer bucket arithmetic; the ``'mxu'`` prefix counts at most
128 per tile in float32, exactly)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu.ops.selection import counting_order_desc as j_counting
from deap_tpu_torch import algorithms as talg
from deap_tpu_torch.core.fitness import lex_sort_desc
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.ops import packed as tp
from deap_tpu_torch.ops import selection as tsel


def _values(case, n, low, high, rng):
    if case == "ties":
        return rng.integers(low, high + 1, n).astype(np.float32)
    if case == "edges":  # only the lowest and the highest bucket
        return np.where(rng.random(n) < 0.5, low, high).astype(np.float32)
    if case == "one_bucket":
        return np.full(n, high, np.float32)
    raise ValueError(case)


@pytest.mark.parametrize("n", [1, 2, 127, 128, 129, 1000, 4099])
@pytest.mark.parametrize("case,low,high", [("ties", 0, 100),
                                           ("edges", 0, 100),
                                           ("ties", -5, 7),
                                           ("one_bucket", 3, 9)])
@pytest.mark.parametrize("mode", ["scan", "mxu"])
def test_counting_order_matches_jax_and_lex_sort(n, case, low, high, mode):
    v = _values(case, n, low, high, np.random.default_rng(n + abs(low)))
    got = tsel.counting_order_desc(torch.from_numpy(v), low, high, mode)
    assert got.dtype == torch.int64
    want = np.asarray(j_counting(jnp.asarray(v), low, high, mode))
    assert got.numpy().tolist() == want.tolist()
    assert torch.equal(got, lex_sort_desc(torch.from_numpy(v)[:, None]))


@pytest.mark.parametrize("mode", ["scan", "mxu", "auto"])
def test_counting_order_rounds_and_clips_as_jax_does(mode):
    rng = np.random.default_rng(1)
    # out of range and half-integer values: rounded (half to even) and
    # clipped into the edge buckets, in both packages
    v = (rng.integers(-20, 130, 700) / 2).astype(np.float32)
    got = tsel.counting_order_desc(torch.from_numpy(v), 0, 50, mode)
    want = np.asarray(j_counting(jnp.asarray(v), 0, 50,
                                 "scan" if mode == "auto" else mode))
    assert got.numpy().tolist() == want.tolist()


def test_counting_order_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown counting_order_desc mode"):
        tsel.counting_order_desc(torch.zeros(4), 0, 3, "radix")


@pytest.mark.parametrize("n,k,tournsize", [(1, 1, 3), (50, 50, 1),
                                           (301, 301, 3), (500, 123, 5)])
def test_binned_winners_equal_sorted_winners(n, k, tournsize):
    w = torch.from_numpy(np.random.default_rng(n).integers(
        0, 30, (n, 1)).astype(np.float32))
    got = tsel.sel_tournament_binned(make_generator(n, "cpu"), w, k,
                                     tournsize, 0, 29)
    want = tsel.sel_tournament_sorted(make_generator(n, "cpu"), w, k,
                                      tournsize)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_binned_checks_range_and_integrality():
    gen = make_generator(0, "cpu")
    w = torch.tensor([[0.0], [5.0], [11.0]])
    with pytest.raises(ValueError, match="outside the declared integer"):
        tsel.sel_tournament_binned(gen, w, 3, 3, 0, 10)
    with pytest.raises(ValueError, match="outside the declared integer"):
        tsel.sel_tournament_binned(gen, w - 1.0, 3, 3, 0, 11)
    with pytest.raises(ValueError, match="not integer-valued"):
        tsel.sel_tournament_binned(gen, w + 0.5, 3, 3, 0, 12)


def test_ea_simple_packed_binned_equals_sorted():
    pk = tp.pack_genomes(torch.from_numpy(
        np.random.default_rng(3).random((257, 100)) < 0.5))
    fit = tp.packed_fitness(pk)
    runs = [talg.ea_simple_packed(make_generator(7, "cpu"), pk, fit, 100, 4,
                                  cxpb=0.5, mutpb=0.2, indpb=0.05,
                                  select=select, prng=prng, device="cpu")
            for select in ("sorted", "binned") for prng in ("input", "hw")]
    for a, b in ((runs[0], runs[2]), (runs[1], runs[3])):
        assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
        assert torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="unknown select"):
        talg.ea_simple_packed(make_generator(7, "cpu"), pk, fit, 100, 1,
                              cxpb=0.5, mutpb=0.2, indpb=0.05,
                              select="radix", device="cpu")
