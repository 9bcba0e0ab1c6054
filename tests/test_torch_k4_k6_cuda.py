"""K4's and K6's bits bodies (``prng='input'``) against their plain
versions, on the card, at the shapes their designs branch on.

These tests need a CUDA card and the CUDA toolkit; they skip without a
card. On a machine with one:

    python -m pytest tests/test_torch_k4_k6_cuda.py -m cuda -q --noconftest

K4 (``sel_tournament_gather_packed``): a thread a child, its aspirants 4 at
a time (draw loads together, then fitness loads together), tournaments of
1 to 9 (1 to 3 batches, the last part full), fitness from a few integer
values so that ties decide; the row copy as uint4 (W 4) or by the warp's
word walk. Bitwise against the plain version.

K6 (``fused_variation_eval_real``): tiles of 16 rows (K6-hw's of 64), n
below a tile, a partial tile, an odd last row, one column chunk (L <= 32)
and several, the rates at 0 and 1 (empty and full lists), each evaluation
(none: a callable afterwards). Against its plain version on ``real_bits`` streams at K6's
tolerance (``kernels_real.real_kernel_errors``), and bitwise against K6's
Philox path on the streams ``philox.hw_real_bits`` expands from its key
(one arithmetic, one sum order). Each wrapper counts one launch a call.
"""

import pytest
import torch

from deap_tpu_torch.device import make_generator
from deap_tpu_torch.ops import kernels, kernels_real, packed, philox

pytestmark = pytest.mark.cuda

K6_PROBS = dict(cxpb=0.5, mutpb=0.2, indpb=0.1, alpha=0.5, mu=0.0,
                sigma=0.3)
K6_EDGES = [{}, dict(cxpb=0.0, mutpb=0.0), dict(cxpb=1.0, mutpb=1.0,
                                                indpb=1.0),
            dict(cxpb=1.0, mutpb=1.0, indpb=0.0), dict(cxpb=0.0, indpb=1.0)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    if a.dtype in (torch.float32, torch.uint32):
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _offset(t, card):
    """``t``'s values in a tensor 4 bytes past a 16-byte boundary."""
    store = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
    view = store[1:].view(t.shape)
    view.copy_(t)
    return view


# ------------------------------------------------ K4 bits body ----

@pytest.mark.parametrize("tournsize", range(1, 10))
@pytest.mark.parametrize("L", [2, 100, 300])
@pytest.mark.parametrize("n", [1, 31, 33, 257, 1001, 100_000])
def test_k4_bits_body_equals_plain(card, n, L, tournsize):
    gen = make_generator(11 * n + L + tournsize, card)
    pk = packed.pack_genomes(torch.rand((n, L), generator=gen, device=card)
                             < 0.5)
    fit = torch.randint(0, 4, (n,), generator=gen, device=card).float()
    draws = packed.tournament_bits(gen, tournsize, n)
    k4 = packed.sel_tournament_gather_packed
    before = (k4.launches, k4.hw_launches)
    got = k4(pk, fit, draws)
    torch.cuda.synchronize()
    assert (k4.launches - before[0], k4.hw_launches - before[1]) == (1, 0)
    assert _same(got, packed.sel_tournament_gather_packed_plain(pk, fit,
                                                                draws))


@pytest.mark.parametrize("tournsize", [3, 5])
def test_k4_bits_body_draws_off_16_byte_alignment_equal_plain(card,
                                                              tournsize):
    n = 1001
    gen = make_generator(tournsize, card)
    pk = _offset(packed.pack_genomes(torch.rand((n, 100), generator=gen,
                                                device=card) < 0.5), card)
    fit = torch.randint(0, 4, (n,), generator=gen, device=card).float()
    draws = _offset(packed.tournament_bits(gen, tournsize, n), card)
    got = packed.sel_tournament_gather_packed(pk, fit, draws)
    torch.cuda.synchronize()
    assert _same(got, packed.sel_tournament_gather_packed_plain(pk, fit,
                                                                draws))


# ------------------------------------------------ K6 bits body ----

def _genomes(gen, card, n, L):
    return torch.rand((n, L), generator=gen, device=card) * 10.24 - 5.12


def _k6_bits_case(card, n, L, probs, evaluate, offset=False):
    gen = make_generator(13 * n + L, card)
    g = _genomes(gen, card, n, L)
    bits = kernels_real.real_bits(gen, n, L)
    if offset:
        bits = tuple(_offset(b, card) for b in bits)
    kw = dict(K6_PROBS, **probs, evaluate=evaluate)
    fn = kernels_real.fused_variation_eval_real
    before = (fn.launches, fn.hw_launches)
    got = fn(g, *bits, **kw)
    want = kernels_real.fused_variation_eval_real_plain(g, *bits, **kw)
    torch.cuda.synchronize()
    assert (fn.launches - before[0], fn.hw_launches - before[1]) == (1, 0)
    errs = kernels_real.real_kernel_errors(
        got, want, *bits, mutpb=kw["mutpb"], indpb=kw["indpb"], mu=kw["mu"],
        sigma=kw["sigma"])
    assert errs["ok"], errs
    if kw["cxpb"] == 0.0 and kw["mutpb"] == 0.0:
        assert _same(got[0], g)


@pytest.mark.parametrize("L", [1, 30, 31, 33, 64])
@pytest.mark.parametrize("n", [1, 2, 3, 15, 16, 17, 63, 64, 65, 129, 1001])
def test_k6_bits_body_tiles_equal_plain(card, n, L):
    for i, probs in enumerate(K6_EDGES):
        _k6_bits_case(card, n, L, probs, ("rastrigin", "sphere")[i % 2])


@pytest.mark.parametrize("evaluate", ["rastrigin", "sphere", "callable"])
@pytest.mark.parametrize("n,L", [(129, 30), (1001, 33), (100_000, 30)])
def test_k6_bits_body_evaluations_equal_plain(card, n, L, evaluate):
    _k6_bits_case(card, n, L, {}, kernels_real.eval_sphere
                  if evaluate == "callable" else evaluate)


@pytest.mark.parametrize("n,L", [(65, 30), (1001, 33)])
def test_k6_bits_body_streams_off_16_byte_alignment_equal_plain(card, n, L):
    _k6_bits_case(card, n, L, {}, "rastrigin", offset=True)


@pytest.mark.parametrize("L", [1, 30, 31, 33, 64])
@pytest.mark.parametrize("n", [1, 2, 3, 15, 16, 17, 63, 64, 65, 129, 1001])
def test_k6_bits_body_equals_philox_path_on_its_streams(card, n, L):
    """The bits body fed ``hw_real_bits`` gives K6-hw's children and
    fitness bitwise, at each rate edge."""
    gen = make_generator(17 * n + L, card)
    g = _genomes(gen, card, n, L)
    fn = kernels_real.fused_variation_eval_real
    for i, probs in enumerate(K6_EDGES):
        kw = dict(K6_PROBS, **probs, evaluate=("rastrigin", "sphere")[i % 2])
        key = kernels.philox_key(gen)
        hw = fn(g, prng="hw", key=key, **kw)
        body = fn(g, *philox.hw_real_bits(key, n, L), **kw)
        torch.cuda.synchronize()
        assert _same(hw[0], body[0]) and _same(hw[1], body[1]), probs
