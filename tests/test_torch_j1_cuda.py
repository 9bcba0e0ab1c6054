"""J1 (``csrc/jacobi_eigh.cu``) on the card at the edges of its design
beyond ``chip_smoke.J1_DIMS``: the fourth and fifth pivot warps (d 193,
257), an odd and an even d on each side of a split change in device
memory (184, 185, 200), sweep counts 0 to 2, batches on each side of
half the card's SMs (two SMs a matrix, then one), and pivot threads that
take their pairs in turn: forced to one warp at d 100, 171 and 192, and
as the plan gives them past 960 pairs (d 1,922, one sweep: no plain
version at that size, whose tables take tens of GB; its ``w`` and V held
against ``Vᵀ C V`` and orthonormality at ``linalg.JACOBI_RECON_TOL``).

These tests need a CUDA card and the CUDA toolkit; they skip without a
card. On a machine with one, from the repository's root:

    python -m pytest tests/test_torch_j1_cuda.py -m cuda -q --noconftest

Tolerance: J1 equals its plain version bitwise, signed zeros included.
"""

import pytest
import torch

from chip_smoke import j1_inputs
from deap_tpu_torch.ops import linalg

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _check(C, sweeps=None):
    before = linalg.eigh_jacobi.launches
    w, V = linalg.eigh_jacobi(C, sweeps)
    wp, Vp = linalg.eigh_jacobi_plain(C, sweeps)
    torch.cuda.synchronize()
    assert linalg.eigh_jacobi.launches == before + 1
    return _same(w, wp) and _same(V, Vp)


@pytest.mark.parametrize("d,batch", [(184, 2), (185, 1), (193, 1),
                                     (200, 1), (257, 1)])
def test_j1_equals_plain_in_device_memory(card, d, batch):
    eye = torch.eye(d, device=card)
    for name, C in j1_inputs(torch, card, d, batch, eye).items():
        if name in ("spd", "tiny_offdiagonal"):
            assert _check(C), (d, batch, name)


@pytest.mark.parametrize("d", [2, 3, 4, 10, 30, 100, 169, 170, 171])
def test_j1_equals_plain_with_few_rounds(card, d):
    C = j1_inputs(torch, card, d, 2, torch.eye(d, device=card))["spd"]
    for sweeps in (0, 1, 2):
        assert _check(C, sweeps), (d, sweeps)


def _half_the_sms(card):
    return torch.cuda.get_device_properties(card).multi_processor_count // 2


@pytest.mark.parametrize("d", [40, 64, 100, 170])
def test_j1_equals_plain_on_one_and_two_sms(card, d):
    # half the SMs' matrices split over two SMs each, one more on one SM each
    most = _half_the_sms(card)
    for batch in (most, most + 1):
        C = j1_inputs(torch, card, d, batch, torch.eye(d, device=card))
        assert _check(C["spd"]) and _check(C["tiny_offdiagonal"]), (d, batch)


def test_j1_layout_at_the_shared_limit(card):
    # 2 ring slots at 169, 1 at 170 with an even row stride, device memory
    # at 171; each split over two SMs (batch 1) and on one SM
    assert [linalg._j1_layout(d)[::2] for d in (169, 170, 171)] == [
        (169, 2), (170, 1), (0, 2)]
    for d in (169, 170):
        for batch in (1, _half_the_sms(card) + 1):
            C = j1_inputs(torch, card, d, batch, torch.eye(d, device=card))
            assert _check(C["spd"]), (d, batch)


@pytest.mark.parametrize("d,batch", [(100, None), (171, 1), (192, 2)])
def test_j1_equals_plain_with_pairs_in_turn(card, monkeypatch, d, batch):
    # one pivot warp for 50, 86 and 96 pairs (on one SM a matrix: a split
    # gives each pair a thread)
    batch = batch or _half_the_sms(card) + 1
    monkeypatch.setattr(linalg, "_j1_pivots", lambda d: 32)
    C = j1_inputs(torch, card, d, batch, torch.eye(d, device=card))
    assert _check(C["spd"]) and _check(C["tiny_offdiagonal"]), d


def test_j1_past_a_pivot_thread_a_pair(card):
    d = 2 * linalg.J1_MAX_PIVOT_THREADS + 2  # 961 pairs, 128 pivot threads
    assert linalg._j1_pivots(d) == linalg.J1_PAIRS_IN_TURN_THREADS
    C = j1_inputs(torch, card, d, 1, torch.eye(d, device=card))["spd"][0]
    before = linalg.eigh_jacobi.launches
    w, V = linalg.eigh_jacobi(C, 1)
    torch.cuda.synchronize()
    assert linalg.eigh_jacobi.launches == before + 1
    assert bool(torch.isfinite(w).all() and torch.isfinite(V).all())
    assert bool((w[1:] >= w[:-1]).all())
    C64, V64 = C.double(), V.double()
    scale = float(C64.abs().max())
    eye = torch.eye(d, dtype=torch.float64, device=card)
    # one sweep leaves A = Vᵀ C V off diagonal; its diagonal is w
    diag = torch.diagonal(V64.T @ C64 @ V64)
    assert float((diag - w.double()).abs().max()) <= (
        linalg.JACOBI_RECON_TOL * scale)
    assert float((V64.T @ V64 - eye).abs().max()) <= linalg.JACOBI_RECON_TOL
