"""The Jacobi eigensolver (``ops.linalg``, J1's plain version) against the
JAX package's ``deap_tpu.ops.linalg.eigh_jacobi``, jitted on the CPU as
the JAX package's own tests run it.

Tolerances (``ops.linalg``'s stated ones): eigenvalues within
``JACOBI_W_RTOL`` of the largest (XLA contracts ``a*b + c`` in the
jitted rounds, the port rounds each operation: measured 7.8e-6 at d 100
over 6 seeds); eigenvectors, where an eigenvalue stands ``EIG_GAP`` of
the largest apart from its neighbours, with ``|dot|`` at least ``1 −
BASIS_TOL`` (measured 2.4e-7); reconstruction and orthogonality within
``JACOBI_RECON_TOL`` of the largest entry (measured 3.3e-5 and 2.2e-5).
The schedule is equal, batched equals solo bit for bit, and a numpy
replay of J1's in-place round (rows rotated in place pair by pair, then
columns) equals the plain version bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu.ops import linalg as jlinalg
from deap_tpu_torch.ops import linalg
from deap_tpu_torch.strategies.cma import BASIS_TOL, EIG_GAP

_JAX_EIGH = jax.jit(jlinalg.eigh_jacobi)


def _spd(rng, shape):
    d = shape[-1]
    M = rng.standard_normal(shape).astype(np.float32)
    return (M @ np.swapaxes(M, -1, -2) + d * np.eye(d)).astype(np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("d", range(1, 41))
def test_schedule_equals_the_reference(d):
    ps, qs = linalg._round_robin_schedule(d)
    jps, jqs = jlinalg._round_robin_schedule(d)
    assert ps.dtype == jps.dtype == np.int32
    np.testing.assert_array_equal(ps, jps)
    np.testing.assert_array_equal(qs, jqs)
    # every unordered pair once a sweep, an odd d's bye as a self-pair
    pairs = {(int(p), int(q)) for p, q in zip(ps.ravel(), qs.ravel())
             if p != q}
    assert len(pairs) == d * (d - 1) // 2
    assert int((ps == qs).sum()) == (ps.shape[0] if d % 2 else 0)


def _check_against_reference(C, w, V):
    wj, Vj = (np.asarray(a) for a in _JAX_EIGH(jnp.asarray(C)))
    d = C.shape[-1]
    assert w.shape == wj.shape and V.shape == Vj.shape
    top = np.abs(wj).max(-1, keepdims=True)
    assert (np.abs(w - wj) <= linalg.JACOBI_W_RTOL * top).all()
    assert (np.diff(w, axis=-1) >= 0).all()
    for Cm, wm, Vm, wjm, Vjm in zip(C.reshape(-1, d, d), w.reshape(-1, d),
                                    V.reshape(-1, d, d), wj.reshape(-1, d),
                                    Vj.reshape(-1, d, d)):
        ev = wjm.astype(np.float64)
        gaps = np.diff(ev)
        apart = np.minimum(np.r_[np.inf, gaps], np.r_[gaps, np.inf]) \
            > EIG_GAP * np.abs(ev).max()
        dots = np.abs((Vm.astype(np.float64) * Vjm).sum(0))
        assert (1 - dots[apart] <= BASIS_TOL).all()
        big = np.abs(Cm).max()
        recon = (Vm.astype(np.float64) * wm) @ Vm.T - Cm
        assert np.abs(recon).max() <= linalg.JACOBI_RECON_TOL * big
        orth = Vm.T.astype(np.float64) @ Vm - np.eye(d)
        assert np.abs(orth).max() <= linalg.JACOBI_RECON_TOL


@pytest.mark.parametrize("d", [1, 2, 3, 6, 8, 9, 16, 33, 64, 100])
def test_plain_matches_the_reference(d):
    C = _spd(np.random.default_rng(d), (d, d))
    w, V = linalg.eigh_jacobi(torch.from_numpy(C))
    _check_against_reference(C, w.numpy(), V.numpy())


@pytest.mark.parametrize("shape", [(8, 6, 6), (2, 3, 5, 5)])
def test_batched_plain_matches_the_reference_and_solo(shape):
    C = _spd(np.random.default_rng(len(shape)), shape)
    w, V = linalg.eigh_jacobi(torch.from_numpy(C))
    _check_against_reference(C, w.numpy(), V.numpy())
    d = shape[-1]
    flat_w, flat_V = w.reshape(-1, d), V.reshape(-1, d, d)
    for k, Cm in enumerate(C.reshape(-1, d, d)):
        ws, Vs = linalg.eigh_jacobi_plain(torch.from_numpy(Cm))
        assert np.array_equal(_bits(ws), _bits(flat_w[k]))
        assert np.array_equal(_bits(Vs), _bits(flat_V[k]))


def _j1_replay(C, sweeps):
    """J1's arithmetic in numpy float32, as the kernel orders it: each
    pair's c and s, then rows rotated in place pair by pair, then columns
    of A (the rotated pivots times 0) and of V."""
    f = np.float32
    d = C.shape[0]
    ps, qs = linalg._round_robin_schedule(d)
    A = f(0.5) * (C + C.T)
    V = np.eye(d, dtype=np.float32)
    tiny = np.finfo(np.float32).tiny
    for it in range(sweeps * ps.shape[0]):
        rot = []
        for p, q in zip(ps[it % ps.shape[0]], qs[it % ps.shape[0]]):
            small = abs(A[p, q]) <= tiny or p == q
            tau = (A[q, q] - A[p, p]) / (f(1) if small else f(2) * A[p, q])
            t = np.sign(tau) / (abs(tau) + np.sqrt(f(1) + tau * tau))
            t = f(1) if tau == 0 else t
            c = f(1) / np.sqrt(f(1) + t * t)
            s = f(0) if small else t * c
            rot.append((p, q, f(1) if small else c, s))
        for p, q, c, s in rot:
            ap, aq = A[p].copy(), A[q].copy()
            if p == q:
                A[p] = c * ap + s * ap
            else:
                A[p], A[q] = c * ap + (-s) * aq, c * aq + s * ap
        for p, q, c, s in rot:
            for M, pivots in ((A, True), (V, False)):
                mp, mq = M[:, p].copy(), M[:, q].copy()
                if p == q:
                    M[:, p] = c * mp + s * mp
                    continue
                M[:, p], M[:, q] = c * mp + (-s) * mq, c * mq + s * mp
                if pivots:
                    M[q, p] *= f(0)
                    M[p, q] *= f(0)
    order = np.argsort(np.diag(A), kind="stable")
    return np.diag(A)[order], V[:, order]


def _special_inputs(d, rng):
    """The inputs where a kernel quietly differs: a random SPD matrix, the
    identity (every pair `small`), a diagonal with repeated entries, an
    off-diagonal below ``tiny`` (subnormal) and an indefinite matrix."""
    tiny_off = np.diag(rng.standard_normal(d).astype(np.float32))
    if d > 1:
        tiny_off[0, 1] = tiny_off[1, 0] = np.float32(1e-39)
    M = rng.standard_normal((d, d)).astype(np.float32)
    return {"spd": _spd(rng, (d, d)), "identity": np.eye(d, dtype=np.float32),
            "repeated": np.diag(np.resize(np.float32([2, -1, 2]), d)),
            "tiny_offdiagonal": tiny_off, "indefinite": M + M.T}


@pytest.mark.parametrize("d", [2, 3, 5, 8, 9, 16])
def test_j1_replay_equals_the_plain_version_bitwise(d):
    rng = np.random.default_rng(100 + d)
    for name, C in _special_inputs(d, rng).items():
        C = np.ascontiguousarray(C, np.float32)
        w, V = linalg.eigh_jacobi_plain(torch.from_numpy(C))
        sweeps = linalg.default_sweeps(d)
        wr, Vr = _j1_replay(C, sweeps)
        assert np.array_equal(_bits(w), _bits(wr)), name
        assert np.array_equal(_bits(V), _bits(Vr)), name
        # the references agree too, to the tolerance
        if name in ("spd", "indefinite"):
            _check_against_reference(C, w.numpy(), V.numpy())


def test_sweeps_and_plan():
    for d in (1, 2, 8, 9, 16, 17, 100, 200):
        jax_default = 5 + max(0, int(np.ceil(np.log2(d / 8))) if d > 8
                              else 0)
        assert linalg.default_sweeps(d) == jax_default
    assert linalg.default_sweeps(100) == 9
    assert linalg.J1_SHARED_MAX_D == 170
    # an odd row stride where it fits, d at 170, device memory above
    assert linalg._j1_plan(100)[0] == 101 and linalg._j1_plan(99)[0] == 99
    assert linalg._j1_plan(170)[0] == 170
    assert linalg._j1_plan(171)[0] == 0 and linalg._j1_plan(192)[0] == 0
    for d in range(2, 200):
        ld, smem, threads = linalg._j1_plan(d)
        assert smem <= linalg.J1_MAX_SHARED
        assert 32 <= threads <= 1024 and threads % 32 == 0


def test_sweeps_argument_and_inputs():
    C = _spd(np.random.default_rng(3), (7, 7))
    w2, _ = linalg.eigh_jacobi(torch.from_numpy(C), sweeps=2)
    wj, _ = jax.jit(jlinalg.eigh_jacobi, static_argnums=1)(jnp.asarray(C), 2)
    top = np.abs(np.asarray(wj)).max()
    assert np.abs(w2.numpy() - np.asarray(wj)).max() \
        <= linalg.JACOBI_W_RTOL * top
    # sweeps=0 only symmetrises: the sorted diagonal and permuted identity
    w0, V0 = linalg.eigh_jacobi(torch.from_numpy(C), sweeps=0)
    assert np.array_equal(w0.numpy(), np.sort(np.diag(C)))
    assert np.array_equal(np.abs(V0.numpy()).sum(0), np.ones(7))
    with pytest.raises(ValueError, match="square"):
        linalg.eigh_jacobi(torch.zeros(3, 4))
    with pytest.raises(ValueError, match="square"):
        linalg.eigh_jacobi(torch.zeros(4))
    w1, V1 = linalg.eigh_jacobi(torch.full((2, 1, 1), 3.0))
    assert w1.shape == (2, 1) and V1.shape == (2, 1, 1)
    assert bool((w1 == 3.0).all()) and bool((V1 == 1.0).all())
    with pytest.raises(ValueError, match="no kernel"):
        linalg.eigh_jacobi(torch.zeros(3, 3, device="meta"))
