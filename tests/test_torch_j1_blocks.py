"""J1's order of work (``csrc/jacobi_eigh.cu``) replayed in numpy on the
CPU, where the kernel cannot run.

The kernel's pivot threads walk each pair's two players of the circle
method in registers, and those players' partners one round earlier,
instead of reading a schedule, and compute round r + 1's rotations beside
round r's pass: each of the three entries of A
after round r that a pair needs is one output of a 2x2 block of round r,
which they compute from that block's four entries before the pass and
round r's rotations (``t = sign(tau) / x`` as ``sign(tau) · (1 / x)``).
The pass threads make one in-place pass over A a round by 2x2 pair blocks
(rows of pair k, then columns of pair l, in the threads' item order of
``ops.linalg._j1_split``), and the V threads rotate V's rows from a log
of the rounds' rotations. Past ``linalg.J1_MAX_PIVOT_THREADS`` pairs the
pivot threads take their pairs in turn, each rotation from A after the
pass and its players from the round's number (``in_turn``). The replay does the same float32 operations, each
rounded on its own (numpy's float32 arithmetic; square roots through
float64, as the plain version takes them), and must equal
``eigh_jacobi_plain`` bit for bit, signed zeros included. The split and
the layout must give each block, each pair and each (pair, row pair)
unit of V exactly one thread, within the card's threads and shared memory.
"""

import numpy as np
import pytest
import torch

from chip_smoke import J1_BUCKETS, J1_DIMS
from deap_tpu_torch.ops import linalg

f32 = np.float32


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _spd(rng, d):
    M = rng.standard_normal((d, d)).astype(np.float32)
    return (M @ M.T + d * np.eye(d)).astype(np.float32)


def _special_inputs(d, rng):
    """A random SPD matrix, the identity (every pair `small`), a diagonal
    with repeated entries, an off-diagonal below ``tiny`` (subnormal) and
    an indefinite matrix (as ``tests/test_torch_linalg.py`` makes them)."""
    tiny_off = np.diag(rng.standard_normal(d).astype(np.float32))
    if d > 1:
        tiny_off[0, 1] = tiny_off[1, 0] = np.float32(1e-39)
    M = rng.standard_normal((d, d)).astype(np.float32)
    return {"spd": _spd(rng, d), "identity": np.eye(d, dtype=np.float32),
            "repeated": np.diag(np.resize(np.float32([2, -1, 2]), d)),
            "tiny_offdiagonal": tiny_off, "indefinite": M + M.T}


def _sqrt_rn(x):
    return np.sqrt(x.astype(np.float64)).astype(np.float32)


def _next_player(x, m):
    """The kernel's ``next_player``: the player at a fixed position one
    round later."""
    return np.where(x == 0, 0, np.where(x == 1, m - 1, x - 1))


def _walked_pairs(a, b, d):
    """A round's pairs from the players at positions k and m - 1 - k (an
    odd d's dummy player d makes its partner's bye)."""
    p, q = np.minimum(a, b), np.maximum(a, b)
    return p, np.where(q >= d, p, q)


def _items(d):
    """The kernel's 2x2 blocks ``(k, l)``, pass thread by pass thread, each
    thread's column pairs and row pairs in its order."""
    npairs = linalg._npairs(d)
    n_a, _, groups = linalg._j1_split(d)
    n_pass = n_a - linalg._j1_pivots(d)
    l_step = min(n_pass, npairs)
    out = [(k, ll) for t in range(n_pass) if t // npairs < groups
           for ll in range(t % npairs, npairs, l_step)
           for k in range(t // npairs, npairs, groups)]
    return tuple(np.asarray(v) for v in zip(*out))


def _prev_position(j, m):
    """The kernel's ``prev_position``: a player's position one round
    earlier."""
    return np.where(j == 0, 0, np.where(j == 1, m - 1, j - 1))


def _rot(c, x, s, y):
    return c * x + s * y


def _pivot(app, aqq, apq, bye):
    """The kernel's ``pivot``: a pair's (c, s)."""
    tiny = np.finfo(np.float32).tiny
    small = (np.abs(apq) <= tiny) | bye
    tau = (aqq - app) / np.where(small, f32(1), f32(2) * apq)
    x = np.abs(tau) + _sqrt_rn(f32(1) + tau * tau)
    t = np.sign(tau) * (f32(1) / x)
    t = np.where(tau == 0, f32(1), t)
    c = f32(1) / _sqrt_rn(f32(1) + t * t)
    return np.where(small, f32(1), c), np.where(small, f32(0), t * c)


def _next_rotations(A, a1, b1, ya, yb, rotation, d):
    """The pivot threads' step: round r + 1's rotations from A BEFORE round
    r's pass and round r's ``rotation`` = (p, q, c, s). ``a1``, ``b1`` are
    the players of each pair in round r + 1, ``ya``, ``yb`` their partners
    in round r as the kernel walks them (the dummy player d after a bye).
    Each of the three entries after round r that a pair needs is one
    output of a 2x2 block of round r, computed from that block's four
    entries."""
    m = d + d % 2
    npairs = m // 2
    k = np.arange(npairs)
    pa, pb = _prev_position(k, m), _prev_position(m - 1 - k, m)
    ja, jb = np.minimum(pa, m - 1 - pa), np.minimum(pb, m - 1 - pb)
    p, q, c, s = rotation
    # the walked partners are the schedule's
    for x, y, j in ((a1, ya, ja), (b1, yb, jb)):
        real = x < d
        assert np.array_equal(np.where(x[real] == p[j][real], q[j][real],
                                       p[j][real]),
                              np.where(y[real] < d, y[real], x[real]))
    x1, y1, j1 = a1, np.where(ya < d, ya, a1), ja
    x2, y2, j2 = b1, np.where(yb < d, yb, b1), jb
    dummy = x1 >= d
    x1, y1, j1 = (np.where(dummy, x2, x1), np.where(dummy, y2, y1),
                  np.where(dummy, j2, j1))
    dummy = x2 >= d
    x2, y2, j2 = (np.where(dummy, x1, x2), np.where(dummy, y1, y2),
                  np.where(dummy, j1, j2))
    swap = x1 > x2
    x1, x2 = np.where(swap, x2, x1), np.where(swap, x1, x2)
    y1, y2 = np.where(swap, y2, y1), np.where(swap, y1, y2)
    j1, j2 = np.where(swap, j2, j1), np.where(swap, j1, j2)
    # the partner term's coefficient: -s at a pair's lower player
    c1, s1 = c[j1], np.where(x1 < y1, -s[j1], s[j1])
    c2, s2 = c[j2], np.where(x2 < y2, -s[j2], s[j2])
    app = _rot(c1, _rot(c1, A[x1, x1], s1, A[y1, x1]), s1,
               _rot(c1, A[x1, y1], s1, A[y1, y1]))
    aqq = _rot(c2, _rot(c2, A[x2, x2], s2, A[y2, x2]), s2,
               _rot(c2, A[x2, y2], s2, A[y2, y2]))
    apq = _rot(c2, _rot(c1, A[x1, x2], s1, A[y1, x2]), s2,
               _rot(c1, A[x1, y2], s1, A[y1, y2]))
    apq = np.where((j1 == j2) & (x1 != y1), apq * f32(0), apq)
    cn, sn = _pivot(app, aqq, apq, x1 == x2)
    return x1, x2, cn, sn


def _player_at(j, r, m):
    """The kernel's ``player_at``: the player at position ``j`` in round
    ``r``, from ``r mod (m - 1)``, as the pivot threads that take their
    pairs in turn find it."""
    x = j - 1 - r % (m - 1)
    return np.where(j == 0, 0, np.where(x < 0, x + m - 1, x) + 1)


def _j1_blocks_replay(C, sweeps, in_turn=False):
    """J1's order of work on ``C``; ``in_turn``: the pivot threads take
    their pairs in turn (more pairs than pivot threads), each rotation from
    A after the pass, the players from their positions and the round."""
    d = C.shape[0]
    m = d + d % 2
    npairs = m // 2
    total = sweeps * (m - 1)
    K, L = _items(d)
    diagonal = K == L
    A = f32(0.5) * (C + C.T)
    a, b = np.arange(npairs), m - 1 - np.arange(npairs)
    k = np.arange(npairs)
    ya = m - 1 - _prev_position(k, m)
    yb = m - 1 - _prev_position(m - 1 - k, m)
    # round 0's rotations from A itself
    p, q = _walked_pairs(a, b, d)
    c, s = _pivot(A[p, p], A[q, q], A[p, q], p == q)
    log = []
    for r in range(total):
        s_lo = np.where(p == q, s, -s)
        log.append((p, q, c, s_lo, s))
        if r + 1 < total and not in_turn:  # the pivot threads, beside the pass
            a, b = _next_player(a, m), _next_player(b, m)
            next_rotation = _next_rotations(A, a, b, ya, yb, (p, q, c, s), d)
            ya, yb = _next_player(ya, m), _next_player(yb, m)
        # one pass over the 2x2 blocks, in place
        pk, qk, pl, ql = p[K], q[K], p[L], q[L]
        a00, a01, a10, a11 = A[pk, pl], A[pk, ql], A[qk, pl], A[qk, ql]
        ck, slk, shk = c[K], s_lo[K], s[K]
        cl, sll, shl = c[L], s_lo[L], s[L]
        b00, b01 = _rot(ck, a00, slk, a10), _rot(ck, a01, slk, a11)
        b10, b11 = _rot(ck, a10, shk, a00), _rot(ck, a11, shk, a01)
        o00, o01 = _rot(cl, b00, sll, b01), _rot(cl, b01, shl, b00)
        o10, o11 = _rot(cl, b10, sll, b11), _rot(cl, b11, shl, b10)
        pivots = diagonal & (pk != qk)
        o01 = np.where(pivots, o01 * f32(0), o01)
        o10 = np.where(pivots, o10 * f32(0), o10)
        # a bye's entries are stored twice with the same value
        for rows, cols, val in ((pk, pl, o00), (pk, ql, o01), (qk, pl, o10),
                                (qk, ql, o11)):
            A[rows, cols] = val
        if r + 1 < total and in_turn:  # from A, after the pass
            p, q = _walked_pairs(_player_at(k, r + 1, m),
                                 _player_at(m - 1 - k, r + 1, m), d)
            c, s = _pivot(A[p, p], A[q, q], A[p, q], p == q)
        elif r + 1 < total:
            p, q, c, s = next_rotation
    # V's rows from the log of rotations
    V = np.eye(d, dtype=np.float32)
    for p, q, c, s_lo, s_hi in log:
        vp, vq = V[:, p], V[:, q]
        V[:, p], V[:, q] = c * vp + s_lo * vq, c * vq + s_hi * vp
    w = np.diag(A)
    order = np.argsort(w, kind="stable")
    return w[order], V[:, order]


@pytest.mark.parametrize("d", [2, 3, 5, 8, 9, 16, 17, 31, 33, 100])
def test_j1_blocks_replay_equals_the_plain_version_bitwise(d):
    rng = np.random.default_rng(200 + d)
    sweeps = linalg.default_sweeps(d)
    for name, C in _special_inputs(d, rng).items():
        C = np.ascontiguousarray(C, np.float32)
        w, V = linalg.eigh_jacobi_plain(torch.from_numpy(C))
        with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
            wr, Vr = _j1_blocks_replay(C, sweeps)
        assert np.array_equal(_bits(w), _bits(wr)), name
        assert np.array_equal(_bits(V), _bits(Vr)), name


@pytest.mark.parametrize("d", [2, 3, 5, 9, 17, 100])
def test_j1_pairs_in_turn_replay_equals_the_plain_version_bitwise(d):
    rng = np.random.default_rng(300 + d)
    sweeps = linalg.default_sweeps(d)
    for name, C in _special_inputs(d, rng).items():
        C = np.ascontiguousarray(C, np.float32)
        w, V = linalg.eigh_jacobi_plain(torch.from_numpy(C))
        with np.errstate(over="ignore", divide="ignore", invalid="ignore"):
            wr, Vr = _j1_blocks_replay(C, sweeps, in_turn=True)
        assert np.array_equal(_bits(w), _bits(wr)), name
        assert np.array_equal(_bits(V), _bits(Vr)), name


@pytest.mark.parametrize("d", [2, 3, 4, 7, 100, 1921, 1922])
def test_players_by_round_give_the_schedule(d):
    ps, qs = linalg._round_robin_schedule(d)
    m = d + d % 2
    k = np.arange(m // 2)
    for r in range(2 * (m - 1)):  # two sweeps: r mod (m - 1) wraps
        p, q = _walked_pairs(_player_at(k, r, m), _player_at(m - 1 - k, r, m),
                             d)
        np.testing.assert_array_equal(p, ps[r % (m - 1)])
        np.testing.assert_array_equal(q, qs[r % (m - 1)])


@pytest.mark.parametrize("d", range(2, 201))
def test_walked_players_give_the_schedule(d):
    ps, qs = linalg._round_robin_schedule(d)
    m = d + d % 2
    k = np.arange(m // 2)
    a, b = k, m - 1 - k
    # the players at the positions partnering, one round earlier, those
    # that pair k's players come from
    pa, pb = _prev_position(k, m), _prev_position(m - 1 - k, m)
    ja, jb = np.minimum(pa, m - 1 - pa), np.minimum(pb, m - 1 - pb)
    ya, yb = m - 1 - pa, m - 1 - pb
    for r in range(2 * (m - 1)):  # two sweeps: the walk comes round again
        p, q = _walked_pairs(a, b, d)
        np.testing.assert_array_equal(p, ps[r % (m - 1)])
        np.testing.assert_array_equal(q, qs[r % (m - 1)])
        a, b = _next_player(a, m), _next_player(b, m)
        for x, y, j in ((a, ya, ja), (b, yb, jb)):
            real = x < d
            pj, qj = p[j][real], q[j][real]
            np.testing.assert_array_equal(
                np.where(x[real] == pj, qj, pj),
                np.where(y[real] < d, y[real], x[real]))
        ya, yb = _next_player(ya, m), _next_player(yb, m)


SPLIT_DIMS = sorted(set(J1_DIMS) | {d for _, d in J1_BUCKETS}
                    | set(range(2, 200)) | {257, 1000, 1920, 1921, 1922,
                                            2001})


def _v_units(d, n_v):
    """The V threads' (pair, row pair) units, thread by thread, as the
    kernel walks them: ``divmod(v, half)``, then steps of ``divmod(n_v,
    half)``, ``half`` = (d rounded up to even) / 2."""
    npairs = linalg._npairs(d)
    half = (d + d % 2) // 2
    dk, dh = divmod(n_v, half)
    out = []
    for v in range(n_v):
        k, h = divmod(v, half)
        while k < npairs:
            out.append(k * half + h)
            h += dh
            k += dk
            if h >= half:
                h -= half
                k += 1
    return np.asarray(out)


@pytest.mark.parametrize("d", SPLIT_DIMS)
def test_split_covers_each_block_pair_and_unit_once(d):
    npairs = linalg._npairs(d)
    n_a, n_v, groups = linalg._j1_split(d)
    ld, smem, slots = linalg._j1_layout(d)
    n_pivot = linalg._j1_pivots(d)
    assert n_a % 32 == 0 and n_v % 32 == 0 and n_v >= 32
    assert n_a + n_v <= linalg.J1_MAX_THREADS
    assert linalg._j1_plan(d) == (ld, smem, n_a + n_v)
    # a pivot thread for each pair, or past J1_MAX_PIVOT_THREADS pairs
    # fewer threads that take them in turn, then at least one pass warp
    assert n_pivot % 32 == 0 and n_a >= n_pivot + 32
    pivots = np.sort([k for t in range(n_pivot)
                      for k in range(t, npairs, n_pivot)])
    assert np.array_equal(pivots, np.arange(npairs))
    assert (n_pivot >= npairs) == (npairs <= linalg.J1_MAX_PIVOT_THREADS)
    assert groups == 1 or groups * npairs <= n_a - n_pivot
    # each 2x2 block once, by a pass thread
    K, L = _items(d)
    blocks = K * npairs + L
    assert np.array_equal(np.sort(blocks), np.arange(npairs * npairs))
    # each (pair, row pair) unit of V once, by a V thread
    units = _v_units(d, n_v)
    assert np.array_equal(np.sort(units),
                          np.arange(npairs * ((d + d % 2) // 2)))
    # the shared bytes fit, with one or two ring slots
    assert 1 <= slots <= linalg.J1_MAX_SLOTS
    assert smem == linalg._shared_bytes(d, ld, slots)
    assert smem <= linalg.J1_MAX_SHARED
    assert (ld == 0) == (d > linalg.J1_SHARED_MAX_D)
    if ld:
        assert ld >= d and (ld % 2 == 1 or ld == d)


@pytest.mark.parametrize("d", [39, 40, 48, 64, 65, 100, 127, 128, 169, 170])
def test_two_sm_split_covers_each_unit_once_on_more_than_half_an_sm(d):
    ld, smem, n_a, n_v = linalg._j1_split_plan(d)
    # every matrix's two blocks on the card's SMs at once, or none split
    assert linalg._j1_splits(d, 1, 132) and linalg._j1_splits(d, 66, 132)
    assert not linalg._j1_splits(d, 67, 132)
    assert linalg.j1_sms(d, 3, 132) == 6 and linalg.j1_sms(d, 67, 132) == 67
    assert linalg._j1_pivots(d) >= linalg._npairs(d)
    assert ld == linalg._j1_layout(d)[0] and n_a == linalg._j1_split(d)[0]
    assert linalg.J1_MAX_SHARED // 2 < smem <= linalg.J1_MAX_SHARED
    assert n_v % 32 == 0 and max(n_a, n_v) <= linalg.J1_MAX_THREADS
    units = _v_units(d, n_v)
    assert np.array_equal(np.sort(units),
                          np.arange(linalg._npairs(d) * ((d + d % 2) // 2)))


def test_split_refuses_what_one_block_cannot_hold():
    # up to d 32,767 (a pair stored as p | q << 16): the pivot threads take
    # the pairs in turn and the ring has one slot in shared memory
    linalg._j1_split(linalg.J1_MAX_D)
    ld, smem, slots = linalg._j1_layout(linalg.J1_MAX_D)
    assert (ld, slots) == (0, 1) and smem <= linalg.J1_MAX_SHARED
    with pytest.raises(ValueError, match="up to"):
        linalg._j1_split(linalg.J1_MAX_D + 1)
    # below the split's edge, or above the shared-memory limit, one SM
    for d in (linalg.J1_SPLIT_MIN_D - 1, linalg.J1_SHARED_MAX_D + 1):
        assert not linalg._j1_splits(d, 1, 132)


def _places(w):
    """The kernel's place of each eigenvalue: how many come before it in
    an ascending, stable order with NaN last."""
    d = w.shape[0]
    out = np.zeros(d, np.int64)
    for i in range(d):
        for j in range(d):
            if np.isnan(w[i]):
                out[i] += (not np.isnan(w[j])) or j < i
            else:
                out[i] += w[j] < w[i] or (w[j] == w[i] and j < i)
    return out


@pytest.mark.parametrize("seed", range(8))
def test_place_count_is_the_stable_sort(seed):
    # ties, signed zeros, infinities and (positive, as the card's
    # arithmetic makes them) NaNs
    rng = np.random.default_rng(seed)
    pool = np.float32([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, 2.5])
    w = rng.choice(pool, size=int(rng.integers(2, 40))).astype(np.float32)
    places = _places(w)
    order = torch.sort(torch.from_numpy(w), stable=True).indices.numpy()
    np.testing.assert_array_equal(order[places], np.arange(w.shape[0]))
