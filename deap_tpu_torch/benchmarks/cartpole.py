"""CartPole — the control benchmark for neuroevolution.

Port of :mod:`deap_tpu.benchmarks.cartpole`: the cart-pole balancing
task (Barto, Sutton and Anderson 1983) with the Gym-era constants, state
``[x, ẋ, θ, θ̇]``, a bang-bang force of ±10 N, Euler steps of 0.02 s,
failure when ``|x| > 2.4`` m or ``|θ| > 12°``, a reward of 1 for each
step entered alive, capped at ``max_steps``.

The arithmetic is float32 in the JAX module's order, each operation
rounded on its own: ``θ̇²`` and ``cos²θ`` are products, every division by
a constant is a true division (:func:`deap_tpu_torch.ops.linalg.div_rn`),
and the Euler updates ``s + dt·v`` are fused multiply-adds
(:func:`~deap_tpu_torch.ops.linalg.fma_rn`), as XLA's compiled loop
computes them on the CPU (bit for bit on equal inputs for ``x`` and
``θ``). XLA's ``sin``, ``cos`` and ``tanh`` are not torch's, and its
loop contracts other products too, so states agree with the JAX
package's within a stated bound, not bit for bit
(``tests/test_torch_cartpole.py``). ``failed`` is ``abs > limit``, so a
NaN state never fails.

The JAX package draws an episode's start from a key; here the draws are
made apart (:func:`initial_state`, from a ``torch.Generator``) and the
rollouts take the starts ``[E, 4]``, so a test can hand them the JAX
package's own. :func:`mlp_policy` keeps the JAX package's flat genome
(per layer ``W`` as ``(in, out)`` row-major, then ``b``), so a JAX genome
turned to numpy is a port genome; its tanh is :func:`tanh_sat`, which
saturates where XLA's float32 ``tanh`` does.

:func:`rollout_population` with an :func:`mlp_policy` runs J5
(:func:`cartpole_rollout`, ``csrc/cartpole_rollout.cu``) on a CUDA
tensor: one thread an episode, until it fails or reaches ``max_steps``;
at the width of :data:`J5_UNROLLED_HIDDEN` the hidden units unrolled and
the policy in registers, and the physics that does not depend on the
action computed beside the policy.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Sequence, Tuple

import torch

from deap_tpu_torch import _build
from deap_tpu_torch.ops.linalg import div_rn, fma_rn

__all__ = ["cartpole_step", "initial_state", "rollout", "rollout_population",
           "mlp_policy", "tanh_sat", "argmax_first", "cartpole_rollout",
           "cartpole_rollout_plain", "cartpole_math", "cartpole_div",
           "TANH_ONE",
           "J5_MAX_HIDDEN", "J5_UNROLLED_HIDDEN", "J5_CONSTANTS",
           "TANH_ULPS", "STEP_ULPS", "LOGIT_ULPS"]

# the JAX module's constants, as Python doubles; every operation takes
# their float32 rounding
GRAVITY = 9.8
MASS_CART = 1.0
MASS_POLE = 0.1
TOTAL_MASS = MASS_CART + MASS_POLE
HALF_LENGTH = 0.5
POLEMASS_LENGTH = MASS_POLE * HALF_LENGTH
FORCE_MAG = 10.0
DT = 0.02
X_LIMIT = 2.4
THETA_LIMIT = 12.0 * math.pi / 180.0
FOUR_THIRDS = 4.0 / 3.0

#: the smallest float32 ``x`` where XLA's float32 ``tanh`` (on the CPU)
#: returns exactly 1.0: XLA clamps its rational approximation there, while
#: a correctly rounded tanh reaches 1.0 only at 9.01084 (``torch.tanh``,
#: CUDA's ``tanhf``). Bisected against ``jnp.tanh`` in
#: ``tests/test_torch_cartpole.py``.
TANH_ONE = 7.99881172180175781250
#: the widest hidden layer J5 takes (a block stages the genomes of the
#: policies its 64 episodes touch in shared memory, ``7·H + 2`` floats
#: each: up to 115 KB at H 64 and one episode a policy)
J5_MAX_HIDDEN = 64
#: the hidden widths J5 has an instance of, unrolled at compile time with
#: the policy's ``7·H + 2`` parameters in registers (the switch of
#: ``csrc/cartpole_rollout.cu``'s launcher): the cart-pole configuration's
#: 16; every other width up to ``J5_MAX_HIDDEN`` runs its instance for a
#: width known at run time
J5_UNROLLED_HIDDEN = (16,)


#: the stated bounds of the port against the JAX package on the CPU
#: (``tests/test_torch_cartpole.py``), with a margin over the errors its
#: inputs show: :func:`tanh_sat` within ``TANH_ULPS`` ulp of ``jnp.tanh``
#: (exactly ±1 where it is); a step's ``ẋ`` and ``θ̇`` within
#: ``STEP_ULPS`` ulp of their largest term (``|ẋ|``, ``dt·|temp|``, ...:
#: XLA's ``sin``, ``cos`` and contractions), ``x``, ``θ`` and ``failed``
#: equal; a logit of :func:`mlp_policy` within ``LOGIT_ULPS · (1 +
#: Σ_j |W2_ja|)`` ulp of 1
TANH_ULPS, STEP_ULPS, LOGIT_ULPS = 8, 8, 2


def _f32(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32))


#: the float32 constants J5 takes, in ``csrc/cartpole_rollout.cu``'s
#: ``CartPole`` order
J5_CONSTANTS = tuple(_f32(v) for v in (
    FORCE_MAG, POLEMASS_LENGTH, TOTAL_MASS, GRAVITY, HALF_LENGTH,
    FOUR_THIRDS, MASS_POLE, DT, X_LIMIT, THETA_LIMIT, TANH_ONE))


def cartpole_step(state: torch.Tensor, action: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Euler step of a batch: ``state [..., 4]``, ``action [...]`` in
    {0, 1} (left, right). Returns ``(next_state [..., 4], failed [...])``."""
    x, x_dot, theta, theta_dot = state.unbind(-1)
    force = torch.where(action > 0, FORCE_MAG, -FORCE_MAG).to(state.dtype)
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    temp = div_rn(force + POLEMASS_LENGTH * (theta_dot * theta_dot) * sin_t,
                  TOTAL_MASS)
    denom = HALF_LENGTH * (FOUR_THIRDS - div_rn(MASS_POLE * (cos_t * cos_t),
                                                TOTAL_MASS))
    theta_acc = (GRAVITY * sin_t - cos_t * temp) / denom
    x_acc = temp - div_rn(POLEMASS_LENGTH * theta_acc * cos_t, TOTAL_MASS)
    dt = torch.full((), DT, dtype=state.dtype, device=state.device)
    new = torch.stack([fma_rn(dt, x_dot, x), fma_rn(dt, x_acc, x_dot),
                       fma_rn(dt, theta_dot, theta),
                       fma_rn(dt, theta_acc, theta_dot)], -1)
    failed = (new[..., 0].abs() > X_LIMIT) | (new[..., 2].abs() > THETA_LIMIT)
    return new, failed


def initial_state(generator: torch.Generator, episodes: int = 1
                  ) -> torch.Tensor:
    """``episodes`` starts ``[E, 4]``, each value uniform in [-0.05, 0.05)
    (the Gym convention), on the generator's device."""
    u = torch.rand((episodes, 4), generator=generator,
                   device=generator.device)
    return torch.clamp_min(u * 0.1 + -0.05, -0.05)


# ----------------------------------------------------------- policies ----

def tanh_sat(x: torch.Tensor) -> torch.Tensor:
    """``tanh`` as XLA's float32 ``tanh`` saturates: exactly ±1 where
    ``|x| >= TANH_ONE``, ``torch.tanh`` elsewhere (within ``TANH_ULPS``
    of XLA's there)."""
    return torch.where(x.abs() >= TANH_ONE, torch.sign(x), torch.tanh(x))


def argmax_first(logits: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax`` over the last axis: the first maximum, a NaN counted
    as larger than every number (the first NaN wins). ``int64[...]``."""
    best = torch.zeros(logits.shape[:-1], dtype=torch.int64,
                       device=logits.device)
    top = logits[..., 0]
    for a in range(1, logits.shape[-1]):
        cand = logits[..., a]
        take = (cand > top) | (torch.isnan(cand) & ~torch.isnan(top))
        best = torch.where(take, a, best)
        top = torch.where(take, cand, top)
    return best


def mlp_policy(sizes: Sequence[int] = (4, 16, 2)) -> Tuple[Callable, int]:
    """A tanh MLP policy over a flat genome. Returns ``(policy(params
    [B, n], state [B, in]) -> logits [B, out], n)``; per layer the genome
    holds ``W`` as ``(in, out)`` row-major, then ``b`` (the JAX package's
    layout, 114 parameters at ``(4, 16, 2)``). Each layer's sum is a
    chain of fused multiply-adds in a fixed order, ``h_0 W_0j`` then
    ``fma(h_k, W_kj, ·)`` for k = 1 … in-1 (:func:`~deap_tpu_torch.ops.
    linalg.fma_rn`), then ``+ b_j``: XLA's CPU dot at 4 inputs, bit for bit
    (at 16 inputs XLA blocks the sum otherwise). It is not ``@``, whose
    order no kernel could match. The activation is :func:`tanh_sat`; J5
    computes the same operations. The
    policy carries its ``sizes``, by which :func:`rollout_population`
    knows it."""
    sizes = tuple(int(s) for s in sizes)
    shapes = list(zip(sizes[:-1], sizes[1:]))
    n = sum(a * b + b for a, b in shapes)

    def policy(params: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
        h = state
        off = 0
        for in_d, out_d in shapes:
            W = params[..., off: off + in_d * out_d].reshape(
                params.shape[:-1] + (in_d, out_d))
            off += in_d * out_d
            b = params[..., off: off + out_d]
            off += out_d
            acc = h[..., 0, None] * W[..., 0, :]
            for k in range(1, in_d):
                acc = fma_rn(h[..., k, None], W[..., k, :], acc)
            h = tanh_sat(acc + b)
        return h

    policy.sizes = sizes
    return policy, n


# ----------------------------------------------------------- rollouts ----

def _rollout_torch(policy: Callable, params: torch.Tensor,
                   state: torch.Tensor, max_steps: int, chunk: int,
                   min_size: int) -> torch.Tensor:
    """Returns of a batch of episodes (``params [B, n]``, ``state [B,
    4]``), stepped ``chunk`` steps at a time until none is alive or
    ``max_steps`` is reached. After each chunk, a buffer of more than
    ``min_size`` episodes whose alive ones fell to half or fewer keeps only
    those (a stable gather, the JAX cascade's compaction); dead episodes
    are frozen in between. One read of the alive count a chunk."""
    B = state.shape[0]
    dev = state.device
    total = torch.zeros(B, dtype=torch.float32, device=dev)
    orig = torch.arange(B, device=dev)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    reward = torch.zeros(B, dtype=torch.float32, device=dev)
    t = 0
    while t < max_steps and B:
        for _ in range(min(chunk, max_steps - t)):
            action = argmax_first(policy(params, state))
            new, failed = cartpole_step(state, action)
            reward = reward + alive.to(torch.float32)
            state = torch.where(alive[:, None], new, state)
            alive = alive & ~failed
        t += min(chunk, max_steps - t)
        total[orig] = reward
        count = int(alive.sum())
        if count == 0:
            break
        if B > min_size and 2 * count <= B:
            keep = torch.nonzero(alive)[:, 0]
            state, alive, reward = state[keep], alive[keep], reward[keep]
            params, orig = params[keep], orig[keep]
            B = count
    total[orig] = reward
    return total


def rollout(policy: Callable, params: torch.Tensor, start: torch.Tensor,
            max_steps: int = 500) -> torch.Tensor:
    """Total reward of ``policy(params, state) -> logits`` over one episode
    from ``start [4]``: 1 for each step entered alive, the episode frozen
    once it fails. A 0-d float32 tensor."""
    return _rollout_torch(policy, params[None], start[None].to(
        torch.float32), max_steps, max(max_steps, 1), 0)[0]


def rollout_population(policy: Callable, genomes: torch.Tensor,
                       starts: torch.Tensor, max_steps: int = 500,
                       chunk: int = 10, min_size: int = 512) -> torch.Tensor:
    """Episode returns ``[P, E]`` of ``P`` policies × ``E`` shared episode
    starts (``genomes [P, n]``, ``starts [E, 4]``), equal to
    :func:`rollout` of each pair.

    With an :func:`mlp_policy` this is J5 (:func:`cartpole_rollout`): on a
    CUDA tensor one launch, a thread an episode (its width's instance);
    on the CPU its plain version. With any other callable it is the torch
    path on the genomes' device (steps of ``chunk`` on the alive episodes,
    compacted into smaller buffers down to ``min_size``), a different
    function, not a fallback. ``max_steps % chunk`` must be 0 (a
    ``ValueError``, as in the JAX package, whose loop advances whole
    chunks)."""
    if max_steps % chunk:
        raise ValueError(f"max_steps ({max_steps}) must be a multiple "
                         f"of chunk ({chunk})")
    sizes = getattr(policy, "sizes", None)
    if sizes is not None:
        return cartpole_rollout(genomes, starts, max_steps, sizes)
    return _torch_path(policy, genomes, starts, max_steps, chunk, min_size)


# ----------------------------------------------------------------- J5 ----

def _torch_path(policy: Callable, genomes: torch.Tensor,
                starts: torch.Tensor, max_steps: int, chunk: int,
                min_size: int) -> torch.Tensor:
    """:func:`_rollout_torch` of every (genome, start) pair, ``[P, E]``."""
    P, E = genomes.shape[0], starts.shape[0]
    state = starts.to(torch.float32).repeat(P, 1)
    params = genomes.repeat_interleave(E, 0)
    return _rollout_torch(policy, params, state, max_steps, chunk,
                          min_size).reshape(P, E)


def cartpole_rollout_plain(genomes: torch.Tensor, starts: torch.Tensor,
                           max_steps: int, sizes: Sequence[int] = (4, 16, 2)
                           ) -> torch.Tensor:
    """J5's plain version: the torch path of :func:`rollout_population`
    with :func:`mlp_policy` ``(sizes)``, ``[P, E]`` float32 returns."""
    policy, n = mlp_policy(sizes)
    if genomes.shape[-1] != n:
        raise ValueError(f"mlp_policy{tuple(sizes)} takes {n} parameters, "
                         f"the genomes hold {genomes.shape[-1]}")
    return _torch_path(policy, genomes, starts, max_steps, 10, 512)


def _j5_hidden(sizes: Sequence[int], genomes: torch.Tensor,
               starts: torch.Tensor) -> int:
    """J5's checks of a call on the card; the hidden width."""
    sizes = tuple(int(s) for s in sizes)
    if len(sizes) != 3 or sizes[0] != 4 or sizes[2] != 2 or not (
            1 <= sizes[1] <= J5_MAX_HIDDEN):
        raise ValueError(f"J5 takes mlp_policy((4, H, 2)) with 1 <= H <= "
                         f"{J5_MAX_HIDDEN}, got sizes {sizes}")
    H = sizes[1]
    if genomes.dtype != torch.float32 or starts.dtype != torch.float32:
        raise ValueError("J5 takes float32 genomes and starts")
    if genomes.ndim != 2 or genomes.shape[1] != 7 * H + 2:
        raise ValueError(f"genomes must be [P, {7 * H + 2}], got "
                         f"{tuple(genomes.shape)}")
    if starts.ndim != 2 or starts.shape[1] != 4:
        raise ValueError(f"starts must be [E, 4], got {tuple(starts.shape)}")
    if starts.device != genomes.device:
        raise ValueError("genomes and starts must be on one card")
    if genomes.shape[0] * starts.shape[0] >= 2 ** 31:
        raise ValueError("J5 indexes episodes with int32")
    return H


def cartpole_rollout(genomes: torch.Tensor, starts: torch.Tensor,
                     max_steps: int = 500,
                     sizes: Sequence[int] = (4, 16, 2),
                     clocks: torch.Tensor = None) -> torch.Tensor:
    """Returns ``[P, E]`` float32 of :func:`mlp_policy` ``(sizes)`` genomes
    ``[P, n]`` from the starts ``[E, 4]`` (J5).

    On a CUDA tensor one launch runs every episode, a thread an episode
    (``csrc/cartpole_rollout.cu``): the launcher picks the instance by H,
    one unrolled at compile time with the policy in registers for the
    width of ``J5_UNROLLED_HIDDEN``, else the one for a width known at
    run time; in both the physics that does not depend on the action
    issues beside the policy, for both forces, and the action selects.
    On a CPU tensor :func:`cartpole_rollout_plain` runs. Both round each
    operation alone in the same order, with the same
    ``sin``/``cos``/``tanh``, so on the card they agree bit for bit. The
    card takes ``sizes = (4, H, 2)``, H up to ``J5_MAX_HIDDEN``, and
    raises on any other. The wrapper's ``launches`` counts the launches.
    ``clocks`` (card only, ``int64[P · E]``) takes each thread's clocks
    from its first step to its last."""
    if genomes.device.type == "cpu":
        if clocks is not None:
            raise ValueError("clocks are counted only on the card")
        return cartpole_rollout_plain(genomes, starts, max_steps, sizes)
    if genomes.device.type != "cuda":
        raise ValueError(f"no kernel for device {genomes.device}")
    H = _j5_hidden(sizes, genomes, starts)
    if not 0 <= max_steps < 2 ** 31:
        raise ValueError("max_steps must fit an int32")
    P, E = genomes.shape[0], starts.shape[0]
    out = torch.empty((P, E), dtype=torch.float32, device=genomes.device)
    if P == 0 or E == 0:
        return out
    if clocks is not None and (clocks.dtype != torch.int64 or clocks.shape
                               != (P * E,) or clocks.device != out.device):
        raise ValueError("clocks must be int64[P * E] on the card")
    genomes, starts = genomes.contiguous(), starts.contiguous()
    consts = (_build.FLOAT * len(J5_CONSTANTS))(*J5_CONSTANTS)
    PT, I = _build.PTR, _build.INT
    fn = _build.function("cartpole_rollout", "cartpole_rollout",
                         [PT, PT, I, I, I, I, PT, PT, PT, PT])
    stream = torch.cuda.current_stream(genomes.device).cuda_stream
    err = fn(genomes.data_ptr(), starts.data_ptr(), P, E, H, max_steps,
             ctypes.cast(consts, ctypes.c_void_p), out.data_ptr(),
             None if clocks is None else clocks.data_ptr(), stream)
    cartpole_rollout.launches += 1
    _build.check("cartpole_rollout", err, "cartpole_rollout")
    return out


cartpole_rollout.launches = 0


def cartpole_math(x: torch.Tensor):
    """J5's ``sinf``, ``cosf`` and saturated ``tanhf`` on a float32 CUDA
    vector, ``(sin, cos, tanh_sat)``, from the same library: what the
    kernel computes, to hold against ``torch.sin``, ``torch.cos`` and
    :func:`tanh_sat` on the card. Not counted in ``launches``."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.ndim != 1:
        raise ValueError("cartpole_math takes a float32 vector on the card")
    x = x.contiguous()
    outs = [torch.empty_like(x) for _ in range(3)]
    if x.numel() == 0:
        return tuple(outs)
    PT, I = _build.PTR, _build.INT
    fn = _build.function("cartpole_rollout", "cartpole_math",
                         [PT, I, _build.FLOAT, PT, PT, PT, PT])
    err = fn(x.data_ptr(), x.numel(), TANH_ONE, *(o.data_ptr() for o in outs),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check("cartpole_rollout", err, "cartpole_math")
    return tuple(outs)


def cartpole_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """J5's division of float32 CUDA vectors, ``a / b`` as each step of J5
    divides (``__fdiv_rn``'s fast path where both operands lie in [2^-60,
    2^60], else ``__fdiv_rn``): to hold against torch's division on the
    card. Not counted in ``launches``."""
    if not (a.device.type == b.device.type == "cuda" and a.dtype == b.dtype
            == torch.float32 and a.ndim == 1 and a.shape == b.shape):
        raise ValueError("cartpole_div takes two float32 vectors of one "
                         "shape on the card")
    a, b = a.contiguous(), b.contiguous()
    q = torch.empty_like(a)
    if a.numel() == 0:
        return q
    PT = _build.PTR
    fn = _build.function("cartpole_rollout", "cartpole_div",
                         [PT, PT, ctypes.c_longlong, PT, PT])
    err = fn(a.data_ptr(), b.data_ptr(), a.numel(), q.data_ptr(),
             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check("cartpole_rollout", err, "cartpole_div")
    return q
