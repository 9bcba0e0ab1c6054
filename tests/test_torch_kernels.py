"""K1 ``fused_variation`` held bit for bit against the JAX package's.

The port's wrapper (on CPU tensors: its plain version) and its
``apply_variation`` against ``deap_tpu``'s Pallas kernel run in interpret
mode and against ``deap_tpu.ops.variation.apply_variation``. Both
packages get the same inputs: numpy-made genomes and the JAX package's
own ``var_and_masks`` draws, handed over as numpy arrays. Tolerance:
bitwise — the kernel computes selects and IEEE adds only. The matrix
mirrors tests/test_kernels.py: odd and degenerate pops, gene counts
around a word boundary, zero probabilities, flip/add/set on bool and
float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deap_tpu.ops import kernels as jk
from deap_tpu.ops import variation as jv
from deap_tpu.ops.crossover import cx_one_point, cx_two_point
from deap_tpu.ops.mutation import mut_flip_bit, mut_gaussian, mut_uniform_int
from deap_tpu_torch.ops import kernels as tk
from deap_tpu_torch.ops import variation as tv


@pytest.fixture(autouse=True)
def _pallas_compiler_params(monkeypatch):
    """The JAX package's K1 wrapper names ``pltpu.TPUCompilerParams``,
    which jax 0.9 renamed ``CompilerParams``; alias it in this test
    process only (the JAX package itself is not edited)."""
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)


def T(a):
    return torch.from_numpy(np.array(a))


def assert_bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.tobytes() == want.tobytes()


# ------------------------------------------------------ K1 fused_variation --

def _plan(kind="flip", mate=cx_two_point):
    if kind == "flip":
        mut_kind, draw = mut_flip_bit.fused_plan(0.1)
    elif kind == "add":
        mut_kind, draw = mut_gaussian.fused_plan(mu=0.0, sigma=0.5, indpb=0.3)
    else:
        mut_kind, draw = mut_uniform_int.fused_plan(low=0, up=3, indpb=0.3)
    return jv.VariationPlan(mate.fused_segment_draw, mate.__name__, mut_kind,
                            draw, "mut")


def _genomes(rng, n, L, dtype):
    bits = rng.random((n, L)) < 0.5
    return bits if dtype == "bool" else bits.astype(np.float32)


def _k1_case(g, kind, cxpb, mutpb, seed, src=None, mate=cx_two_point,
             block_i=16, arg_np=None):
    """Masks from the JAX package's var_and_masks; then JAX kernel, JAX
    apply, port wrapper and port apply on the same arrays."""
    n = g.shape[0] if src is None else src.shape[0]
    L = g.shape[1]
    plan = _plan("flip" if arg_np is not None else kind, mate)
    gj = jnp.asarray(g)
    cx_row, lo, hi, do_mut, mask, arg = jv.var_and_masks(
        jax.random.key(seed), n, L, cxpb, mutpb, plan, gj.dtype)
    if arg_np is not None:  # bool genomes with add/set: arg made by hand
        arg = jnp.asarray(arg_np)
    pos = jv.pair_partner_positions(n)
    s = jnp.arange(n, dtype=jnp.int32) if src is None else jnp.asarray(src)
    partner = pos if src is None else jnp.take(s, pos)
    want_kernel = jk.fused_variation(gj, s, partner, cx_row, lo, hi, do_mut,
                                     mask, arg, mut_kind=kind,
                                     block_i=block_i, interpret=True)
    want_apply = jv.apply_variation(gj, None if src is None else s, None,
                                    cx_row, lo, hi, do_mut, mask, arg, kind)
    masks = [T(a) for a in (cx_row, lo, hi, do_mut, mask)]
    targ = None if arg is None else T(arg)
    got_kernel = tk.fused_variation(T(g), T(s), T(partner), *masks[:4],
                                    masks[4], targ, mut_kind=kind)
    got_apply = tv.apply_variation(T(g), None if src is None else T(s), None,
                                   *masks, targ, kind)
    got_apply_idx = tv.apply_variation(T(g), T(s), T(partner), *masks, targ,
                                       kind)
    assert_bitwise(got_kernel, want_kernel)
    assert_bitwise(got_apply, want_apply)
    assert_bitwise(got_apply_idx, want_apply)


@pytest.mark.parametrize("n,L", [(1, 17), (2, 33), (37, 1), (37, 31),
                                 (64, 32), (65, 33), (91, 100)])
def test_k1_flip_bool_shapes(n, L):
    """Odd and off-lattice pops, n = 1 (no pair) and 2 (one pair), and
    gene counts around a word boundary."""
    g = _genomes(np.random.default_rng(n * 1000 + L), n, L, "bool")
    _k1_case(g, "flip", 0.7, 0.6, seed=n + L)


@pytest.mark.parametrize("dtype,kind", [("float32", "flip"),
                                        ("float32", "add"),
                                        ("float32", "set"),
                                        ("bool", "add"), ("bool", "set")])
def test_k1_kinds_and_dtypes(dtype, kind):
    rng = np.random.default_rng(7)
    n, L = 37, 100
    g = _genomes(rng, n, L, dtype)
    arg = None
    if dtype == "bool":
        arg = rng.normal(size=(n, L)).astype(np.float32)
        arg[rng.random((n, L)) < 0.3] = 0.0  # zeros become False
        arg[rng.random((n, L)) < 0.2] = -1.0  # and x + arg can reach 0
    _k1_case(g, kind, 0.5, 0.8, seed=11, arg_np=arg)


@pytest.mark.parametrize("cxpb,mutpb", [(0.0, 0.5), (0.5, 0.0), (0.0, 0.0)])
def test_k1_zero_probabilities(cxpb, mutpb):
    g = _genomes(np.random.default_rng(3), 48, 21, "bool")
    _k1_case(g, "flip", cxpb, mutpb, seed=6)
    if cxpb == mutpb == 0.0:
        n = 48
        z = torch.zeros(n, dtype=torch.int32)
        out = tk.fused_variation(T(g), torch.arange(n, dtype=torch.int32),
                                 T(jv.pair_partner_positions(n)),
                                 z.bool(), z, z, z.bool(),
                                 torch.ones((n, 21), dtype=torch.bool))
        assert torch.equal(out, T(g))


def test_k1_composed_selection():
    """``src_idx`` composes the selection gather into the kernel."""
    rng = np.random.default_rng(8)
    n = 90
    g = _genomes(rng, n, 40, "bool")
    src = rng.integers(0, n, n).astype(np.int32)
    _k1_case(g, "flip", 0.6, 0.3, seed=10, src=src, mate=cx_one_point)


def test_k1_rejects_bad_kind():
    g = torch.zeros((8, 8))
    z = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="mut_kind"):
        tk.fused_variation(g, z, z, z.bool(), z, z, z.bool(),
                           torch.zeros((8, 8), dtype=torch.bool),
                           mut_kind="nope")
    with pytest.raises(ValueError, match="mut_arg"):
        tk.fused_variation(g, z, z, z.bool(), z, z, z.bool(),
                           torch.zeros((8, 8), dtype=torch.bool),
                           mut_kind="add")
