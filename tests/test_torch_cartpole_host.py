"""J5's CUDA source compiled for the host, against its plain version.

``csrc/cartpole_rollout.cu`` is built by ``g++`` with its CUDA constructs
defined away (a header below): each block's threads run as host threads
with a barrier for ``__syncthreads``, ``__fmul_rn`` and the rest round
once in float32, ``__fmaf_rn`` is ``fmaf``, and ``sinf``, ``cosf`` and
``tanhf`` are the host's. The plain version takes the same three
functions from the same library (``torch.sin``, ``torch.cos`` and
``torch.tanh`` answered by it), so the two must agree bit for bit: this
holds the kernel's logic (the parameters' layout, the unrolled instance
and the runtime-width one, the physics for both forces and the action's
select, the fast division's range check and its IEEE recompute, the
limit test, the step count) on the CPU, at every hidden width 1-64 (100
steps), on NaN and infinite genes, on NaN, infinite, huge, tiny and zero
starts, at ``max_steps`` 0-500, on a population whose every episode
reaches the cap, and in the yardstick build
(``-DDTT_J5_PHYSICS_AFTER_ACTION``). The host build's division takes the
host's exact reciprocal where the card's takes ``rcp.approx``. What only
the card can show (``nvcc``'s build, CUDA's own ``sinf``, ``cosf``,
``tanhf``, the card's division) is ``tests/test_torch_cartpole_cuda.py``'s.

Tolerance: bitwise.
"""

import ctypes
import math
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from deap_tpu_torch.benchmarks import cartpole

SOURCE = (Path(cartpole.__file__).resolve().parent.parent / "csrc"
          / "cartpole_rollout.cu")

# what CUDA gives a kernel, for a host build: blocks one after another,
# a block's threads as host threads
SHIM = r"""
#include <barrier>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define __shared__ static
using std::isnan;
struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3 blockIdx, threadIdx, blockDim;
inline std::barrier<>* block_barrier = nullptr;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline long long clock64() { return 0; }
template <class A, class B> inline auto min(A a, B b) { return a < b ? a : b; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> inline int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
alignas(16) inline float sh[1 << 16];
template <class F> struct Launch {
  int grid, block; F f;
  template <class... A> void operator()(A... a) {
    for (int b = 0; b < grid; ++b) {
      std::barrier<> bar(block);
      block_barrier = &bar;
      std::vector<std::thread> threads;
      for (int t = 0; t < block; ++t)
        threads.emplace_back([&, b, t] {
          blockIdx.x = b; threadIdx.x = t; blockDim.x = block;
          f(a...); });
      for (auto& th : threads) th.join();
    }
  }
};
template <class F> Launch<F> launch_kernel(int grid, int block, F f) {
  return {grid, block, f};
}
"""

# the host's sinf, cosf and tanhf on n floats, for the plain version
HOST_MATH = r"""
extern "C" void host_math(const float* x, int n, float* s, float* c,
                          float* t) {
  for (int i = 0; i < n; ++i) {
    s[i] = sinf(x[i]); c[i] = cosf(x[i]); t[i] = tanhf(x[i]);
  }
}
"""

YARDSTICKS = {"physics after the action": ["-DDTT_J5_PHYSICS_AFTER_ACTION"]}

#: widths held beyond the sweep of every width: the unrolled instance's and
#: the runtime-width instance's least, an odd and its largest
WIDTHS = cartpole.J5_UNROLLED_HIDDEN + (1, 7, cartpole.J5_MAX_HIDDEN)


def _split_top(args):
    """A launch's ``<<<...>>>`` arguments, split at top-level commas."""
    out, depth, cur = [], 0, ""
    for ch in args:
        depth += ch in "(<"
        depth -= ch in ")>"
        if ch == "," and depth == 0:
            out.append(cur)
            cur = ""
        else:
            cur += ch
    return out + [cur]


def host_source():
    """The J5 source for ``g++``: the shim for ``common.cuh``, the
    ``cartpole_math`` probe cut, each launch a call of
    ``launch_kernel``."""
    src = SOURCE.read_text()
    src = src.replace('#include "common.cuh"', SHIM)
    src = src.replace("extern __shared__ float sh[];", "")
    src = re.sub(r"__global__ void cartpole_math_kernel.*?\n}\n", "", src,
                 flags=re.S)
    src = src[:src.index("// sinf, cosf and the saturated tanhf")]

    def launch(m):
        grid, block = _split_top(m.group(2))[:2]
        return f"launch_kernel({grid}, {block}, &{m.group(1)})("
    src, launches = re.subn(r"([\w:]+(?:<\w+>)?)\s*<<<(.*?)>>>\(", launch,
                            src, flags=re.S)
    assert launches == 2, launches
    return src + HOST_MATH


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """The host builds by name: the default and each yardstick."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build J5's source for the host")
    d = tmp_path_factory.mktemp("j5_host")
    (d / "j5.cpp").write_text(host_source())
    procs = {}
    for name, flags in {"default": [], **YARDSTICKS}.items():
        lib = d / f"lib{len(procs)}.so"
        procs[name] = (lib, subprocess.Popen(
            [gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC",
             "-shared", "-pthread", "-w", *flags, "-o", str(lib),
             str(d / "j5.cpp")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log
        libs[name] = ctypes.CDLL(str(lib))
        P, I = ctypes.c_void_p, ctypes.c_int
        libs[name].cartpole_rollout.argtypes = [P, P, I, I, I, I, P, P, P, P]
        libs[name].cartpole_rollout.restype = I
        libs[name].host_math.argtypes = [P, I, P, P, P]
        libs[name].cartpole_div.argtypes = [P, P, ctypes.c_longlong, P, P]
        libs[name].cartpole_div.restype = I
    return libs


def host_rollout(lib, genomes, starts, max_steps, H):
    """J5's host build: returns ``[P, E]`` float32."""
    g = np.ascontiguousarray(genomes, np.float32)
    s = np.ascontiguousarray(starts, np.float32)
    consts = np.array(cartpole.J5_CONSTANTS, np.float32)
    out = np.zeros(g.shape[0] * s.shape[0], np.float32)
    err = lib.cartpole_rollout(g.ctypes.data, s.ctypes.data, g.shape[0],
                               s.shape[0], H, max_steps, consts.ctypes.data,
                               out.ctypes.data, None, None)
    assert err == 0
    return torch.from_numpy(out.reshape(g.shape[0], s.shape[0]))


class _HostMathTorch:
    """``torch``, with ``sin``, ``cos`` and ``tanh`` taken from the host
    build's library (float32 tensors)."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        return getattr(torch, name)

    def _math(self, x, k):
        a = np.ascontiguousarray(x.numpy(), np.float32).ravel()
        outs = [np.empty_like(a) for _ in range(3)]
        self._lib.host_math(a.ctypes.data, a.size,
                            *(o.ctypes.data for o in outs))
        return torch.from_numpy(outs[k].reshape(x.shape))

    def sin(self, x):
        return self._math(x, 0)

    def cos(self, x):
        return self._math(x, 1)

    def tanh(self, x):
        return self._math(x, 2)


@pytest.fixture
def plain(host_libs, monkeypatch):
    """J5's plain version with the host build's sin, cos and tanh."""
    monkeypatch.setattr(cartpole, "torch",
                        _HostMathTorch(host_libs["default"]))
    return cartpole.cartpole_rollout_plain


def _same(a, b):
    return a.shape == b.shape and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


def _genomes(seed, P, H, sigma):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((P, 7 * H + 2)) * sigma).astype(np.float32)


def _starts(seed, E):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.05, 0.05, (E, 4)).astype(np.float32)


def test_host_build_division_is_the_ieee_quotient(host_libs):
    """The host build's variant of J5's division (its fast path on the
    host's exact reciprocal where the card's takes ``rcp.approx``, behind
    the same range check, else the IEEE one) on special, huge, tiny and
    ordinary operands, bitwise with numpy's float32 division (any NaN for a
    NaN): the range check and its recompute. The card's division is held
    by ``test_torch_cartpole_cuda.py::test_j5_division_equals_torch``."""
    rng = np.random.default_rng(11)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-40,
                         1.17e-38, 2.0 ** -60, 2.0 ** -61, 2.0 ** 60,
                         2.0 ** 61, 3.4e38, -3.4e38, 1.0, -10.0, 1.1],
                        np.float32)
    a = np.concatenate([specials, (rng.standard_normal(2000)
                                   * 10.0 ** rng.uniform(-45, 38, 2000))
                        .astype(np.float32)])
    b = np.concatenate([specials, np.float32([0.65, 0.62, 0.667]),
                        rng.uniform(0.6, 0.7, 13).astype(np.float32)])
    A, B = (x.ravel() for x in np.meshgrid(a, b))
    q = np.empty_like(A)
    err = host_libs["default"].cartpole_div(A.ctypes.data, B.ctypes.data,
                                            A.size, q.ctypes.data, None)
    assert err == 0
    with np.errstate(all="ignore"):
        want = A / B
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(q), nan)
    assert np.array_equal(q[~nan].view(np.int32), want[~nan].view(np.int32))


def test_host_source_keeps_every_instance(host_libs):
    src = host_source()
    assert all(f"launch<{h}>" in src for h in cartpole.J5_UNROLLED_HIDDEN)
    assert "launch<0>" in src
    assert tuple(int(h) for h in re.findall(
        r"case (\d+):", src)) == cartpole.J5_UNROLLED_HIDDEN


@pytest.mark.parametrize("H", range(1, cartpole.J5_MAX_HIDDEN + 1))
def test_every_hidden_width_equals_plain(host_libs, plain, H):
    starts = _starts(H, 3)
    for sigma in (0.5, 3.0):
        g = _genomes(100 + H, 33, H, sigma)
        got = host_rollout(host_libs["default"], g, starts, 100, H)
        want = plain(torch.from_numpy(g), torch.from_numpy(starts), 100,
                     (4, H, 2))
        assert _same(got, want), (H, sigma)


@pytest.mark.parametrize("H", WIDTHS)
def test_nan_and_infinite_genes_equal_plain(host_libs, plain, H):
    n = 7 * H + 2
    g = _genomes(3, 16, H, 1.0)
    for row, col, v in ((0, 0, math.nan), (1, n - 14, math.inf),
                        (2, n - 2, -math.inf), (3, 4 * H, math.inf),
                        (4, 5 * H + 1, math.nan), (5, n - 1, math.nan)):
        g[row, col] = v
    g[6] = math.nan
    g[7] = math.inf
    starts = _starts(4, 3)
    for max_steps in (0, 1, 50, 500):
        got = host_rollout(host_libs["default"], g, starts, max_steps, H)
        want = plain(torch.from_numpy(g), torch.from_numpy(starts),
                     max_steps, (4, H, 2))
        assert _same(got, want), max_steps


#: starts whose physics leaves the fast division's range (J5 then divides
#: through the IEEE division): NaN, infinite, huge, tiny and zero states
ODD_STARTS = [[0.0, 0.0, 0.0, 0.0], [-0.0, -0.0, -0.0, -0.0],
              [0.01, 0.0, 0.0, 1e20], [0.0, 1e-40, 1e-30, 0.0],
              [math.nan, 0.0, 0.01, 0.0], [0.0, 0.0, math.nan, 0.0],
              [0.0, math.inf, 0.0, 0.0], [0.0, 0.0, 0.0, -math.inf],
              [3e38, 0.0, 0.0, 0.0], [0.0, 0.0, 0.2, 3e38],
              [0.01, -0.02, 0.03, 1e-38], [1e-45, 0.0, -1e-45, 1e18]]


@pytest.mark.parametrize("H", WIDTHS)
def test_odd_starts_equal_plain(host_libs, plain, H):
    starts = np.array(ODD_STARTS, np.float32)
    g = _genomes(9, 5, H, 1.0)
    for max_steps in (1, 3, 200):
        got = host_rollout(host_libs["default"], g, starts, max_steps, H)
        want = plain(torch.from_numpy(g), torch.from_numpy(starts),
                     max_steps, (4, H, 2))
        assert _same(got, want), max_steps


def test_population_at_the_cap_equals_plain(host_libs, plain):
    bal = chip_smoke.balancing_genome(torch, torch.device("cpu")).numpy()
    rng = np.random.default_rng(5)
    g = (bal + chip_smoke.J5_CAPPED_SIGMA * rng.standard_normal(
        (64, bal.size))).astype(np.float32)
    starts = _starts(6, 3)
    got = host_rollout(host_libs["default"], g, starts, 500, 16)
    want = plain(torch.from_numpy(g), torch.from_numpy(starts), 500)
    assert _same(got, want) and bool((got == 500).all())


@pytest.mark.parametrize("name", sorted(YARDSTICKS))
@pytest.mark.parametrize("H", WIDTHS)
def test_yardstick_builds_equal_the_default(host_libs, name, H):
    g = _genomes(7 + H, 97, H, 0.5)
    starts = _starts(8, 3)
    want = host_rollout(host_libs["default"], g, starts, 500, H)
    assert _same(host_rollout(host_libs[name], g, starts, 500, H), want)
