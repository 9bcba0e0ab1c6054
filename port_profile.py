#!/usr/bin/env python3
"""Where a generation's time goes in the PyTorch/CUDA port, on one card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 port_profile.py [--out DIR] [--nsga2] [--fused] [--evolve]
                            [--rastrigin] [--gp] [--cmaes]
                            [--eigh lapack|jacobi ...] [--mu-lambda]
                            [--cartpole] [--hw] [--sass]
                            [--k7-variants] [--j2-variants]
                            [--j5-variants] [--package-root DIR]
    python3 port_profile.py --kernel-times [--only PREFIX ...]
                            [--package-root DIR]

``--package-root DIR`` (default: this checkout) picks the
``deap_tpu_torch`` that every mode builds (into DIR's own ``build/``),
profiles and times, e.g. another commit unpacked by ``git archive`` into
a git-ignored directory.

Profiles, with ``torch.profiler`` (CPU and CUDA activities), a steady
window of the two OneMax main-path loops at pop 100,000 and L 100:

- ``ea_simple`` OneMax (tournament 3, cxpb 0.5, mutpb 0.2, indpb 0.05,
  hall of fame 1, fitness statistics), 10 generations after 3 of warm-up,
  with K1's device time a generation whatever its rank;
- ``ea_simple_packed`` with the select-and-gather kernel, 100 generations
  after 10 of warm-up;

or, with the flags, ``chip_smoke.py``'s own loops (any of them in one
run):

- ``--nsga2``: one NSGA-II generation on 3-objective DTLZ2 at mu 50,000
  (``bench.py``'s ``make_run_nsga2_3obj`` step: DCD mating selection,
  Gaussian variation clipped to [0, 1], evaluation, ``sel_nsga2`` over
  the 100k union) after one of warm-up;
- ``--fused``: ``bench.py``'s fused OneMax loop (tournament, row gather,
  K2) at pop 100k, L 100, 100 generations after 10 of warm-up;
- ``--evolve``: ``evolve_packed`` (K5) at pop 100k, 200 generations in
  calls of 50 (the draws of each call included) after one call of
  warm-up;
- ``--rastrigin``: ``bench_suite.py``'s fused Rastrigin loop (rank
  tournament, row gather, K6) at pop 100k, 30 genes, 50 generations
  after 5 of warm-up;
- ``--gp``: ``bench_gp.py``'s symbolic regression loop (pop 4096, width
  64, 256 points; grouped evaluation through K9) for 10 generations after
  5 of warm-up, with the host's share split by the loop's spans
  (``gp/host_schedule``, ``gp/schedule_upload``, ``gp/grouped_dispatch``,
  ``gp/select``, ``gp/vary``);
- ``--cmaes``: ``bench_suite.py``'s cmaes_n100_lam4096 (Hansen CMA-ES on
  sphere, dim 100, lambda 4096) as the bare generate / evaluate / update
  loop, 50 generations after 5, and each part of a generation timed alone
  on the card at the loop's shapes (``chip_smoke.time_ms``): generate,
  evaluate, the sort, the rank-mu product, ``eigh``, the whole update;
  the host time of ``eigh`` and of the update while the card is busy;
  ``--eigh lapack jacobi`` runs it with each eigensolver in turn
  (``torch.linalg.eigh``, J1), with J1's device time a generation;
- ``--mu-lambda``: ``chip_smoke.py``'s (μ + λ) and (μ, λ) OneMax loops
  (``bench.py``'s operators; μ = λ = 100,000 and μ 20,000, λ 100,000; L
  100; fitness statistics, hall of fame 1; ``var_or`` through K1), 10
  generations after 3 of warm-up each, with K1's device time a
  generation;
- ``--cartpole``: ``bench_suite.py``'s cartpole_neuro_pop10k (pop 10k
  ``mlp_policy((4, 16, 2))`` genomes, 3 episodes of up to 500 steps
  through J5, blend and Gaussian variation, tournaments of 3), 10
  generations after 3 of warm-up, with J5's device time a generation.

``--hw`` profiles the chosen loops that have a ``prng`` mode (``--fused``,
``--evolve``, ``--rastrigin``) with the kernels' bits made by Philox
inside them (``prng='hw'``) beside the same loops with their bits drawn by
``torch.randint`` and streamed in (``'input'``), in turns. Alone it takes
``bench.py``'s three OneMax loops: the fused loop (K2; 100 generations
after 10), the packed loop (``ea_simple_packed`` with the
select-and-gather kernel, K4 then K3; 100 after 10) and
``evolve_packed`` (K5; 200 generations in calls of 50 after one call).

Every profile also prints the device time of the random-number kernels
(``torch.randint``, ``torch.rand``, and the key draws of ``'hw'``) and
their share of the device time.

``--sass`` prints the instructions per pair of K7's and K8's inner
loops at m 3, the instructions per word of K1's walk (bool, ``flip``)
and the instructions of one Philox4x32-10 call (the known-answer kernel
of ``csrc/philox.cuh``) by opcode (``cuobjdump -sass`` of the built
kernels; the listings go to ``DIR``);
``--k7-variants`` times K7 at the NSGA-II path's sizes in builds with 4,
8 and 16 query rows per thread and with the prune off, and the wrapper's
sort and gathers alone;
``--j2-variants`` times J2 at pop 4096, width 80, 543 moves on
``chip_smoke.py``'s trees and on the evolved population in this build
and in one with ``-DDTT_J2_STACK_ONLY``, where every ant takes the stack
walk; ``--j5-variants`` times J5 (500 steps) on ``chip_smoke.py``'s gen-0
and evolved cart-pole populations and on its all-at-the-cap one in the
builds of ``J5_VARIANTS`` (the default build, and the physics after the
action, each division through ``__fdiv_rn``), with each build's
lone-thread clocks a step and the instructions of its width-16 step (the
listings go to ``DIR``).

``--kernel-times`` does nothing else: it times K5-hw and K5 (a call of 50
generations) and K2-hw, K2, K3-hw, K3, K4-hw and K4 (one generation) at pop 100k
and L 100, K1 at ``ea_simple``'s shape (pop 100k, L 100: bool ``flip``,
float32 ``flip``, ``add`` and ``set``, and with no crossover or
mutation), K8 as the prefix reduction calls it (512 queries against 50k
ranked rows) and over the 31 launches of one ``nd='dc'`` selection at
16,384 rows (their sum, each launch timed alone), K7 at 100k and 50k
rows, K6-hw and K6 at pop 100k and 30 genes, K9 on ``bench_gp.py``'s
gen-0 and evolved schedules (after the L2 flush, and K4-hw and K9 also
without it), J1 at d 100, on the serving buckets [1024, 10] and [256, 30]
and at d 192 (device memory) beside ``torch.linalg.eigh`` on the same
inputs, and beside them K5-hw with mutation off, K2-hw and K6-hw
with crossover and mutation off, K6 with crossover, mutation or both off, ``torch.index_select`` of K4-hw's
winners (computed beforehand), torch copies of the byte, the packed
and the float32 genomes and of K9's value buffers, a read-only torch pass
over K5's draws and the fill of K8's output alone; with checksums of a
20-generation ``ea_simple``, one ``sel_nsga2(nd='dc')`` at 16,384 rows,
a 200-generation ``ea_simple_packed`` and four 50-generation
``evolve_packed`` calls and a 50-generation fused Rastrigin loop with
``prng='input'`` (K1's, K8's, K4 and K3's, K5's and K6's whole runs, with
the last three's launch counts); where
the package's source has K5-hw's phase clock, it also splits K5-hw's
generation by phase from a build with ``-DDTT_K5_PHASES``, and for this
checkout's package K9's items from a build with ``-DDTT_K9_PHASES`` and
J1's rounds by role from one with ``-DDTT_J1_PHASES``; J3 at the ZDT1
50k run's 50k and 100k rows (also with every front maximum in device
memory) and J4 on DTLZ2 unions of 16,384 and 100k rows.
For this checkout's package J3's and J4's chunks split by phase too,
from a build with ``-DDTT_ND_PHASES``. ``--only PREFIX ...`` keeps the
entries whose names start with one of the PREFIXes and skips the
checksum runs and the other phase clocks (``--only j1``: J1 alone;
``--only j3 j4``: J3 and J4 and their phase clock; ``--only j2``: J2 at
pop 4096, width 80, 543 moves on ``chip_smoke.py``'s trees and on the
population after the ant program's 10 generations, with the launches of
a call, each set's iterations and steps where the package traces its
walk, and, for this checkout's package, one dependent shared-memory
load's clocks; ``--only j5``: J5 on the cart-pole's gen-0, evolved and
all-at-the-cap populations, with one lone thread's clocks a step, each
set's warp-steps and the instructions of the width-16 step).
Two versions
compare on one card by runs in turns: that one, this one, this one, that
one.

For each profile it prints the wall time per generation (host clock
around work that ends in a synchronise), the device time per generation
summed over kernels, the device's busy share (device time over wall
time; one stream, so kernels do not overlap), and the kernels that take
the most device time. The chrome traces go to ``DIR`` (default
``build/profile``).
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N, L = 100_000, 100
# clocks the card spins while the host times a call that may wait for it
# (about 20 ms): a call that returns sooner did not synchronise
SYNC_SPIN_CYCLES = 40_000_000


def profile(name, run, warm, steps, out_dir, facts, spans=None,
            kernels=()):
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    run(warm)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(os.path.join(out_dir, f"{name}.json"))
    cuda = torch.autograd.DeviceType.CUDA
    # a record_function span also shows on the device timeline as an
    # annotation; it is not kernel time
    events = [e for e in prof.key_averages() if e.device_type == cuda
              and not (spans and e.key.startswith(spans))]
    device_us = sum(e.self_device_time_total for e in events)
    print(f"[{facts}] {name}: wall {wall / steps * 1e3:.3f} ms/gen, "
          f"device {device_us / steps / 1e3:.3f} ms/gen, busy share "
          f"{device_us / 1e6 / wall:.3f}")
    # torch's random-number kernels (randint, rand, randperm's draws)
    draws_us = sum(e.self_device_time_total for e in events
                   if "random" in e.key or "distribution" in e.key)
    print(f"    random-number kernels {draws_us / steps:.1f} us/gen, "
          f"{draws_us / max(device_us, 1e-9):.1%} of the device time")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"    {e.self_device_time_total / steps:10.1f} us/gen "
              f"{e.count / steps:6.1f} calls/gen  {e.key[:90]}")
    for e in events:
        if any(k in e.key for k in kernels):
            print(f"    kernel {e.key[:60]}: {e.self_device_time_total / steps:.1f}"
                  f" us/gen {e.count / steps:.1f} launches/gen")
    if spans:
        # host time inside the loop's record_function spans (nested spans
        # count in each enclosing one)
        for e in sorted((e for e in prof.key_averages()
                         if e.key.startswith(spans) and e.device_type != cuda),
                        key=lambda e: e.key):
            print(f"    span {e.key}: host {e.cpu_time_total / steps:10.1f} "
                  f"us/gen {e.count / steps:6.1f} calls/gen")
    # the same window without the profiler, for its overhead
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    plain = time.perf_counter() - t0
    print(f"[{facts}] {name}: wall without profiler "
          f"{plain / steps * 1e3:.3f} ms/gen")


def profile_nsga2(dev, out_dir, facts):
    import torch
    from chip_smoke import MO_DIM, MO_NOBJ, MO_POP, nsga2_generation
    from deap_tpu_torch import benchmarks as bm
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.ops import kernels

    gen = make_generator(5, dev)
    x = torch.rand((MO_POP, MO_DIM), generator=gen, device=dev)
    state = {"x": x, "w": -bm.dtlz2(x, MO_NOBJ)}

    def run(steps):
        for _ in range(steps):
            state["x"], state["w"] = nsga2_generation(gen, state["x"],
                                                      state["w"])

    before = kernels.dominated_weight_sums.launches
    profile("nsga2_dtlz2_mu50k", run, 1, 1, out_dir, facts)
    # profile() runs warm-up, profiled and unprofiled windows: 3 generations
    print(f"    K7 launches per generation "
          f"{(kernels.dominated_weight_sums.launches - before) / 3:.1f}")


def profile_fused(dev, out_dir, facts, prng="input"):
    import torch
    from chip_smoke import L, N, fused_onemax_generation
    from deap_tpu_torch import ops
    from deap_tpu_torch.device import make_generator

    gen = make_generator(17, dev)
    genomes = ops.bernoulli_genome(L)(gen, N)
    state = {"g": genomes, "f": genomes.sum(1).to(torch.float32)}

    def run(steps):
        for _ in range(steps):
            state["g"], state["f"] = fused_onemax_generation(
                gen, state["g"], state["f"], prng=prng)

    suffix = "" if prng == "input" else f"_{prng}"
    profile(f"fused_onemax{suffix}", run, 10, 100, out_dir, facts)


def profile_packed(dev, out_dir, facts, prng="input"):
    from chip_smoke import CXPB, INDPB, L, MUTPB, N, TOURNSIZE
    from deap_tpu_torch import algorithms, ops
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.ops import packed

    gen = make_generator(5, dev)
    pk = packed.pack_genomes(ops.bernoulli_genome(L)(gen, N))
    state = {"pk": pk, "fit": packed.packed_fitness(pk)}

    def run(steps):
        state["pk"], state["fit"] = algorithms.ea_simple_packed(
            gen, state["pk"], state["fit"], L, steps, cxpb=CXPB,
            mutpb=MUTPB, indpb=INDPB, tournsize=TOURNSIZE, prng=prng,
            device=dev)

    suffix = "" if prng == "input" else f"_{prng}"
    profile(f"ea_simple_packed{suffix}", run, 10, 100, out_dir, facts)


def profile_evolve(dev, out_dir, facts, prng="input"):
    from chip_smoke import (CXPB, EVOLVE_CALL, INDPB, L, MUTPB, N,
                            TOURNSIZE)
    from deap_tpu_torch import ops
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.ops import packed

    gen = make_generator(29, dev)
    pk = packed.pack_genomes(ops.bernoulli_genome(L)(gen, N))
    state = {"pk": pk, "fit": packed.packed_fitness(pk)}
    W = pk.shape[1]
    probs = dict(cxpb=CXPB, mutpb=MUTPB, indpb=INDPB)

    def run(steps):  # steps generations, in calls of EVOLVE_CALL
        for _ in range(steps // EVOLVE_CALL):
            if prng == "input":
                state["pk"], state["fit"] = packed.evolve_packed(
                    state["pk"], state["fit"], L,
                    *packed.evolve_bits(gen, EVOLVE_CALL, TOURNSIZE, N, W),
                    **probs)
            else:
                state["pk"], state["fit"] = packed.evolve_packed(
                    state["pk"], state["fit"], L, ngen=EVOLVE_CALL,
                    tournsize=TOURNSIZE, prng=prng, generator=gen, **probs)

    suffix = "" if prng == "input" else f"_{prng}"
    profile(f"evolve_packed{suffix}", run, EVOLVE_CALL, 4 * EVOLVE_CALL,
            out_dir, facts)


def profile_rastrigin(dev, out_dir, facts, prng="input"):
    from chip_smoke import (RA_DIM, RA_LOW, RA_N, RA_NGEN, RA_UP,
                            rastrigin_fused_generation)
    from deap_tpu_torch import ops
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.ops import kernels_real

    gen = make_generator(37, dev)
    genomes = ops.uniform_genome(RA_DIM, RA_LOW, RA_UP)(gen, RA_N)
    state = {"g": genomes, "f": kernels_real.eval_rastrigin(genomes)}

    def run(steps):
        for _ in range(steps):
            state["g"], state["f"] = rastrigin_fused_generation(
                gen, state["g"], state["f"], prng=prng)

    suffix = "" if prng == "input" else f"_{prng}"
    profile(f"rastrigin_fused{suffix}", run, 5, RA_NGEN, out_dir, facts)


def profile_mu_lambda(dev, out_dir, facts):
    from chip_smoke import (CXPB, L, MU_COMMA, MUTPB, N, _onemax_toolbox)
    from deap_tpu_torch import FitnessSpec, Toolbox, algorithms, ops
    from deap_tpu_torch.core.population import init_population
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.support.stats import fitness_stats

    tb = _onemax_toolbox(Toolbox, ops)
    for name, make_step, mu in (
            ("ea_mu_plus_lambda", algorithms.make_ea_mu_plus_lambda_step, N),
            ("ea_mu_comma_lambda", algorithms.make_ea_mu_comma_lambda_step,
             MU_COMMA)):
        gen = make_generator(47, dev)
        pop = init_population(gen, mu, ops.bernoulli_genome(L),
                              FitnessSpec((1.0,)), device=dev)
        pop, _, hof = algorithms.ea_mu_plus_lambda(
            gen, pop, tb, mu, N, CXPB, MUTPB, 0, halloffame_size=1,
            device=dev)
        step = make_step(tb, mu, N, CXPB, MUTPB, fitness_stats())
        state = {"pop": pop, "hof": hof}

        def run(steps, step=step, state=state, gen=gen):
            for _ in range(steps):
                state["pop"], state["hof"], _ = step(gen, state["pop"],
                                                     state["hof"])

        profile(name, run, 3, 10, out_dir, facts,
                kernels=("fused_variation_kernel",))


def waits_for_card(fn):
    """Host milliseconds of ``fn()`` called while the card spins about 20
    ms: near 20 means it synchronised with the card."""
    import torch
    torch.cuda.synchronize()
    torch.cuda._sleep(SYNC_SPIN_CYCLES)
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host * 1e3


def profile_cmaes(dev, out_dir, facts, eigh="lapack"):
    """The bare CMA-ES loop with ``eigh_impl=eigh`` profiled, then its
    parts timed alone."""
    import torch
    from chip_smoke import (CMA_DIM, CMA_LAMBDA, CMA_NGEN, CMA_SIGMA,
                            CMA_START, time_ms)
    from deap_tpu_torch import benchmarks
    from deap_tpu_torch.core.fitness import lex_sort_desc
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.strategies import cma

    strat = cma.Strategy(torch.full((CMA_DIM,), CMA_START), sigma=CMA_SIGMA,
                         lambda_=CMA_LAMBDA, eigh_impl=eigh, device=dev)
    gen = make_generator(89, dev)
    state = {"st": strat.initial_state()}

    def run(steps):
        for _ in range(steps):
            pop = strat.generate(gen, state["st"])
            state["st"] = strat.update(state["st"], pop,
                                       benchmarks.sphere(pop))

    name = "cmaes_n100_lam4096" + ("" if eigh == "lapack" else f"_{eigh}")
    profile(name, run, 5, CMA_NGEN, out_dir, facts,
            kernels=("jacobi_rounds_kernel",))
    st = state["st"]
    genomes = strat.generate(gen, st)
    values = benchmarks.sphere(genomes)
    w = strat.spec.wvalues(values)
    artmp = genomes[: strat.mu] - st.centroid
    flush = torch.empty(2**27, dtype=torch.int32, device=dev)  # 512 MB
    parts = {
        "generate": lambda: strat.generate(gen, st),
        "evaluate": lambda: benchmarks.sphere(genomes),
        "sort": lambda: lex_sort_desc(w),
        "rank-mu product": lambda: (strat.weights * artmp.T) @ artmp,
        "eigh": lambda: strat._eigh(st.C),
        "update": lambda: strat.update(st, genomes, values),
    }
    times = {k: time_ms(fn, flush) for k, fn in parts.items()}
    print(f"[{facts}] cmaes ({eigh!r}) parts alone, device us (median of "
          f"25, L2 flushed): " + ", ".join(f"{k} {v * 1e3:.2f}"
                                    for k, v in times.items()))
    host = {k: waits_for_card(parts[k])
            for k in ("eigh", "update", "generate")}
    spin = waits_for_card(torch.cuda.synchronize)
    print(f"[{facts}] cmaes ({eigh!r}) host ms of a call while the card "
          f"spins (a synchronise waits {spin:.3f} ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in host.items()))


def profile_gp(dev, out_dir, facts):
    from chip_smoke import GP_NGEN, GP_POP, symbreg_start
    from deap_tpu_torch.ops import kernels

    g, start, run = symbreg_start(dev, 1, GP_POP)
    state = run.init_state(start, GP_NGEN)

    def run_gens(steps):
        for _ in range(steps):
            run.advance(g, state)

    k9 = kernels.gp_grouped_dispatch
    before = (k9.launches, run.interpreter.levels_run)
    profile("gp_symbreg", run_gens, 5, 10, out_dir, facts, spans="gp/",
            kernels=("gp_",))
    # profile() runs warm-up, profiled and unprofiled windows: 25 gens
    levels = run.interpreter.levels_run - before[1]
    print(f"    K9 launches per generation "
          f"{(k9.launches - before[0]) / 25:.2f}, levels per generation "
          f"{levels / 25:.2f}; "
          f"best MSE after {state['gen']} generations "
          f"{-state['best_fitness']:.6f}")


def build_variants(src, defines, kernel):
    """Build ``csrc/<src>.cu`` once for each entry of ``defines`` (name:
    its ``-D`` flags) into ``build/deap_tpu_torch/``, one ``nvcc`` each,
    all started together; print the registers of the kernels whose names
    start with ``kernel`` and return the loaded libraries by name."""
    import ctypes
    import subprocess
    from chip_smoke import ptxas_report
    from deap_tpu_torch import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    builds = {}
    for i, (name, flags) in enumerate(defines.items()):
        lib = str(_build.BUILD_DIR / f"lib{src}-variant{i}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", lib,
               str(_build.CSRC / f"{src}.cu")]
        builds[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        lib, flags)
    libs = {}
    for name, (proc, lib, flags) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {' '.join(flags)} failed:\n{log}")
        for k, line in ptxas_report(log):
            if k.startswith(kernel):
                print(f"  ptxas {name} {k}: {line}")
        libs[name] = ctypes.CDLL(lib)
        libs[name].dtt_error_string.argtypes = [_build.INT]
        libs[name].dtt_error_string.restype = ctypes.c_char_p
    return libs


def k7_variants(dev, facts, rows=(4, 8, 16), reps=10):
    """K7 on 3-objective DTLZ2 rows at the NSGA-II path's sizes (n 50k,
    the DCD sort, and 100k, the union) in builds of csrc/dominance.cu with
    ``rows`` query rows per thread (``-DDTT_K7_ROWS``) and, at the
    default's rows, with the prune off (every block compares every row);
    each bitwise against the default build with 0/1 weights, timed in
    turns (forward, then backward) as ``chip_smoke.time_ms`` times, with
    its share of the compare bound over the pairs it compares. Also the
    wrapper's sort, limit search and gathers alone."""
    import torch
    from chip_smoke import (MO_DIM, MO_NOBJ, MO_POP, bitwise_equal,
                            compare_rate, k7_pairs, time_ms)
    from deap_tpu_torch import _build
    from deap_tpu_torch import benchmarks as bm
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.ops import kernels

    libs = build_variants("dominance", {r: [f"-DDTT_K7_ROWS={r}"]
                                         for r in rows},
                          f"dom_sums_kernel<{MO_NOBJ}>")
    default_lib = _build.library("dominance")
    default_rows = kernels._k7_rows_per_thread
    default_order = kernels._k7_order
    default_r = default_rows(MO_NOBJ)

    def all_rows(w, rows_per_block):
        order, limit = default_order(w, rows_per_block)
        return order, torch.full_like(limit, w.shape[0])

    def variant(r, prune):
        def call(w, weights):
            _build._LIBS["dominance"] = libs[r]
            kernels._k7_rows_per_thread = (
                lambda m: r if m <= 4 else default_rows(m))
            kernels._k7_order = default_order if prune else all_rows
            try:
                return kernels.dominated_weight_sums(w, weights)
            finally:
                _build._LIBS["dominance"] = default_lib
                kernels._k7_rows_per_thread = default_rows
                kernels._k7_order = default_order
        return call

    variants = {f"rows {r}": (variant(r, True), r) for r in rows}
    variants[f"rows {default_r}, no prune"] = (variant(default_r, False),
                                               None)
    flush = torch.empty(2**27, dtype=torch.int32, device=dev)  # 512 MB
    rate = compare_rate(dev)
    gen = make_generator(11, dev)
    w = -bm.dtlz2(torch.rand((2 * MO_POP, MO_DIM), generator=gen,
                             device=dev), MO_NOBJ)
    for n in (MO_POP, 2 * MO_POP):
        wn = w[:n].contiguous()
        ones = torch.ones(n, device=dev)
        want = kernels.dominated_weight_sums(wn, ones)
        for name, (fn, r) in variants.items():
            if not bitwise_equal(fn(wn, ones), want):
                raise RuntimeError(f"K7 {name} differs from the default "
                                   f"build at n={n}")
        times = {name: [] for name in variants}
        for name in list(variants) + list(variants)[::-1]:
            fn = variants[name][0]
            times[name].append(time_ms(lambda: fn(wn, ones), flush,
                                       reps=reps))
        every = 2 * MO_NOBJ * float(n) ** 2 / rate
        for name, (_, r) in variants.items():
            pairs = (k7_pairs(kernels, wn, kernels._DOM_THREADS * r)
                     if r else float(n) ** 2)
            ms = times[name]
            bound = 2 * MO_NOBJ * pairs / rate
            print(f"[{facts}] K7 n={n} {name}: "
                  + ", ".join(f"{t * 1e3:.2f}" for t in ms)
                  + f" us ({pairs:.4e} pairs compared; "
                  f"{bound / (min(ms) * 1e-3):.1%} of their bound "
                  f"{bound * 1e6:.2f} us, {every / (min(ms) * 1e-3):.1%} "
                  f"of all pairs' {every * 1e6:.2f} us)")

        def prepare():
            order, _ = kernels._k7_order(
                wn, kernels._DOM_THREADS * default_r)
            return wn[order].contiguous(), ones[order].contiguous()
        print(f"[{facts}] K7 n={n}: the wrapper's sort, limit search and "
              f"gathers alone {time_ms(prepare, flush, reps=reps) * 1e3:.2f}"
              f" us")


def j2_variants(dev, facts, reps=25):
    """J2 at pop 4096, width 80, 543 moves on ``chip_smoke.ant_trees``
    and on the population after ``chip_smoke.ant_evolved``'s 10
    generations, in the default build of csrc/ant_rollout.cu and in one
    with ``-DDTT_J2_STACK_ONLY`` (every ant takes the stack walk, in the
    same shared memory); each bitwise against the default build (eaten
    and steps), timed in turns (forward, then backward) as
    ``chip_smoke.time_ms`` times."""
    import torch
    from chip_smoke import (ANT_ML, ANT_MOVES, ant_evolved, ant_trees,
                            bitwise_equal, time_ms)
    from deap_tpu_torch import _build
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.gp import ant

    libs = build_variants("ant_rollout",
                          {"counter walk": [],
                           "stack walk": ["-DDTT_J2_STACK_ONLY"]},
                          "ant_rollout_kernel")
    default_lib = _build.library("ant_rollout")
    trail, start = ant.parse_trail()
    grid = torch.as_tensor(trail, device=dev)
    words = ant.pack_trail(grid)
    max_steps = ANT_MOVES * ANT_ML + ANT_ML
    g = make_generator(61, dev)
    sets = {"j2": ant_trees(g),
            "j2_evolved": ant_evolved(g, trail, start)[0].genomes}
    flush = torch.empty(2**27, dtype=torch.int32, device=dev)  # 512 MB

    def variant(name, args):
        def call():
            _build._LIBS["ant_rollout"] = libs[name]
            try:
                return ant.ant_rollout(*args)
            finally:
                _build._LIBS["ant_rollout"] = default_lib
        return call

    for set_name, t in sets.items():
        args = (t["nodes"].to(torch.int32).contiguous(),
                t["length"].to(torch.int32).contiguous(), grid, start,
                ANT_MOVES, max_steps, 1, words)
        want = ant.ant_rollout(*args)
        calls = {name: variant(name, args) for name in libs}
        for name, fn in calls.items():
            got = fn()
            if not all(bitwise_equal(a, b) for a, b in zip(got, want)):
                raise RuntimeError(f"J2 {name} differs from the default "
                                   f"build on {set_name}")
        times = {name: [] for name in calls}
        for name in list(calls) + list(calls)[::-1]:
            times[name].append(time_ms(calls[name], flush, reps=reps))
        for name, ms in times.items():
            print(f"[{facts}] J2 {set_name} {name}: "
                  + ", ".join(f"{t * 1e3:.2f}" for t in ms) + " us "
                  f"(max steps {int(want[1].max())})")


def sass_loops(out_dir, library, kernel):
    """The loops of ``kernel`` (a mangled-name pattern) in ``cuobjdump
    -sass`` of the built ``csrc/<library>.cu``, each as the opcodes from
    a backward branch's target to the branch; the whole listing goes to
    ``DIR/<library>.sass``."""
    import re
    import subprocess
    from deap_tpu_torch import _build
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build._target(library))],
                          check=True, capture_output=True, text=True).stdout
    with open(os.path.join(out_dir, f"{library}.sass"), "w") as f:
        f.write(sass)
    funcs = re.split(r"\n\s*Function : ", sass)
    body = next(f for f in funcs if re.match(rf"\S*{kernel}", f))
    # (address, opcode, branch target) of each instruction
    code = []
    for line in body.splitlines():
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                       r"([A-Z0-9_]+)[^;]*?(0x[0-9a-f]+)?\s*;", line)
        if ins:
            code.append((int(ins.group(1), 16), ins.group(3),
                         int(ins.group(4), 16) if ins.group(4) else None))
    return [[op for a, op, _ in code if target <= a <= at]
            for at, op, target in code
            if op == "BRA" and target is not None and target < at]


def sass_dominance(out_dir, facts, m=3):
    """The inner loops of K7's and K8's kernels for ``m`` objectives: the
    loop densest in float compares, its opcode counts and its
    instructions per (query, staged row) pair (2 m compares each)."""
    from deap_tpu_torch.ops import kernels
    for name, kernel, rows in (
            ("K7", "dom_sums_kernel", kernels._k7_rows_per_thread(m)),
            ("K8", "dom_maxes_kernel", kernels._k8_rows_per_thread(m))):
        loops = sass_loops(out_dir, "dominance", rf"{kernel}ILi{m}E")
        loop = max(loops, key=lambda b: b.count("FSETP") / len(b))
        counts = {op: loop.count(op) for op in sorted(set(loop))}
        pairs = loop.count("FSETP") / (2 * m)
        print(f"[{facts}] {name} (m={m}, {rows} query rows per thread) inner "
              f"loop: {len(loop)} instructions for {pairs:g} pairs = "
              f"{len(loop) / pairs:.3f} per pair; "
              + ", ".join(f"{k} {v}" for k, v in counts.items()))


def sass_k1(out_dir, facts):
    """K1's walk on bool genomes in words, ``flip``: its longest loop (a
    step of every lane's units in flight), its opcode counts and its
    instructions per word (one store each)."""
    loop = max(sass_loops(out_dir, "fused_variation",
                          "fused_variation_kernelIhLi4ELi0E"), key=len)
    counts = {op: loop.count(op) for op in sorted(set(loop))}
    print(f"[{facts}] K1 (bool, words, flip) walk: {len(loop)} instructions "
          f"for {loop.count('STG')} words = "
          f"{len(loop) / max(loop.count('STG'), 1):.1f} per word; "
          + ", ".join(f"{k} {v}" for k, v in counts.items()))


def sass_philox(out_dir, facts, library="evolve_packed"):
    """The instructions of one Philox4x32-10 call: the body of
    ``philox_kat_kernel`` (``csrc/philox.cuh``, one call a thread) in
    ``library``, by opcode with its modifiers, from ``cuobjdump -sass``;
    the listing goes to ``DIR/philox.sass``. Its integer multiplies
    (``IMAD.HI``, ``IMAD`` and ``IMUL`` forms) are what the kernels'
    operations bound counts, 40 a call."""
    import re
    import subprocess
    from deap_tpu_torch import _build
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build._target(library))],
                          check=True, capture_output=True, text=True).stdout
    funcs = re.split(r"\n\s*Function : ", sass)
    body = next(f for f in funcs if "philox_kat_kernel" in f.split("\n")[0])
    with open(os.path.join(out_dir, "philox.sass"), "w") as f:
        f.write(body)
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     body)
    counts = {op: ops.count(op) for op in sorted(set(ops))}
    muls = sum(v for k, v in counts.items()
               if k.startswith(("IMAD", "IMUL")) and not k.startswith(
                   ("IMAD.MOV", "IMAD.SHL", "IMAD.IADD")))
    print(f"[{facts}] Philox4x32-10 (philox_kat_kernel in lib{library}): "
          f"{len(ops)} instructions, {muls} integer multiplies (IMAD/IMUL "
          f"forms other than moves, shifts and adds); "
          + ", ".join(f"{k} {v}" for k, v in counts.items()))


def kernel_times(dev, facts, root, reps=25, only=None):
    """Time K5-hw and K5 (one 50-generation call each), K2-hw, K2, K3-hw,
    K3, K4-hw and K4 (one generation each) at the main path's shapes, pop 100k
    and L 100, K6-hw and K6 at ``bench_suite.py``'s Rastrigin shape (pop
    100k, 30 genes), and K9 on the GP path's gen-0 and evolved schedules
    (pop 4096, width 64, P 256), as ``chip_smoke.time_ms`` does, with the
    ``deap_tpu_torch`` found under ``root``, beside K5-hw with mutation
    off, K2-hw and K6-hw with crossover and mutation off, K4-hw and K9
    without the flush (``_warm``), ``torch.index_select`` of K4-hw's
    winners, torch copies of the byte genomes, the packed ones, the
    float32 ones and K9's value buffers, a read-only pass over K5's
    draws, and K5-hw's phase
    split (:func:`k5_hw_phases`) where the package's source has its clock
    and K9's (:func:`k9_phases`) for this checkout's package; print
    the times and a checksum of each result (the same inputs and keys in
    every package, so equal sums say the same results)."""
    import json
    import torch
    from chip_smoke import (CXPB, EVOLVE_CALL, INDPB, MUTPB, RA_ALPHA,
                            RA_CXPB, RA_DIM, RA_INDPB, RA_LOW, RA_MUTPB, RA_N,
                            RA_SIGMA, RA_UP, TOURNSIZE, time_ms,
                            tournament_winners)
    from deap_tpu_torch import _build, ops
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.ops import kernels, kernels_real, packed, philox

    probs = dict(cxpb=CXPB, mutpb=MUTPB, indpb=INDPB)
    flush = torch.empty(2**27, dtype=torch.int32, device=dev)  # 512 MB
    g = make_generator(23, dev)
    pk = packed.pack_genomes(ops.bernoulli_genome(L)(g, N))
    fit = packed.packed_fitness(pk)
    key = kernels.philox_key(g)
    bits = packed.evolve_bits(g, EVOLVE_CALL, TOURNSIZE, N, pk.shape[1])
    bools = torch.rand((N, L), generator=g, device=dev) < 0.5
    fbits = kernels.fused_bits(g, N, L)
    copy_to = torch.empty_like(bools)
    packed_to = torch.empty_like(pk)
    vbits = packed.variation_bits(make_generator(37, dev), N, pk.shape[1])
    sel_draws = packed.tournament_bits(make_generator(41, dev), TOURNSIZE, N)
    no_fitness = torch.zeros(N, device=dev)
    # K4-hw's winners, computed beforehand by the plain tournament rule
    winners = tournament_winners(
        fit, philox.hw_tournament_bits(key, TOURNSIZE, N))
    # a 4-byte "flush": the _warm entries find their inputs in L2
    warm = torch.empty(1, dtype=torch.int32, device=dev)
    ra = dict(cxpb=RA_CXPB, mutpb=RA_MUTPB, indpb=RA_INDPB, alpha=RA_ALPHA,
              sigma=RA_SIGMA, evaluate="rastrigin")
    real = ops.uniform_genome(RA_DIM, RA_LOW, RA_UP)(g, RA_N)
    rbits = kernels_real.real_bits(g, RA_N, RA_DIM)
    real_to = torch.empty_like(real)
    calls = {
        "k5_hw": (lambda: packed.evolve_packed(
            pk, fit, L, ngen=EVOLVE_CALL, tournsize=TOURNSIZE, prng="hw",
            key=key, **probs), 10),
        # K5-hw with mutation off: the share of its gene calls
        "k5_hw_no_mutation": (lambda: packed.evolve_packed(
            pk, fit, L, ngen=EVOLVE_CALL, tournsize=TOURNSIZE, prng="hw",
            key=key, cxpb=CXPB, mutpb=0.0, indpb=INDPB), 10),
        "k5": (lambda: packed.evolve_packed(pk, fit, L, *bits, **probs), 10),
        "k2_hw": (lambda: kernels.fused_variation_eval(
            bools, prng="hw", key=key, **probs), reps),
        "k2": (lambda: kernels.fused_variation_eval(bools, *fbits, **probs),
               reps),
        # K2-hw with crossover and mutation off: its loads and stores of
        # the genomes, the pair+row calls and the sums, without the work
        # the draws decide
        "k2_hw_copy_only": (lambda: kernels.fused_variation_eval(
            bools, prng="hw", key=key, cxpb=0.0, mutpb=0.0, indpb=INDPB),
            reps),
        # a torch copy of the same genomes: the floor of what reading and
        # writing them costs under this timer
        "torch_copy": (lambda: (copy_to.copy_(bools), no_fitness), reps),
        "k3_hw": (lambda: packed.fused_variation_eval_packed(
            pk, L, prng="hw", key=key, **probs), reps),
        # K3's bits body on draws of its own generator (the other entries'
        # inputs stay those of earlier builds' runs)
        "k3": (lambda: packed.fused_variation_eval_packed(pk, L, *vbits,
                                                          **probs), reps),
        # a read-only torch pass over K5's call's draws (a float32 sum): the
        # practical floor of reading them under this timer
        "k5_draws_read": (lambda: ([b.view(torch.float32).sum()
                                    for b in bits], (packed_to, no_fitness))[1],
                          5),
        # a torch copy of the same packed genomes: K3-hw's practical floor
        "torch_copy_packed": (lambda: (packed_to.copy_(pk), no_fitness),
                              reps),
        "k4_hw": (lambda: (packed.sel_tournament_gather_packed(
            pk, fit, prng="hw", key=key, tournsize=TOURNSIZE), no_fitness),
            reps),
        # K4's bits body on draws of its own generator (the other entries'
        # inputs stay those of earlier builds' runs)
        "k4": (lambda: (packed.sel_tournament_gather_packed(
            pk, fit, sel_draws), no_fitness), reps),
        # as the packed loop runs it: just after K3-hw wrote the fitness
        # and the genomes, which it finds in L2
        "k4_hw_warm": (lambda: (packed.sel_tournament_gather_packed(
            pk, fit, prng="hw", key=key, tournsize=TOURNSIZE), no_fitness),
            reps, warm),
        # one library call for the gather half, the winners given
        "index_select_winners": (lambda: (torch.index_select(
            pk.view(torch.int32), 0, winners), no_fitness), reps),
        # bench_suite.py's Rastrigin generation at pop 100k, 30 genes
        "k6_hw": (lambda: kernels_real.fused_variation_eval_real(
            real, prng="hw", key=key, **ra), reps),
        "k6": (lambda: kernels_real.fused_variation_eval_real(
            real, *rbits, **ra), reps),
        # K6-hw with crossover and mutation off: its loads, stores, sums
        # and pair+row calls, without the work the draws decide
        "k6_hw_copy_only": (lambda: kernels_real.fused_variation_eval_real(
            real, prng="hw", key=key, **dict(ra, cxpb=0.0, mutpb=0.0)),
            reps),
        # a torch copy of the same 12 MB genomes: K6-hw's practical floor
        "torch_copy_real": (lambda: (real_to.copy_(real), no_fitness), reps),
        # K6 with crossover, mutation or both off: what each part of the
        # work the draws decide adds to its loads, stores and sums
        **{f"k6_{name}": (lambda kw=kw: kernels_real.fused_variation_eval_real(
            real, *rbits, **dict(ra, **kw)), reps)
           for name, kw in (("no_crossover", dict(cxpb=0.0)),
                            ("no_mutation", dict(mutpb=0.0)),
                            ("copy_only", dict(cxpb=0.0, mutpb=0.0)))},
    }
    def wanted(*groups):
        """Whether --only keeps any entry of these name prefixes."""
        return not only or any(o.startswith(g) or g.startswith(o)
                               for o in only for g in groups)

    if wanted("k1", "k7", "k8", "torch_copy_f32", "torch_zeros_k8"):
        calls.update(k1_k7_k8_calls(dev, reps))
    if wanted("j1"):
        calls.update(j1_calls(dev, reps))
    if wanted("j3", "j4"):
        calls.update(j3_j4_calls(dev))
    counts = {}  # what J2's and J5's entries count beside their times
    for prefix, entries in (("j2", j2_calls), ("j5", j5_calls)):
        if wanted(prefix):
            more, more_counts = entries(dev, reps, own=root == ROOT)
            calls.update(more)
            counts.update(more_counts)
    # K9 also without the flush (its name ending in _warm): a GP loop
    # evaluates a schedule it has just uploaded, into a buffer it has just
    # filled, so it finds them in L2
    cases = k9_cases(dev) if wanted("k9", "torch_copy_k9") else []
    for name, call, *_ in cases:
        calls[name] = (call, reps)
        calls[f"{name}_warm"] = (call, reps, warm)
        # a torch copy of a value buffer of the same size: K9's floor
        buf = call()[0]
        calls[f"torch_copy_{name}"] = (
            lambda dst=torch.empty_like(buf), buf=buf: (dst.copy_(buf),
                                                        no_fitness), reps)
    times = {"package": os.path.relpath(root, ROOT)}
    if only:
        calls = {k: v for k, v in calls.items()
                 if any(k.startswith(o) for o in only)}
    for name, (call, n_reps, *cold) in calls.items():
        genomes, fitness = call()
        times[f"{name}_sum"] = int(
            genomes.contiguous().view(torch.uint8).sum()) + int(
                fitness.double().sum())
        times[f"{name}_ms"] = time_ms(call, (cold or [flush])[0],
                                      reps=n_reps)
    times.update(counts)
    if not only:
        times.update(k8_dc_times(dev, flush))
        times.update(run_checksums(dev))
        if "DTT_K5_PHASES" in (_build.CSRC / "evolve_packed.cu").read_text():
            times.update(k5_hw_phases(pk, fit, key, flush))
    if root == ROOT:  # its launch follows this checkout's launcher
        if not only:
            times.update(k9_phases(cases, flush))
        if wanted("j1_phases"):
            times.update(j1_phases(dev, flush))
        if wanted("j3_phases", "j4_phases"):
            times.update(nd_phases(dev, flush))
    if "j1_split_d100_ms" in times:
        times["j1_split_min_d"] = j1_split_edge(times)
    print(f"[{facts}] kernel times {json.dumps(times)}")


def k1_k7_k8_calls(dev, reps):
    """``kernel_times``' entries for K1 at ``ea_simple``'s shape (pop 100k,
    L 100, its masks from ``var_and_masks``): bool ``flip`` (``k1``) and
    float32 ``flip``, ``add`` and ``set``, beside a torch copy of the
    float32 output (the bool one is ``torch_copy``) and K1 with no
    crossover or mutation and each child its own parent
    (``k1_copy_only``); K8 as the prefix
    reduction calls it at 3-objective DTLZ2's 100k rows (512 queries
    against the 50k-row ranked prefix, ``k8``) beside the fill of its
    output alone (``torch_zeros_k8``); and K7 with 0/1 weights at 100k and
    50k rows."""
    import torch
    from chip_smoke import (CXPB, MO_DIM, MO_NOBJ, MO_POP, MUTPB,
                            _onemax_toolbox, dc_cross_steps)
    from deap_tpu_torch import Toolbox, ops
    from deap_tpu_torch import benchmarks as bm
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.ops import kernels, variation

    no_fitness = torch.zeros(N, device=dev)
    g = make_generator(29, dev)
    plan = variation.resolve_plan(_onemax_toolbox(Toolbox, ops))
    src = torch.randint(0, N, (N,), generator=g, device=dev,
                        dtype=torch.int32)
    partner = src[variation.pair_partner_positions(N, dev).long()]
    calls, calls_args = {}, {}
    for dtype, kind, name in ((torch.bool, "flip", "k1"),
                              (torch.float32, "flip", "k1_f32_flip"),
                              (torch.float32, "add", "k1_f32_add"),
                              (torch.float32, "set", "k1_f32_set")):
        genomes = (torch.rand((N, L), generator=g, device=dev)
                   < 0.5).to(dtype)
        cx_row, lo, hi, do_mut, mask, _ = variation.var_and_masks(
            g, N, L, CXPB, MUTPB, plan, dtype)
        arg = None if kind == "flip" else torch.randn((N, L), generator=g,
                                                      device=dev)
        args = (genomes, src, partner, cx_row, lo, hi, do_mut, mask, arg)
        calls_args[name] = args
        calls[name] = (lambda args=args, kind=kind: (
            kernels.fused_variation(*args, mut_kind=kind), no_fitness), reps)
    # K1 with no crossover, no mutation and each child its own parent: its
    # walk, loads and stores alone, beside torch_copy
    genomes, _, _, cx_row, lo, hi, do_mut, mask, _ = calls_args["k1"]
    off = torch.zeros_like(cx_row)
    own = torch.arange(N, dtype=torch.int32, device=dev)
    pairs = variation.pair_partner_positions(N, dev)
    calls["k1_copy_only"] = (lambda: (kernels.fused_variation(
        genomes, own, pairs, off, lo, hi, off, mask), no_fitness), reps)
    copy_from = torch.rand((N, L), generator=g, device=dev)
    copy_to = torch.empty_like(copy_from)
    calls["torch_copy_f32"] = (lambda: (copy_to.copy_(copy_from),
                                        no_fitness), reps)
    w = -bm.dtlz2(torch.rand((2 * MO_POP, MO_DIM), generator=g, device=dev),
                  MO_NOBJ)
    [(prefix, weights, queries)] = dc_cross_steps(torch, w, [MO_POP])
    calls["k8"] = (lambda: (kernels.dominated_weight_maxes(
        prefix, weights, queries), no_fitness), reps)
    # the fill of K8's output that its wrapper launches first, alone
    calls["torch_zeros_k8"] = (lambda: (torch.zeros(
        queries.shape[0], device=dev), no_fitness), reps)
    for rows in (2 * MO_POP, MO_POP):
        wn = w[:rows].contiguous()
        ones = torch.ones(rows, device=dev)
        calls[f"k7_{rows // 1000}k"] = (
            lambda wn=wn, ones=ones: (kernels.dominated_weight_sums(wn, ones),
                                      no_fitness), 10)
    return calls


def k8_dc_times(dev, flush, reps=9):
    """K8's 31 launches in one ``sel_nsga2(nd='dc')`` at 16,384 rows of
    3-objective DTLZ2 (the cross steps of ``mo.nd_rank_prefix``), each
    timed alone as ``chip_smoke.time_ms`` does: their sum (what a user of
    ``nd='dc'`` pays K8), the first and the last launch, and a checksum of
    their results."""
    import torch
    from chip_smoke import DC_UNION, MO_DIM, MO_NOBJ, dc_cross_steps, time_ms
    from deap_tpu_torch import benchmarks as bm
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.ops import kernels

    g = make_generator(31, dev)
    w = -bm.dtlz2(torch.rand((DC_UNION, MO_DIM), generator=g, device=dev),
                  MO_NOBJ)
    steps = dc_cross_steps(torch, w)
    out = torch.cat([kernels.dominated_weight_maxes(*s) for s in steps])
    ms = [time_ms(lambda s=s: kernels.dominated_weight_maxes(*s), flush,
                  reps=reps) for s in steps]
    return {"k8_dc_sum": int(out.view(torch.uint8).long().sum()),
            "k8_dc_ms": sum(ms), "k8_dc_first_ms": ms[0],
            "k8_dc_last_ms": ms[-1]}


def run_checksums(dev):
    """Checksums of whole runs on fixed generators: a 20-generation
    ``ea_simple`` OneMax at pop 100k (K1's path; the final genomes and
    fitness), one ``sel_nsga2(nd='dc')`` at 16,384 rows of DTLZ2 (K8's
    path; the selected rows), a 200-generation ``ea_simple_packed`` and
    four 50-generation ``evolve_packed`` calls at pop 100k, L 100, both
    with ``prng='input'`` (K4 and K3's path, K5's; with their launch
    counts), and a 50-generation fused Rastrigin loop at pop 100k, 30
    genes, with ``prng='input'`` (K6's bits body; with its launch count),
    equal across builds that give the same results."""
    import torch
    from chip_smoke import (CXPB, DC_UNION, EA_NGEN, EVOLVE_CALL,
                            EVOLVE_NGEN, INDPB, MO_DIM, MO_NOBJ, MUTPB,
                            PACKED_NGEN, RA_DIM, RA_LOW, RA_N, RA_NGEN, RA_UP,
                            TOURNSIZE, _onemax_toolbox,
                            rastrigin_fused_generation)
    from deap_tpu_torch import FitnessSpec, Toolbox, algorithms, mo, ops
    from deap_tpu_torch import benchmarks as bm
    from deap_tpu_torch.core.population import init_population
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.ops import kernels_real, packed

    g = make_generator(0, dev)
    pop = init_population(g, N, ops.bernoulli_genome(L), FitnessSpec((1.0,)),
                          device=dev)
    pop, _, _ = algorithms.ea_simple(g, pop, _onemax_toolbox(Toolbox, ops),
                                     CXPB, MUTPB, EA_NGEN, halloffame_size=1,
                                     fused="auto", device=dev)
    g = make_generator(11, dev)
    w = -bm.dtlz2(torch.rand((DC_UNION, MO_DIM), generator=g, device=dev),
                  MO_NOBJ)
    chosen = mo.sel_nsga2(None, w, DC_UNION // 2, nd="dc")
    out = {"ea_simple_sum": int(pop.genomes.view(torch.uint8).long().sum())
           + int(pop.fitness.double().sum()),
           "sel_nsga2_dc_sum": int((chosen.long() * torch.arange(
               1, chosen.shape[0] + 1, device=dev)).sum())}
    # the packed loop (K4 then K3) and evolve_packed (K5) with prng='input'
    probs = dict(cxpb=CXPB, mutpb=MUTPB, indpb=INDPB)
    W = packed.words_for(L)
    k3, k5 = packed.fused_variation_eval_packed, packed.evolve_packed
    g = make_generator(13, dev)
    pk = packed.pack_genomes(ops.bernoulli_genome(L)(g, N))
    k3_before = k3.launches
    pk, fit = algorithms.ea_simple_packed(
        g, pk, packed.packed_fitness(pk), L, PACKED_NGEN, prng="input",
        **probs, device=dev)
    out["ea_simple_packed_input_sum"] = (
        int(pk.view(torch.uint8).long().sum()) + int(fit.double().sum()))
    out["ea_simple_packed_k3_launches"] = k3.launches - k3_before
    g = make_generator(17, dev)
    pk = packed.pack_genomes(ops.bernoulli_genome(L)(g, N))
    fit = packed.packed_fitness(pk)
    k5_before = k5.launches
    for _ in range(EVOLVE_NGEN // EVOLVE_CALL):
        pk, fit = packed.evolve_packed(
            pk, fit, L, *packed.evolve_bits(g, EVOLVE_CALL, TOURNSIZE, N, W),
            prng="input", **probs)
    out["evolve_packed_input_sum"] = (
        int(pk.view(torch.uint8).long().sum()) + int(fit.double().sum()))
    out["evolve_packed_launches"] = k5.launches - k5_before
    # the fused Rastrigin loop (K6's bits body) with prng='input'
    k6 = kernels_real.fused_variation_eval_real
    g = make_generator(19, dev)
    real = ops.uniform_genome(RA_DIM, RA_LOW, RA_UP)(g, RA_N)
    fit = kernels_real.eval_rastrigin(real)
    k6_before = k6.launches
    for _ in range(RA_NGEN):
        real, fit = rastrigin_fused_generation(g, real, fit)
    out["rastrigin_fused_input_sum"] = (
        int(real.view(torch.uint8).long().sum()) + int(fit.double().sum()))
    out["rastrigin_fused_k6_launches"] = k6.launches - k6_before
    return out


def k9_cases(dev):
    """K9 on the GP path's two schedules: ``bench_gp.py``'s gen-0
    population (``gen_half_and_half(1, 2)`` at pop 4096, width 64) and
    the population after its 50 generations, each deduped and at its 256
    points: ``[(name, call, sched, branches, launch)]``, ``call()``
    returning the value buffer and an empty fitness (for
    ``kernel_times``' checksum), ``launch`` the buffer and the schedule's
    tensors as ``call`` passes them to K9."""
    import torch
    from chip_smoke import GP_ML, GP_NGEN, GP_POP, symbreg_data, symbreg_start
    from deap_tpu_torch import gp
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.ops import kernels

    pset = gp.math_set(1)
    X, _ = symbreg_data(dev)
    gen0 = gp.gen_half_and_half(pset, GP_ML, 1, 2)(make_generator(47, dev),
                                                   GP_POP)
    g, start, run = symbreg_start(dev, 1, GP_POP)
    evolved = run(g, start, GP_NGEN)["genomes"]
    none = torch.zeros(1, device=dev)
    cases = []
    for name, genomes in (("k9_gen0", gen0), ("k9_evolved", evolved)):
        interp = gp.make_batch_interpreter(pset, GP_ML, mode="grouped")
        sched, _ = interp.schedule(genomes)
        args = [torch.from_numpy(sched[k]).to(dev) for k in
                ("chunk_ops", "src_idx", "src_const", "src_isc")]
        buf = torch.zeros((pset.n_args + sched["nchunks"] * interp.chunk,
                           X.shape[0]), device=dev)
        buf[:pset.n_args] = X.T

        def call(buf=buf, args=args, branches=interp.branches,
                 levels=sched["level_starts"], chunk=interp.chunk):
            return kernels.gp_grouped_dispatch(
                buf, *args, branches, chunk=chunk, n_args=pset.n_args,
                levels=levels), none

        launch = dict(buf=buf, args=args, chunk=interp.chunk,
                      n_args=pset.n_args, levels=sched["level_starts"])
        cases.append((name, call, sched, interp.branches, launch))
    return cases


def nd_scan_inputs(dev):
    """J3's and J4's inputs as ``chip_smoke.py`` phase 11b times them (the
    same in every package), by name: the staircase's ``(neg_f2, head)`` of
    ZDT1 values of uniform genomes at ``chip_smoke.J3_SIZES`` (``j3_50k``,
    ``j3_100k``) and the sweep's ``(Q, U, head, F)`` of DTLZ2 unions at
    ``chip_smoke.J4_SIZES`` (``j4_16384``, ``j4_100k``)."""
    import torch
    from chip_smoke import J3_SIZES, J4_SIZES, MO_DIM, MO_NOBJ, ZDT1_DIM
    from deap_tpu_torch import benchmarks as bm
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.mo import emo, ndsort

    g = make_generator(41, dev)
    out = {}
    for n in J3_SIZES:
        w = -bm.zdt1(torch.rand((n, ZDT1_DIM), generator=g, device=dev))
        out[f"j3_{n // 1000}k"] = emo.staircase_inputs(w)[1:]
    for n in J4_SIZES:
        w = -bm.dtlz2(torch.rand((n, MO_DIM), generator=g, device=dev),
                      MO_NOBJ)
        tag = f"{n // 1000}k" if n % 1000 == 0 else str(n)
        out[f"j4_{tag}"] = ndsort.sweep3_inputs(w)[1:]
    return out


def j3_j4_calls(dev, reps=10):
    """``kernel_times``' entries for J3 and J4 on :func:`nd_scan_inputs`,
    J3 also with every front maximum in device memory
    (``j3_all_device_*``); each returns the ranks for the checksum."""
    import torch
    from chip_smoke import j3_shared_slots
    from deap_tpu_torch.mo import emo, ndsort

    none = torch.zeros(1, device=dev)

    def all_device(neg, head):
        with j3_shared_slots(emo, 1):
            return emo.staircase_rows(neg, head)

    calls = {}
    for name, args in nd_scan_inputs(dev).items():
        if name.startswith("j3"):
            calls[name] = (lambda args=args: (emo.staircase_rows(*args),
                                              none), reps)
            calls[f"j3_all_device{name[2:]}"] = (lambda args=args: (
                all_device(*args), none), reps)
        else:
            calls[name] = (lambda args=args: (ndsort.sweep3_rows(*args),
                                              none), reps)
    return calls


def j2_calls(dev, reps, own):
    """``kernel_times``' entries for J2 at ``examples/gp/ant.py``'s width
    80 and 543 moves, pop 4096: on ``chip_smoke.ant_trees`` (``j2``) and
    on the population after ``chip_smoke.ant_evolved``'s 10 generations
    (``j2_evolved``), each returning ``(eaten, steps)`` for the checksum;
    beside them the launches of one call and, where the package traces
    its walk, each set's iterations and steps; for this checkout's
    package (``own``) the clocks of one dependent shared-memory load."""
    import torch
    from chip_smoke import (ANT_ML, ANT_MOVES, ant_evolved, ant_trees,
                            shared_load_clocks)
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.gp import ant

    trail, start = ant.parse_trail()
    grid = torch.as_tensor(trail, device=dev)
    words = ant.pack_trail(grid)
    max_steps = ANT_MOVES * ANT_ML + ANT_ML
    g = make_generator(61, dev)
    sets = {"j2": ant_trees(g),
            "j2_evolved": ant_evolved(g, trail, start)[0].genomes}
    calls, counts = {}, {}
    for name, t in sets.items():
        args = (t["nodes"].to(torch.int32).contiguous(),
                t["length"].to(torch.int32).contiguous(), grid, start,
                ANT_MOVES, max_steps, 1, words)
        calls[name] = (lambda args=args: ant.ant_rollout(*args), reps)
        before = ant.ant_rollout.launches
        ant.ant_rollout(*args)
        counts[f"{name}_launches_a_call"] = ant.ant_rollout.launches - before
        if hasattr(ant, "ant_rollout_traced"):
            _, steps, iters, _ = ant.ant_rollout_traced(*args)
            counts.update({f"{name}_iterations_max": int(iters.max()),
                           f"{name}_iterations_sum": int(iters.sum()),
                           f"{name}_steps_max": int(steps.max()),
                           f"{name}_steps_sum": int(steps.sum())})
    if own:
        counts["j2_shared_load_clocks"] = shared_load_clocks(torch, dev)
    return calls, counts


def j5_sets(dev):
    """J5's inputs by name, each ``(genomes, starts)``: ``chip_smoke.py``'s
    ``cartpole_neuro_pop10k`` population at gen 0 (``j5``) and after its
    20 generations (``j5_evolved``), with the run's 3 starts, and
    ``chip_smoke.j5_capped_population`` (``j5_capped``: every episode at
    the cap) with 3 starts of its own."""
    from chip_smoke import (CP_EPISODES, CP_NGEN, cartpole_generation,
                            cartpole_start, j5_capped_population)
    import torch
    from deap_tpu_torch.benchmarks import cartpole
    from deap_tpu_torch.device import make_generator
    g, starts, tb, pop = cartpole_start(dev, 11)
    gen0 = pop.genomes.contiguous()
    for _ in range(CP_NGEN):
        pop = cartpole_generation(g, pop, tb)
    g = make_generator(67, dev)
    capped = j5_capped_population(torch, dev, g)
    return {"j5": (gen0, starts),
            "j5_evolved": (pop.genomes.contiguous(), starts),
            "j5_capped": (capped, cartpole.initial_state(g, CP_EPISODES))}


def j5_step_clocks(torch, dev):
    """J5's clocks a step of one thread alone: the balancing genome's one
    episode of ``chip_smoke.CP_STEPS`` steps."""
    from chip_smoke import CP_STEPS, balancing_genome
    from deap_tpu_torch.benchmarks import cartpole
    from deap_tpu_torch.device import make_generator
    starts = cartpole.initial_state(make_generator(1, dev), 1)
    clocks = torch.zeros(1, dtype=torch.int64, device=dev)
    cartpole.cartpole_rollout(balancing_genome(torch, dev)[None], starts,
                              CP_STEPS, clocks=clocks)
    return int(clocks.item()) / CP_STEPS


def j5_calls(dev, reps, own):
    """``kernel_times``' entries for J5 on :func:`j5_sets` (500 steps),
    each returning its returns for the checksum; beside them the launches
    of one call, one lone thread's clocks a step, each set's warp-steps
    (a warp as long as its longest episode) and, for this checkout's
    package (``own``), the instructions of the width-16 step
    (``cuobjdump -sass``)."""
    import torch
    from chip_smoke import CP_STEPS, j5_step_instructions, j5_warp_steps
    from deap_tpu_torch.benchmarks import cartpole
    calls, counts = {}, {}
    zero = torch.zeros(1, device=dev)
    for name, (genomes, starts) in j5_sets(dev).items():
        calls[name] = (lambda genomes=genomes, starts=starts: (
            cartpole.cartpole_rollout(genomes, starts, CP_STEPS), zero),
            reps)
        before = cartpole.cartpole_rollout.launches
        r = cartpole.cartpole_rollout(genomes, starts, CP_STEPS)
        counts[f"{name}_launches_a_call"] = (cartpole.cartpole_rollout
                                             .launches - before)
        counts[f"{name}_warp_steps"] = int(j5_warp_steps(r).sum())
        counts[f"{name}_longest"] = int(r.max())
    counts["j5_step_clocks"] = j5_step_clocks(torch, dev)
    if own:  # another build's kernel may have no width-16 instance
        counts["j5_step_instructions"], counts[
            "j5_step_loop_instructions"], _ = j5_step_instructions()
    return calls, counts


#: J5's builds in ``--j5-variants`` (name: ``-D`` flags of
#: ``csrc/cartpole_rollout.cu``): its yardstick, the physics computed after
#: the action for the chosen force alone (the first design's order), and
#: the default build
J5_VARIANTS = {
    "physics after the action": ["-DDTT_J5_PHYSICS_AFTER_ACTION"],
    "default: physics beside, one range check": []}


def j5_variants(dev, facts, out_dir, reps=25):
    """J5 on :func:`j5_sets` in each build of ``J5_VARIANTS``, each bitwise
    against the default build, timed in turns (forward, then backward) as
    ``chip_smoke.time_ms`` times; each build's lone-thread clocks a step
    and its width-16 step's instructions (the listings go to
    ``out_dir``)."""
    import torch
    from chip_smoke import (CP_STEPS, bitwise_equal, j5_step_instructions,
                            time_ms)
    from deap_tpu_torch import _build
    from deap_tpu_torch.benchmarks import cartpole

    libs = build_variants("cartpole_rollout", J5_VARIANTS,
                          "cartpole_rollout_kernel")
    default_lib = _build.library("cartpole_rollout")
    sets = j5_sets(dev)
    flush = torch.empty(2**27, dtype=torch.int32, device=dev)  # 512 MB

    def variant(name, fn, *args):
        def call():
            _build._LIBS["cartpole_rollout"] = libs[name]
            try:
                return fn(*args)
            finally:
                _build._LIBS["cartpole_rollout"] = default_lib
        return call

    for i, name in enumerate(libs):
        steps = variant(name, j5_step_clocks, torch, dev)()
        count, whole, ops = j5_step_instructions(
            _build.BUILD_DIR / f"libcartpole_rollout-variant{i}.so",
            out=os.path.join(out_dir, f"j5_variant{i}.sass"))
        print(f"[{facts}] J5 {name}: {steps:.1f} clocks a step of one "
              f"thread alone; {count} instructions a width-16 step ({whole} "
              f"with the slow paths): "
              + ", ".join(f"{k} {v}" for k, v in ops.items()))
    for set_name, (genomes, starts) in sets.items():
        args = (genomes, starts, CP_STEPS)
        want = cartpole.cartpole_rollout(*args)
        calls = {name: variant(name, cartpole.cartpole_rollout, *args)
                 for name in libs}
        for name, fn in calls.items():
            if not bitwise_equal(fn(), want):
                raise RuntimeError(f"J5 {name} differs from the default "
                                   f"build on {set_name}")
        times = {name: [] for name in calls}
        for name in list(calls) + list(calls)[::-1]:
            times[name].append(time_ms(calls[name], flush, reps=reps))
        for name, ms in times.items():
            print(f"[{facts}] J5 {set_name} {name}: "
                  + ", ".join(f"{t * 1e3:.2f}" for t in ms) + " us "
                  f"(longest episode {int(want.max())} steps)")


#: J1's shapes in ``--kernel-times``: CMA-ES's C at dim 100, the two
#: serving buckets, and d 192 (A and V in device memory)
J1_SHAPES = {"j1": (100, 100), "j1_1024x10": (1024, 10, 10),
             "j1_256x30": (256, 30, 30), "j1_d192": (192, 192)}


def j1_matrices(dev):
    """J1's inputs at ``J1_SHAPES``, by name: ``chip_smoke.j1_inputs``'
    random SPD matrices (the same in every package)."""
    import math
    import torch
    from chip_smoke import j1_inputs
    out = {}
    for name, shape in J1_SHAPES.items():
        d, nmat = shape[-1], math.prod(shape[:-2])
        C = j1_inputs(torch, dev, d, nmat, torch.eye(d, device=dev))["spd"]
        out[name] = C.reshape(shape)
    return out


#: the d at which ``j1_calls`` times J1 at batch 1 split over two SMs and
#: on one SM (``j1_split_d*``, ``j1_one_sm_d*``): where the split starts to
#: pay, ``linalg.J1_SPLIT_MIN_D``
J1_SPLIT_DIMS = (16, 32, 34, 35, 36, 37, 38, 39, 40, 48, 64, 100, 170)


def j1_calls(dev, reps):
    """J1 at ``J1_SHAPES`` and ``torch.linalg.eigh`` on the same inputs
    (``j1_torch_eigh*``), each returning ``(V, w)`` for the checksum. Where
    the package splits a matrix over two SMs (``linalg._j1_splits``), also
    J1 with the split forced on and off: at batch 1 for each d of
    ``J1_SPLIT_DIMS``, and at d 100 for the most matrices a split launch
    holds, half the card's SMs (``j1_split_<batch>x100``,
    ``j1_one_sm_<batch>x100``)."""
    import torch
    from chip_smoke import j1_inputs
    from deap_tpu_torch.ops import linalg
    calls = {}
    for name, C in j1_matrices(dev).items():
        calls[name] = (lambda C=C: linalg.eigh_jacobi(C)[::-1], reps)
        calls[f"j1_torch_eigh{name[2:]}"] = (
            lambda C=C: torch.linalg.eigh(C)[::-1], reps)
    if not hasattr(linalg, "_j1_splits"):
        return calls
    plan = linalg._j1_splits

    def forced(C, split):
        linalg._j1_splits = lambda d, nmat, sms: split
        try:
            return linalg.eigh_jacobi(C)[::-1]
        finally:
            linalg._j1_splits = plan

    most = torch.cuda.get_device_properties(dev).multi_processor_count // 2
    for d, nmat, tag in ([(d, 1, f"d{d}") for d in J1_SPLIT_DIMS]
                         + [(100, most, f"{most}x100")]):
        C = j1_inputs(torch, dev, d, nmat, torch.eye(d, device=dev))["spd"]
        calls[f"j1_split_{tag}"] = (lambda C=C: forced(C, True), reps)
        calls[f"j1_one_sm_{tag}"] = (lambda C=C: forced(C, False), reps)
    return calls


def j1_split_edge(times):
    """The smallest d of ``J1_SPLIT_DIMS`` from which J1 split over two SMs
    is faster than on one SM at every larger d measured (None where the
    times lack the entries)."""
    edge = None
    for d in reversed(J1_SPLIT_DIMS):
        split, one = (times.get(f"j1_{k}_d{d}_ms") for k in ("split", "one_sm"))
        if split is None or one is None or split >= one:
            break
        edge = d
    return edge


def j1_phases(dev, flush, reps=10, shapes=None):
    """J1's rounds split by phase, from a build of csrc/jacobi_eigh.cu
    with ``-DDTT_J1_PHASES`` (thread 0 of each block, and in a design with
    warps of its own for V the first of them, adds the SM clocks of each
    phase of every round to device totals; the library names its phases),
    at ``J1_SHAPES`` (or those of them named in ``shapes``): each phase's
    SM clocks a round (per block), and the
    instrumented call's time (its cost against the uninstrumented one).
    The instrumented build's ``w`` and ``V`` must equal J1's bitwise."""
    import ctypes
    import subprocess
    import torch
    from chip_smoke import time_ms
    from deap_tpu_torch import _build
    from deap_tpu_torch.ops import linalg

    lib_path = str(_build.BUILD_DIR / "libjacobi_eigh-phases.so")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DDTT_J1_PHASES", "-o",
         lib_path, str(_build.CSRC / "jacobi_eigh.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc -DDTT_J1_PHASES failed:\n{done.stdout}")
    lib = ctypes.CDLL(lib_path)
    run = lib.jacobi_eigh
    run.argtypes, run.restype = list(linalg.J1_ARGTYPES), _build.INT
    lib.jacobi_eigh_phase_names.restype = ctypes.c_char_p
    names = lib.jacobi_eigh_phase_names().decode().split(",")
    read = lib.jacobi_eigh_phases
    read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), _build.INT]
    read.restype = _build.INT
    out = {}
    for name, C in j1_matrices(dev).items():
        if shapes and name not in shapes:
            continue
        d = C.shape[-1]
        nmat = C.numel() // (d * d)
        rounds = linalg.default_sweeps(d) * (d + d % 2 - 1)

        def call(C=C):
            w, V, err = linalg._j1_launch(run, C, None)
            if err:
                raise RuntimeError(f"J1 (phases build): CUDA error {err}")
            return w, V

        got = call() + linalg.eigh_jacobi(C)
        torch.cuda.synchronize()
        w, V, wk, Vk = (t.view(torch.int32) for t in got)
        if not (torch.equal(w, wk) and torch.equal(V, Vk)):
            raise RuntimeError(f"J1 (phases build) differs from J1 on {name}")
        clocks = (ctypes.c_ulonglong * len(names))()
        read(clocks, 1)  # clear the first calls' totals
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        if read(clocks, 1):
            raise RuntimeError("J1 (phases build): reading the clocks failed")
        out[f"{name}_phases_ms"] = time_ms(call, flush, reps=reps)
        for phase, c in zip(names, clocks):
            out[f"{name}_clocks_per_round_{phase}"] = c / (reps * nmat
                                                            * rounds)
    return out


def nd_phases(dev, flush, reps=5):
    """J3's and J4's chunks split by phase, from a build of
    csrc/nd_scan.cu with ``-DDTT_ND_PHASES`` (lane 0 of J3's warp and
    thread 0 of J4's block add the SM clocks of each phase of every chunk
    to device totals; the library names the phases), on
    :func:`nd_scan_inputs`, one front of J3's 100k rows (no chain) and
    100k copies of one DTLZ2 row (no gather, no chain): each phase's SM
    clocks a chunk of 32 rows, and the instrumented call's time. The
    instrumented build runs through the wrappers and must give their
    ranks bitwise."""
    import ctypes
    import subprocess
    import torch
    from chip_smoke import (J3_SIZES, J4_SIZES, MO_NOBJ, nd_scan_rows,
                            time_ms)
    from deap_tpu_torch import _build
    from deap_tpu_torch.mo import emo, ndsort

    lib_path = str(_build.BUILD_DIR / "libnd_scan-phases.so")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DDTT_ND_PHASES", "-o",
         lib_path, str(_build.CSRC / "nd_scan.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc -DDTT_ND_PHASES failed:\n{done.stdout}")
    lib = ctypes.CDLL(lib_path)
    lib.dtt_error_string.argtypes = [_build.INT]
    lib.dtt_error_string.restype = ctypes.c_char_p
    lib.nd_scan_phase_names.argtypes = [_build.INT]
    lib.nd_scan_phase_names.restype = ctypes.c_char_p
    names = [lib.nd_scan_phase_names(k).decode().split(",") for k in (0, 1)]
    read = lib.nd_scan_phases
    read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), _build.INT]
    read.restype = _build.INT
    inputs = nd_scan_inputs(dev)
    n3, n4 = J3_SIZES[1], J4_SIZES[1]
    inputs[f"j3_one_front_{n3 // 1000}k"] = emo.staircase_inputs(
        nd_scan_rows(torch, dev, "one_front", n3, 2, 9))[1:]
    w = nd_scan_rows(torch, dev, "random", 1, MO_NOBJ, 9)
    inputs[f"j4_copies_{n4 // 1000}k"] = ndsort.sweep3_inputs(
        w.expand(n4, MO_NOBJ).contiguous())[1:]
    cases = {name: (0, emo.staircase_rows, args) if name.startswith("j3")
             else (1, ndsort.sweep3_rows, args)
             for name, args in inputs.items()}
    want = {name: fn(*args) for name, (_, fn, args) in cases.items()}
    clocks = (ctypes.c_ulonglong * (2 * len(names[0])))()
    out = {}
    saved = _build._LIBS.get("nd_scan")
    _build._LIBS["nd_scan"] = lib
    try:
        for name, (kernel, fn, args) in cases.items():
            got = fn(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, want[name]):
                raise RuntimeError(f"nd_scan (phases build) differs on {name}")
            read(clocks, 1)  # clear the first call's totals
            for _ in range(reps):
                fn(*args)
            torch.cuda.synchronize()
            if read(clocks, 1):
                raise RuntimeError("nd_scan (phases build): reading the "
                                   "clocks failed")
            chunks = -(-got.shape[0] // 32)
            row = clocks[kernel * len(names[0]):(kernel + 1) * len(names[0])]
            out[f"{name}_phases_ms"] = time_ms(lambda: fn(*args), flush,
                                               reps=reps)
            for phase, c in zip(names[kernel], row):
                out[f"{name}_clocks_per_chunk_{phase}"] = c / (reps * chunks)
    finally:
        if saved is None:
            _build._LIBS.pop("nd_scan")
        else:
            _build._LIBS["nd_scan"] = saved
    return out


K9_PHASES = ("decode_level_descriptors", "wait", "work", "count_ticket")


def k9_phases(cases, flush, reps=25):
    """K9's items split by phase, from a build of csrc/gp_grouped.cu with
    ``-DDTT_K9_PHASES`` (thread 0 of each block adds the SM clocks of each
    phase of its items, ``K9_PHASES``, and the polls of its waits, to
    device totals), on each of :func:`k9_cases`' schedules: the phases'
    shares of the clocks, the clocks and polls an item, and the
    instrumented call's time (its cost against the uninstrumented one).
    The instrumented call's value buffer must equal K9's bitwise."""
    import ctypes
    import subprocess
    import torch
    from chip_smoke import time_ms
    from deap_tpu_torch import _build
    from deap_tpu_torch.ops import kernels

    lib_path = str(_build.BUILD_DIR / "libgp_grouped-phases.so")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DDTT_K9_PHASES", "-o",
         lib_path, str(_build.CSRC / "gp_grouped.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc -DDTT_K9_PHASES failed:\n{done.stdout}")
    lib = ctypes.CDLL(lib_path)
    P, I = _build.PTR, _build.INT
    run = lib.gp_grouped_dispatch
    run.argtypes, run.restype = [P] * 7 + [I, P] + [I] * 8 + [P], I
    read = lib.gp_grouped_phases
    read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), I]
    read.restype = I
    out = {}
    for name, call, _, branches, given in cases:
        want = call()[0].clone()
        buf, (src_ops, src_idx, src_const, src_isc) = (given["buf"],
                                                       given["args"])
        R, Pts = buf.shape
        chunk, levels = given["chunk"], [int(v) for v in given["levels"]]
        rows, tile = kernels.k9_item_shape(chunk, Pts)
        starts = (ctypes.c_int * len(levels))(*levels)
        codes = kernels._branch_codes(branches)
        counters = torch.zeros(kernels.K9_LINE * len(levels),
                               dtype=torch.int32, device=buf.device)
        stream = torch.cuda.current_stream(buf.device).cuda_stream

        def launch():
            err = run(buf.data_ptr(), src_ops.data_ptr(),
                      ctypes.addressof(codes), src_idx.data_ptr(),
                      src_const.data_ptr(), src_isc.data_ptr(),
                      ctypes.addressof(starts), len(levels) - 1,
                      counters.data_ptr(), given["n_args"], R, Pts, rows,
                      tile, src_idx.shape[1], chunk, len(branches), stream)
            if err:
                raise RuntimeError(f"K9 (phases build): CUDA error {err}")
            return buf, counters

        buf[given["n_args"]:] = float("nan")  # an early read would show
        launch()
        torch.cuda.synchronize()
        if not torch.equal(buf.view(torch.int32), want.view(torch.int32)):
            raise RuntimeError(f"K9 (phases build) differs from K9 on {name}")
        clocks = (ctypes.c_ulonglong * (len(K9_PHASES) + 1))()
        read(clocks, 1)  # clear the first call's totals
        for _ in range(reps):
            launch()
        torch.cuda.synchronize()
        if read(clocks, 1):
            raise RuntimeError("K9 (phases build): reading the clocks failed")
        n_items = len(kernels.k9_work_items(levels, chunk, Pts)[0])
        total = sum(clocks[:len(K9_PHASES)])
        out[f"{name}_phases_ms"] = time_ms(launch, flush, reps=reps)
        out[f"{name}_clocks_per_item"] = total / (reps * n_items)
        out[f"{name}_polls_per_item"] = clocks[len(K9_PHASES)] / (
            reps * n_items)
        for phase, c in zip(K9_PHASES, clocks):
            out[f"{name}_share_{phase}"] = c / total
    return out


K5_PHASES = ("draws_to_list_barrier", "winner_list_parent_load_issue",
             "gene_calls", "cross_flip_store_thread0", "grid_barrier")


def k5_hw_phases(pk, fit, key, flush, reps=10):
    """K5-hw's generation split by phase, from a build of
    csrc/evolve_packed.cu with ``-DDTT_K5_PHASES`` (thread 0 of each block
    adds the SM clocks of each phase, ``K5_PHASES``, to a device total):
    the phases' shares of a block's clocks, each share times the
    instrumented call's time, the clocks per block and generation, and the
    instrumented call's time (its cost against the uninstrumented one).
    The instrumented call's result checksum must equal K5-hw's."""
    import ctypes
    import subprocess
    import torch
    from chip_smoke import CXPB, EVOLVE_CALL, INDPB, MUTPB, TOURNSIZE, time_ms
    from deap_tpu_torch import _build
    from deap_tpu_torch.ops import packed

    lib_path = str(_build.BUILD_DIR / "libevolve_packed-phases.so")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DDTT_K5_PHASES", "-o",
         lib_path, str(_build.CSRC / "evolve_packed.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc -DDTT_K5_PHASES failed:\n{done.stdout}")
    lib = ctypes.CDLL(lib_path)
    P, I, F = _build.PTR, _build.INT, _build.FLOAT
    run = lib.evolve_packed_hw
    run.argtypes, run.restype = [P] * 5 + [I] * 5 + [F] * 3 + [P], I
    read = lib.evolve_packed_hw_phases
    read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), I]
    read.restype = I
    n, W = pk.shape
    pops = torch.empty((2, n, W), dtype=torch.uint32, device=pk.device)
    fits = torch.empty((2, n), dtype=torch.float32, device=pk.device)
    stream = torch.cuda.current_stream(pk.device).cuda_stream

    def call():
        err = run(pk.data_ptr(), fit.data_ptr(), key.data_ptr(),
                  pops.data_ptr(), fits.data_ptr(), n, W, L, EVOLVE_CALL,
                  TOURNSIZE, CXPB, MUTPB, INDPB, stream)
        if err:
            raise RuntimeError(f"K5-hw (phases build): CUDA error {err}")
        return pops[(EVOLVE_CALL - 1) % 2], fits[(EVOLVE_CALL - 1) % 2]

    clocks = (ctypes.c_ulonglong * len(K5_PHASES))()
    genomes, fitness = call()
    torch.cuda.synchronize()
    out = {"k5_hw_phases_sum": int(genomes.view(torch.uint8).sum())
           + int(fitness.double().sum())}
    read(clocks, 1)  # clear the first call's totals
    for _ in range(reps):
        call()
    torch.cuda.synchronize()
    if read(clocks, 1):
        raise RuntimeError("K5-hw (phases build): reading the clocks failed")
    ms = time_ms(call, flush, reps=reps)
    blocks = packed._k5_hw_grid(n)[0]
    total = sum(clocks)
    out["k5_hw_phases_ms"] = ms
    out["k5_hw_clocks_per_block_gen"] = total / (reps * blocks * EVOLVE_CALL)
    for name, c in zip(K5_PHASES, clocks):
        out[f"k5_hw_share_{name}"] = c / total
        out[f"k5_hw_us_per_gen_{name}"] = c / total * ms * 1e3 / EVOLVE_CALL
    return out


def profile_cartpole(dev, out_dir, facts):
    from chip_smoke import cartpole_generation, cartpole_start

    g, _, tb, pop = cartpole_start(dev, 11)
    state = {"pop": pop}

    def run(steps):
        for _ in range(steps):
            state["pop"] = cartpole_generation(g, state["pop"], tb)

    profile("cartpole_neuro_pop10k", run, 3, 10, out_dir, facts,
            kernels=("cartpole_rollout_kernel",))


PROFILES = {"nsga2": profile_nsga2, "fused": profile_fused,
            "evolve": profile_evolve, "rastrigin": profile_rastrigin,
            "gp": profile_gp, "cmaes": profile_cmaes,
            "mu_lambda": profile_mu_lambda, "cartpole": profile_cartpole}
#: the loops with a prng mode, which --hw runs in both modes
HW_LOOPS = {"fused": profile_fused, "packed": profile_packed,
            "evolve": profile_evolve, "rastrigin": profile_rastrigin}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(ROOT, "build",
                                                      "profile"))
    parser.add_argument("--nsga2", action="store_true",
                        help="profile the NSGA-II 3-objective generation")
    parser.add_argument("--fused", action="store_true",
                        help="profile the fused OneMax loop (K2)")
    parser.add_argument("--evolve", action="store_true",
                        help="profile evolve_packed (K5)")
    parser.add_argument("--rastrigin", action="store_true",
                        help="profile the fused Rastrigin loop (K6)")
    parser.add_argument("--gp", action="store_true",
                        help="profile the GP symbolic regression loop (K9)")
    parser.add_argument("--cmaes", action="store_true",
                        help="profile CMA-ES at dim 100, lambda 4096 and "
                             "time its parts")
    parser.add_argument("--eigh", nargs="+", default=["lapack"],
                        choices=["lapack", "jacobi"],
                        help="the eigensolvers --cmaes profiles, in turns "
                             "(default lapack)")
    parser.add_argument("--mu-lambda", action="store_true",
                        help="profile the (mu + lambda) and (mu, lambda) "
                             "OneMax loops (var_or through K1)")
    parser.add_argument("--cartpole", action="store_true",
                        help="bench_suite.py's cartpole_neuro_pop10k, 10 "
                             "generations after 3 (J5)")
    parser.add_argument("--hw", action="store_true",
                        help="profile the chosen loops (alone: the OneMax "
                             "loops) with prng='hw' beside prng='input'")
    parser.add_argument("--sass", action="store_true",
                        help="count the instructions of K7's and K8's "
                             "inner loops, of K1's walk and of one Philox "
                             "call")
    parser.add_argument("--k7-variants", action="store_true",
                        help="time K7 with 4, 8 and 16 query rows per "
                             "thread and with the prune off")
    parser.add_argument("--j2-variants", action="store_true",
                        help="time J2 with every ant on the stack walk "
                             "beside the default build")
    parser.add_argument("--j5-variants", action="store_true",
                        help="time J5's yardstick build (the physics "
                             "after the action) beside the default build")
    parser.add_argument("--kernel-times", action="store_true",
                        help="time K5-hw, K5, K2-hw, K2, K3-hw, K3, K4-hw, "
                             "K4 and K1 at pop 100k, L 100, K8 and K7 at the "
                             "NSGA-II path's shapes, K6-hw and K6 at 30 "
                             "genes, K9 on the GP schedules and J1 at d "
                             "100, 192 and the serving buckets (alone: "
                             "nothing else runs)")
    parser.add_argument("--only", metavar="PREFIX", nargs="+",
                        help="with --kernel-times: only the entries whose "
                             "names start with one of the PREFIXes (e.g. "
                             "j1, j2, j5, or j3 j4), without the checksum "
                             "runs and the other phase clocks")
    parser.add_argument("--package-root", default=ROOT,
                        help="the checkout whose deap_tpu_torch is built, "
                             "profiled and timed (e.g. an "
                             "unpacked archive of another commit)")
    args = parser.parse_args()
    chosen = [name for name in PROFILES if getattr(args, name)]
    import torch
    if not torch.cuda.is_available():
        print("port_profile: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke  # noqa: F401  (this checkout's, whatever the package)
    root = os.path.abspath(args.package_root)
    sys.path.insert(0, root)
    if args.kernel_times:
        from deap_tpu_torch.device import gpu_facts
        kernel_times(torch.device("cuda"), gpu_facts(), root,
                     only=args.only)
        return 0
    from deap_tpu_torch import FitnessSpec, Toolbox, _build, algorithms, ops
    from deap_tpu_torch.core.population import init_population
    from deap_tpu_torch.device import gpu_facts, make_generator
    from deap_tpu_torch.ops import packed
    from deap_tpu_torch.support.stats import fitness_stats

    os.makedirs(args.out, exist_ok=True)
    facts = gpu_facts()
    _build.build()
    dev = torch.device("cuda")
    if args.sass:
        sass_dominance(args.out, facts)
        sass_k1(args.out, facts)
        sass_philox(args.out, facts)
    if args.k7_variants:
        k7_variants(dev, facts)
    if args.j2_variants:
        j2_variants(dev, facts)
    if args.j5_variants:
        j5_variants(dev, facts, args.out)
    if args.hw and not any(name in HW_LOOPS for name in chosen):
        chosen += ["fused", "packed", "evolve"]
    if (chosen or args.sass or args.k7_variants or args.j2_variants
            or args.j5_variants):
        for name in chosen:
            if args.hw and name in HW_LOOPS:
                for prng in ("input", "hw"):
                    HW_LOOPS[name](dev, args.out, facts, prng)
            elif name == "cmaes":
                for eigh in args.eigh:
                    profile_cmaes(dev, args.out, facts, eigh)
            else:
                PROFILES[name](dev, args.out, facts)
        print(facts)
        return 0

    tb = Toolbox()
    tb.register("evaluate", lambda g: g.sum(-1).to(torch.float32))
    tb.register("mate", ops.cx_two_point)
    tb.register("mutate", ops.mut_flip_bit, indpb=0.05)
    tb.register("select", ops.sel_tournament, tournsize=3)
    gen = make_generator(0, dev)
    pop = init_population(gen, N, ops.bernoulli_genome(L),
                          FitnessSpec((1.0,)), device=dev)
    pop, _, hof = algorithms.ea_simple(gen, pop, tb, 0.5, 0.2, 0,
                                       halloffame_size=1, device=dev)
    step = algorithms.make_ea_simple_step(tb, 0.5, 0.2, fitness_stats())
    state = {"pop": pop, "hof": hof}

    def run_ea(steps):
        for _ in range(steps):
            state["pop"], state["hof"], _ = step(gen, state["pop"],
                                                 state["hof"])

    profile("ea_simple", run_ea, 3, 10, args.out, facts,
            kernels=("fused_variation_kernel",))

    pk = packed.pack_genomes(ops.bernoulli_genome(L)(gen, N))
    pstate = {"pk": pk, "fit": packed.packed_fitness(pk)}

    def run_packed(steps):
        pstate["pk"], pstate["fit"] = algorithms.ea_simple_packed(
            gen, pstate["pk"], pstate["fit"], L, steps, cxpb=0.5, mutpb=0.2,
            indpb=0.05, device=dev)

    profile("ea_simple_packed", run_packed, 10, 100, args.out, facts)
    print(facts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
