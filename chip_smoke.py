#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure ends the script with a non-zero exit code):

1. build every kernel of ``deap_tpu_torch/csrc`` with ``nvcc`` (one
   process per source, all started together);
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (pop 100,000, L 100, 4 words) — bitwise — and time
   both with CUDA events, the L2 cache flushed before every launch;
3. ``ea_simple`` OneMax (pop 100k, L 100, cxpb 0.5, mutpb 0.2, indpb 0.05,
   tournament 3, hall of fame 1, fitness statistics) for 20 generations,
   after a small run that must equal the unfused composition bit for bit;
4. the packed generation (tournament select-and-gather kernel, then the
   packed variation kernel) for 200 generations at pop 100k, after a
   small run that must equal the plain versions bit for bit, and the same
   step with the rank-based tournament.

Every launch counter is set to 0 just before a main-path run and read
just after it. The last lines are one JSON object with each kernel's
numbers, the card's name and power limit from ``nvidia-smi``, and the
result line ``{"ok": true, "device": {...}}``.
"""

import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

N, L, TOURNSIZE = 100_000, 100, 3
CXPB, MUTPB, INDPB = 0.5, 0.2, 0.05
EA_NGEN, PACKED_NGEN = 20, 200
# device memory rates by card name (NVIDIA data sheets), bytes per second
MEMORY_RATES = (("H200", 4.8e12), ("H100 PCIe", 2.0e12), ("H100", 3.35e12))


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def memory_rate(name):
    for key, rate in MEMORY_RATES:
        if key in name:
            return rate
    fail(f"no memory rate known for {name!r}")


def bitwise_equal(a, b):
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == torch.uint32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def max_abs_err(a, b):
    import torch
    if a.dtype == torch.uint32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return float((a.double() - b.double()).abs().max())


def time_ms(fn, flush, reps=25):
    """Median device time of one call, each call after an L2 flush."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not os.path.isdir(os.path.join(ROOT, "deap_tpu_torch")):
        fail("deap_tpu_torch/ is not beside this script: run it from a "
             "checkout of the repository")
    sys.path.insert(0, ROOT)

    from deap_tpu_torch import Toolbox, FitnessSpec, _build, algorithms, ops
    from deap_tpu_torch.core.population import init_population
    from deap_tpu_torch.device import gpu_facts, make_generator
    from deap_tpu_torch.ops import kernels, packed, variation
    from deap_tpu_torch.support.stats import fitness_stats

    dev = torch.device("cuda")
    facts = gpu_facts()
    name = torch.cuda.get_device_name(0)
    rate = memory_rate(name)
    tag = f"[{facts}]"
    print(f"card: {facts}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; memory rate for bounds {rate / 1e12} TB/s")

    # ------------------------------------------------------------ build --
    t0 = time.perf_counter()
    seconds = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall for "
          f"{len(seconds)} kernels "
          + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()))
    for src in _build.SOURCES:
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")

    flush = torch.empty(2**27, dtype=torch.int32, device=dev)  # 512 MB
    report = {}

    def record(key, name, source, replaces, err, ms, plain_ms, nbytes):
        bound_ms = nbytes / rate * 1e3
        report[key] = {"name": name, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": None,
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": "bytes",
                       "library_ms": None}
        print(f"{tag} {name}: {ms * 1e3:.2f} us (bound {bound_ms * 1e3:.2f} "
              f"us for {nbytes / 1e6:.2f} MB, plain {plain_ms * 1e3:.2f} us),"
              f" max_abs_err {err}")

    # ----------------------------------------- K1 fused_variation check --
    gen = make_generator(1, dev)
    plan = variation.resolve_plan(_onemax_toolbox(Toolbox, ops))
    src = torch.randint(0, N, (N,), generator=gen, device=dev,
                        dtype=torch.int32)
    partner = src[variation.pair_partner_positions(N, dev).long()]
    worst = 0.0
    for dtype, kind in ((torch.bool, "flip"), (torch.float32, "add"),
                        (torch.float32, "set")):
        g = (torch.rand((N, L), generator=gen, device=dev) < 0.5).to(dtype)
        cx_row, lo, hi, do_mut, mask, _ = variation.var_and_masks(
            gen, N, L, CXPB, MUTPB, plan, dtype)
        arg = None if kind == "flip" else torch.randn(
            (N, L), generator=gen, device=dev)
        args = (g, src, partner, cx_row, lo, hi, do_mut, mask, arg)
        got = kernels.fused_variation(*args, mut_kind=kind)
        want = variation.apply_variation(*args, kind).to(dtype)
        torch.cuda.synchronize()
        if not bitwise_equal(got, want):
            fail(f"fused_variation[{dtype}, {kind}] differs from "
                 f"apply_variation")
        err = max_abs_err(got, want)
        worst = max(worst, err)
        print(f"{tag} fused_variation[{dtype}, {kind}] == apply_variation "
              f"bitwise at n={N}, L={L}")
        if kind == "flip":  # the main path's case is the one timed
            ms = time_ms(lambda: kernels.fused_variation(*args, mut_kind=kind),
                         flush)
            plain_ms = time_ms(lambda: variation.apply_variation(*args, kind),
                               flush)
            # what these masks need: genomes in and children out once,
            # the gene mask of mutating rows, src/cx/mut of every row and
            # partner/lo/hi of mating rows
            n_mut, n_cx = int(do_mut.sum()), int(cx_row.sum())
            nbytes = (2 * N * L * g.element_size() + n_mut * L + 6 * N
                      + 12 * n_cx)
            main_k1 = (ms, plain_ms, nbytes)
    record("k1", "fused_variation", "deap_tpu_torch/csrc/fused_variation.cu",
           "deap_tpu/ops/kernels.py:439", worst, *main_k1)

    # ------------------------------ K3 fused_variation_eval_packed check --
    W = packed.words_for(L)
    pk = packed.pack_genomes(torch.rand((N, L), generator=gen, device=dev)
                             < 0.5)
    bits = packed.variation_bits(gen, N, W)
    probs = dict(cxpb=CXPB, mutpb=MUTPB, indpb=INDPB)
    got = packed.fused_variation_eval_packed(pk, L, *bits, **probs)
    want = packed.fused_variation_eval_packed_plain(pk, L, *bits, **probs)
    torch.cuda.synchronize()
    for a, b, what in zip(got, want, ("children", "fitness")):
        if not bitwise_equal(a, b):
            fail(f"fused_variation_eval_packed {what} differ from the plain "
                 f"version")
    print(f"{tag} fused_variation_eval_packed == plain bitwise at n={N}, "
          f"W={W}")
    err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
    pairu = kernels._u01(kernels._words(bits[0][0::2]))
    n_cx = int((pairu[: N // 2, 0] < kernels._f32(CXPB)).sum())
    n_mut = int((kernels._u01(kernels._words(bits[1]))[:, 0]
                 < kernels._f32(MUTPB)).sum())
    # what this run's draws need: rows in and out, fitness out, pair word 0
    # of every pair and words 1-2 of mating pairs, row bits, gene bits of
    # mutating rows
    nbytes = (2 * N * W * 4 + N * 4 + (N // 2) * 4 + n_cx * 8 + N * 4
              + n_mut * 32 * W * 4)
    record("k3", "fused_variation_eval_packed",
           "deap_tpu_torch/csrc/packed_variation.cu",
           "deap_tpu/ops/packed.py:264", err,
           time_ms(lambda: packed.fused_variation_eval_packed(pk, L, *bits,
                                                              **probs), flush),
           time_ms(lambda: packed.fused_variation_eval_packed_plain(
               pk, L, *bits, **probs), flush), nbytes)
    print(f"  (of {N} rows {n_mut} mutate, of {N // 2} pairs {n_cx} mate)")

    # ----------------------------- K4 sel_tournament_gather_packed check --
    fit = packed.packed_fitness(pk)
    draws = packed.tournament_bits(gen, TOURNSIZE, N)
    got = packed.sel_tournament_gather_packed(pk, fit, draws)
    want = packed.sel_tournament_gather_packed_plain(pk, fit, draws)
    torch.cuda.synchronize()
    if not bitwise_equal(got, want):
        fail("sel_tournament_gather_packed differs from the plain version")
    print(f"{tag} sel_tournament_gather_packed == plain bitwise at n={N}, "
          f"tournsize={TOURNSIZE}")
    nbytes = 4 * (TOURNSIZE * N + N + 2 * N * W)
    record("k4", "sel_tournament_gather_packed",
           "deap_tpu_torch/csrc/selgather_packed.cu",
           "deap_tpu/ops/packed.py:599", max_abs_err(got, want),
           time_ms(lambda: packed.sel_tournament_gather_packed(pk, fit, draws),
                   flush),
           time_ms(lambda: packed.sel_tournament_gather_packed_plain(
               pk, fit, draws), flush), nbytes)
    del flush

    # -------------------------------------------------- ea_simple OneMax --
    tb = _onemax_toolbox(Toolbox, ops)
    spec = FitnessSpec((1.0,))

    def onemax_run(seed, n, ngen, fused):
        g = make_generator(seed, dev)
        pop = init_population(g, n, ops.bernoulli_genome(L), spec, device=dev)
        return algorithms.ea_simple(g, pop, tb, CXPB, MUTPB, ngen,
                                    stats=fitness_stats(), halloffame_size=1,
                                    fused=fused, device=dev)

    # small reference: the kernel path equals the unfused composition
    small = [onemax_run(7, 1001, 5, fused) for fused in ("auto", False)]
    if not (torch.equal(small[0][0].genomes, small[1][0].genomes)
            and list(small[0][1]) == list(small[1][1])):
        fail("ea_simple through the kernel differs from the unfused run")
    print(f"{tag} ea_simple(n=1001, 5 gens) through fused_variation == "
          f"unfused composition bitwise")

    kernels.fused_variation.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pop, logbook, hof = onemax_run(0, N, EA_NGEN, "auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    report["k1"]["launches"] = kernels.fused_variation.launches
    if kernels.fused_variation.launches != EA_NGEN:
        fail(f"fused_variation launched {kernels.fused_variation.launches} "
             f"times in {EA_NGEN} generations")
    maxes = logbook.select("max")
    if any(b < a for a, b in zip(maxes, maxes[1:])):
        fail(f"logbook max fell: {maxes}")
    if not (pop.fitness.shape == (N, 1) and bool(pop.valid.all())
            and bool(torch.isfinite(pop.fitness).all())
            and torch.equal(pop.fitness[:, 0],
                            pop.genomes.sum(-1).to(torch.float32))
            and float(hof.fitness[0, 0]) == maxes[-1]):
        fail("ea_simple's population, fitness or hall of fame is wrong")
    print(f"{tag} ea_simple OneMax n={N} L={L}: {EA_NGEN} generations in "
          f"{wall:.3f} s incl. gen-0 evaluation = {EA_NGEN / wall:.2f} "
          f"gens/s; max {maxes[0]} -> {maxes[-1]}, avg "
          f"{logbook[0]['avg']:.3f} -> {logbook[-1]['avg']:.3f}; "
          f"fused_variation launches {kernels.fused_variation.launches}")

    # -------------------------------------------- packed generation step --
    def packed_start(seed, n):
        g = make_generator(seed, dev)
        pk = packed.pack_genomes(ops.bernoulli_genome(L)(g, n))
        return g, pk, packed.packed_fitness(pk)

    # small reference: three generations equal the plain versions in turn
    g, pk, fit = packed_start(3, 1001)
    got = algorithms.ea_simple_packed(g, pk, fit, L, 3, **probs, device=dev)
    g, want_pk, want_fit = packed_start(3, 1001)
    for _ in range(3):
        parents = packed.sel_tournament_gather_packed_plain(
            want_pk, want_fit, packed.tournament_bits(g, TOURNSIZE, 1001))
        want_pk, want_fit = packed.fused_variation_eval_packed_plain(
            parents, L, *packed.variation_bits(g, 1001, W), **probs)
    if not (bitwise_equal(got[0], want_pk) and bitwise_equal(got[1],
                                                            want_fit)):
        fail("ea_simple_packed through the kernels differs from the plain "
             "versions")
    print(f"{tag} ea_simple_packed(n=1001, 3 gens) through the kernels == "
          f"plain versions bitwise")

    for select in ("gather", "sorted"):
        g, pk, fit = packed_start(5, N)
        start_mean = float(fit.mean())
        packed.fused_variation_eval_packed.launches = 0
        packed.sel_tournament_gather_packed.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pk, fit = algorithms.ea_simple_packed(
            g, pk, fit, L, PACKED_NGEN, tournsize=TOURNSIZE, select=select,
            **probs, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k3 = packed.fused_variation_eval_packed.launches
        k4 = packed.sel_tournament_gather_packed.launches
        want_k4 = PACKED_NGEN if select == "gather" else 0
        if k3 != PACKED_NGEN or k4 != want_k4:
            fail(f"select={select}: launches K3 {k3}, K4 {k4} in "
                 f"{PACKED_NGEN} generations")
        if not (torch.equal(fit, packed.packed_fitness(pk))
                and bool(torch.isfinite(fit).all())
                and float(fit.mean()) > start_mean):
            fail(f"select={select}: packed run's fitness is wrong")
        if select == "gather":
            report["k3"]["launches"] = k3
            report["k4"]["launches"] = k4
        print(f"{tag} ea_simple_packed select={select} n={N}: {PACKED_NGEN} "
              f"generations in {wall:.3f} s = {PACKED_NGEN / wall:.2f} "
              f"gens/s; mean fitness {start_mean:.3f} -> "
              f"{float(fit.mean()):.3f}; launches K3 {k3}, K4 {k4}")

    print(json.dumps({"kernels": [report[k] for k in ("k1", "k3", "k4")]}))
    print(facts)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _onemax_toolbox(Toolbox, ops):
    import torch
    tb = Toolbox()
    tb.register("evaluate", lambda g: g.sum(-1).to(torch.float32))
    tb.register("mate", ops.cx_two_point)
    tb.register("mutate", ops.mut_flip_bit, indpb=INDPB)
    tb.register("select", ops.sel_tournament, tournsize=TOURNSIZE)
    return tb


if __name__ == "__main__":
    sys.exit(main())
