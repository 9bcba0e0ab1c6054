#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure ends the script with a non-zero exit code):

1. build every kernel of ``deap_tpu_torch/csrc`` with ``nvcc`` (one
   process per source, all started together);
2. hold K1, K3 and K4 against their plain PyTorch versions on the card at
   the main path's shapes (pop 100,000, L 100, 4 words) — bitwise — and
   time both with CUDA events, the L2 cache flushed before every launch
   (K1 in each of its kinds beside a torch copy of its output, K3 beside a
   torch copy of its genomes, K4 beside a torch copy of its output), then
   K1 at 708 more shapes (``k1_sweep``:
   L 1, 3, 4, 5, 100 and 101, n 1, 33 and 1001 with N below, above and
   equal, empty and whole segments, cxpb and mutpb at 0 and 1, genomes off
   their unit's alignment, every kind in both dtypes; and ``var_or``'s
   shapes, ``k1_var_or_shapes``: λ 1-100k children of N 2-100k rows, bool
   ``flip``, float32 ``add`` and ``set``) and K3 at 168 more
   (``k3_sweep``: n 1, 2, 255, 256, 257 off 16-byte alignment and 1001 by
   L 1-300, cxpb and mutpb at 0 and 1);
3. ``ea_simple`` OneMax (pop 100k, L 100, cxpb 0.5, mutpb 0.2, indpb 0.05,
   tournament 3, hall of fame 1, fitness statistics) for 20 generations,
   after a small run that must equal the unfused composition bit for bit;
4. the packed generation (tournament select-and-gather kernel, then the
   packed variation kernel) for 200 generations at pop 100k, after a
   small run that must equal the plain versions bit for bit, and the same
   step with the rank-based tournament;
5. K2 on byte genomes: bitwise against its plain version at pop 100k and
   L 100 (and in float32 at a small odd n), both through its vector
   variant, and at L 33 (bool and float32) through its scalar one, then ``bench.py``'s fused OneMax loop (tournament, row
   gather, K2) for 200 generations at pop 100k, every launch the vector
   variant, after a 5-generation run at n 1001 that must equal the plain
   versions bit for bit;
6. K5, the resident whole-GA loop: bitwise against its plain version for
   5 generations at pop 100k and at a small odd n and at 109 more shapes
   (``k5_sweep``: n 1, 2, 255, 257, 1000 with its gene planes off 16-byte
   alignment, 1001, and 300,001, past one resident wave of tiles, by L
   1-300, tournaments of 1-9, 1-3 generations, cxpb and mutpb at 0 and 1),
   timed beside its bound, its sector floor (the 32-byte sectors its
   draws must fetch) and a read-only torch pass over a call's draws, then
   200 generations at pop 100k in 4 calls of 50;
7. K6 on the continuous GA (``bench_suite.py``'s rastrigin_n30_pop100k:
   blend α 0.5, Gaussian σ 0.3 and indpb 0.1, cxpb 0.5, mutpb 0.2):
   against its plain version at pop 100k and L 30 (decisions and crossed
   genes exact, mutated genes and fitness at the stated tolerances), timed
   beside a torch copy of its genomes, then at 365 more shapes on
   ``real_bits`` streams (``k6_sweep``: n 1-1001 across its tiles of 16
   rows by L 1-100, and n 100k at L 30, each with the rates at 0 and 1), the
   fused Rastrigin loop for 50 generations and unfused ``ea_simple``
   (``cx_blend``, ``mut_gaussian``, ``sel_tournament``) for 10;
8. the ``prng='hw'`` paths of K2-K5, Philox4x32-10 in the kernel
   (``csrc/philox.cuh``): the device function against Random123's known
   answers and the plain ``ops.philox.philox4x32_10`` (in each library
   that includes it, K6's too); each path bitwise
   against its plain version on ``ops.philox``'s streams (K2 bool and
   float32 at L 33 and 100, n 100k and 1001, and the vector variant's
   edges, L 4, 200, 300 and 1000, n 1, 3 and odd; K3 at n 1, 3, 255,
   257, 1001 and 100k by L 2, 31, 33, 100, 257 and 300, and with mutpb 0
   and 1, timed at n 100k beside a torch copy of the same genomes; K4-hw
   and K4's bits body at n 1, 3, 257 and 1001 by L 2, 31, 33, 100, 257
   and 300 (tournament 1, 3, 4, 5 and 9) and at n 100k, K4-hw timed at
   n 100k beside a torch copy of its output, ``torch.index_select`` of its
   winners and its own time without the flush;
   K5 5 generations at n 1, 3, 1001 and 100k, L 33, 70 and 100,
   tournament 3 and 5, and one 50-generation call at n 100k), the
   layout's invariants (K3-hw == packed K2-hw; one K5-hw generation ==
   K4-hw then K3-hw), one key twice equal and two keys different; K5-hw's
   grid and its grid barrier's cost a generation; the fused OneMax loop,
   ``ea_simple_packed`` (``gather``, ``sorted``, ``binned``) and
   ``evolve_packed`` (200 generations in 4 calls) with ``prng='hw'`` and
   ``'auto'``, each Philox launch counted; peak memory of a 50-generation
   ``evolve_packed`` call, ``'input'`` against ``'hw'``; ``'hw'`` against
   ``'input'`` in distribution (4 seeds, 20 generations, final best and
   average fitness within 3 standard errors); ``counting_order_desc``
   (``'scan'`` and ``'mxu'``) against ``lex_sort_desc``;
9. the dominance kernels K7 and K8 against their plain versions on
   3-objective DTLZ2 data at the NSGA-II path's shapes (100k rows; K8
   as the prefix chain reduction calls it, 512 queries against the 50k
   ranked rows before them): bitwise where the sums are exact, K7's
   SPEA2 raw sums within ``kernels.K7_RTOL`` and equal from launch to
   launch, timed against the card's compare rate over the pairs each
   compares (K7 also at 50k rows, the DCD sort's size); K8 at 107 more
   shapes (``k8_sweep``: n 1-100k, nq 1-2048, m 1, 2, 3, 8, 9 and 32,
   NaN, -inf and duplicated rows, ties, all-zero weights) and timed over
   the 31 cross steps of one ``nd='dc'`` selection at 16,384 rows, the
   sum of each launch's time;
10. the non-dominated sorting engines agree on the card at n 8192
    (tiled, matrix, sweep, dc through K8; staircase and tiled at M 2),
    and ``sel_nsga2`` through K8 (``nd='dc'``) equals it through K7 on a
    16,384-row union;
11. NSGA-II on 3-objective DTLZ2 (``bench.py``'s generation: DCD mating
    selection, Gaussian variation clipped to [0, 1], evaluation,
    ``sel_nsga2`` over the union): a small run whose survivors through
    K7 equal those through the dominance matrix, then mu 50,000 (union
    100k, 12 variables) for 3 generations after one of warm-up, with K7
    launched once per front peeled;
11b. J3 and J4, the row passes of the M = 2 staircase and the M = 3
    sweep (``csrc/nd_scan.cu``, both in chunks of 32 rows): each bitwise
    against its plain version at n 1-1000 on uniform rows, ties, ``-inf``
    rows, NaN rows, duplicates, one front and a chain, and on a chain of
    100,000 rows (as many fronts as rows); J3 with its front maxima forced
    across the edge of shared memory and on chains of 58,112 and 58,113
    rows; J3 timed on ZDT1 values at the 50k run's 50k and 100k rows (and
    with every front maximum in device memory), J4 on DTLZ2 unions of
    16,384 and 100k rows (where its ranks equal ``nd='tiled'``'s), each
    beside its bound, its plain version and its chunk floor (J3 on one
    front: no chain; J4 on copies of one row: no gather, no chain), and
    the whole ``nd_rank`` through J4 (``impl='sweep'``) against K7's
    (``impl='tiled'``) on those unions, host clock, tables included;
    bench.py's NSGA-II DTLZ2 generation at mu 50k with ``nd='sweep'`` (J4
    launched once, the survivors equal K7's); then bench_suite.py's two
    ZDT1 NSGA-II configurations as it calls them (30 genes, bounded SBX
    and polynomial mutation at eta 20, cxpb 0.9, mutpb 1.0, DCD, then
    ``sel_nsga2`` over the union): ``nsga2_zdt1_pop2000`` (``nd='standard'``,
    50 generations, J3 launched 0 times: ``auto`` takes the dominance
    matrix at 2000 and 4000 rows) and ``nsga2_zdt1_pop50k``
    (``nd='staircase'``, 10 generations after one of warm-up, J3 launched
    twice a generation; the last union's ranks equal the plain version's
    and ``nd='tiled'``'s), each gaining hypervolume (the native library,
    which must have built), and one more 50k generation in its parts;
12. K9, the GP grouped evaluator: bitwise against its plain version on
    the grouped schedule of a ``gen_half_and_half`` population under
    ``math_set(1)`` (pop 4096, width 64, 256 points, deduped as the loop
    builds it) and on a small odd case, then ``bench_gp.py``'s symbolic
    regression (the quartic on 256 points, pop 4096, width 64, cxpb 0.5,
    mutpb 0.1) for 50 generations: best MSE at most 0.05, K9 launched
    once per evaluation and its levels counted (= the evaluated trees'
    heights), after a 5-generation run at pop 256 that must equal the
    same run through the plain version bit for bit;
12b. the rest of GP: K9 with ``lt``/``eq`` live on the typed spambase
    population (``spam_set(57)``, pop 4096, width 64, on 4601 rows made
    by ``examples/gp/spambase.py``'s ``make_dataset`` rule, and on
    integer rows with NaN and infinity) and ``lf`` live on semantic
    mutants, bitwise against its plain version;
    ``examples/gp/spambase.py``'s typed program (tournament 3, cxpb 0.5,
    mutpb 0.2) at pop 4096 through K9, 10 generations, one launch an
    evaluation; J2 (``ant_rollout``, a walk without a stack) bitwise
    against its plain version on the card, a CPU run of the plain version
    and the native simulator (eaten and steps) on 4096 trees of width 80
    (half crossover children), on 4096 trees whose root never closes or
    of random ids (its stack walk; no native simulator), at step bounds
    inside the prog runs it folds and on Koza's solution (89 eaten), its
    table against
    ``ant_walk_table`` and its iterations against ``ant_walk_replay``,
    ``ptxas`` showing no local memory; ``examples/gp/ant.py``'s program
    (543 moves, static limit 17, tournament 7) at pop 4096 through J2, 10
    generations, one launch an evaluation; J2 on the evolved population
    as on the first trees; J2 timed on both beside its bound, its plain
    version, the native simulator's host time and its chain floor (the
    longest ant's iterations times one dependent shared-memory load,
    clocked by a pointer chase on the card); then ADF symbolic
    regression (``adf_symbreg.py``, pop 200), HARM (``symbreg_harm.py``,
    pop 300, 600 trial children, through K9) and the semantic operators
    with ``lf`` through K9 (pop 256), a few generations each;
13. K6's Philox path (``prng='hw'``, ``bench_suite.py``'s call): against
    its plain version on ``ops.philox.hw_real_bits``' streams at pop 100k
    and at n 1001 (crossed genes bitwise, mutated genes and fitness at
    K6's tolerances) and bitwise against K6's bits body on the same
    streams, one key twice equal and two keys different, timed beside its
    bound from the Philox calls and bytes it needs and a torch copy of
    its genomes; the same checks at n 1, 2, 3, 63, 64, 65, 127, 129, 257
    and 1001 by L 1, 4, 30, 31, 33, 64 and 100, with each probability at 0
    and 1, with no evaluation in the kernel, and at n 100k by L 4, 33 and
    100; the fused
    Rastrigin loop with ``'hw'`` and ``'auto'`` for 50 generations (K6
    launches = Philox launches = 50); the peak memory of one generation
    in each mode; ``'hw'`` against ``'input'`` in distribution (4 seeds, 20
    generations, final best and average within 3 standard errors);
14. ``bench_suite.py``'s cmaes_n100_lam4096 (Hansen CMA-ES on sphere, dim
    100, lambda 4096, sigma 0.5 from 5.0): 50 generations through
    ``ea_generate_update`` (hall of fame 1, fitness statistics) and as the
    bare generate / evaluate / update loop, gens/s of both, the best
    falling, C finite and symmetric, its eigendecomposition reconstructing
    it within 1e-3; one update on the card against the same update on
    the CPU at ``strategies.cma``'s stated tolerances;
15. ``var_or`` through K1 and the (μ + λ) / (μ, λ) loops: K1 on
    ``var_or_masks`` (λ children read from N rows, partners drawn apart,
    crossover and mutation rows exclusive) at ``k1_var_or_shapes``,
    bitwise against its plain version, timed at λ 100k from N 20k and
    from N 100k; ``ea_mu_plus_lambda`` OneMax (``bench.py``'s operators,
    μ = λ = 100,000, L 100, cxpb 0.5, mutpb 0.2, fitness statistics, hall
    of fame 1) and ``ea_mu_comma_lambda`` (μ 20,000, λ 100,000) for 20
    generations each with ``fused='kernel'``, ``'plain'`` and ``False``
    from one seed, after one generation of warm-up: populations, halls of
    fame and logbooks bitwise equal across the three, K1 launched 20
    times in the kernel run and never in the others; the reference's
    ``examples/es/fctmin.py`` ((μ, λ) ES, μ 10, λ 100, 30 genes, 100
    generations: best below gen 0's) and ``examples/ga/kursawefct.py``
    ((μ + λ) NSGA-II on Kursawe, n 100, 50 generations: its non-dominated
    count);
16. the CMA-ES family: J1, the Jacobi eigensolver (``eigh_jacobi``),
    bitwise against its plain version at d 2-192 (an odd d's bye, the
    shared-memory limit at 170, device memory above) by batch 1 and 3
    and at the serving buckets [1024, 10] and [256, 30], on random SPD
    matrices, the identity, a repeated diagonal, an off-diagonal below
    float32's tiny and CMA-ES's own covariance, timed at d 100 and on the
    buckets beside ``torch.linalg.eigh`` and the plain version;
    cmaes_n100_lam4096 with ``eigh_impl='lapack'`` and ``'jacobi'`` in
    one call (50 generations through ``ea_generate_update`` and the bare
    loop each, the gates of phase 14, J1 launched once a generation and
    once for ``initial_state``, one ``'jacobi'`` update on the card
    against the CPU's); the (1+λ)-CMA-ES on sphere (N 5, λ 8, 300
    generations, best below 1e-6), MO-CMA-ES on ZDT1 (µ = λ = 16, 5
    genes, 500 generations, hypervolume of [11, 11] above 116; then µ =
    λ = 100, 30 genes, timed) and BIPOP-CMA-ES on sphere (dim 5, 2
    restarts, best below 1e-8);
17. the rest of the strategies and NSGA-III / dense SPEA2: the JAX
    package's gates at its test sizes (DE on sphere, n 300, 10 genes, 200
    generations, best below 1e-2 and a monotone trajectory; PSO on h1, 20
    particles, 1000 generations, above 1.6, monotone; PBIL on 50-bit
    OneMax, λ 20, 50 generations, hall of fame at least 45; EMNA on
    sphere, N 30, λ 1000, 150 generations, below 1e-3; multi-swarm and
    speciation PSO on two peaks, above 9, speciation also a particle
    within 1.5 of the second peak; NSGA-III on ZDT1, µ 16, 5 genes, 100
    generations, 13 reference points, hypervolume of [11, 11] above
    116), the reference examples at their sizes timed (``examples/pso/multiswarm.py``,
    ``examples/pso/speciation.py``, ``examples/de/dynamic.py``,
    ``examples/ga/nsga3.py``), then the full widths: NSGA-III on DTLZ2 at
    mu 50,000 (union 100k, 12 variables, 91 reference points, NSGA-II's
    variation) for 3 generations after one of warm-up with K7 launched
    once per front peeled, K7's device time and the niching loop's host
    time, then one selection on a converged union (one front, n_fill =
    mu) with its peak memory; DE and PSO on Rastrigin at pop 100k, 30 genes, 20
    generations after 2; dense ``sel_spea2`` on an over-full ZDT1 union of
    2,000 rows to 1,000;
18. the cart-pole neuroevolution (``bench_suite.py``'s
    cartpole_neuro_pop10k) through J5, ``csrc/cartpole_rollout.cu``, a
    thread an episode: J5's sinf, cosf and saturated tanhf bitwise
    against torch's on the card; J5 bitwise against its plain version on
    a balancing genome (every episode at the 500-step cap), NaN and
    infinite genes and 45 shapes (P 1-10,000 by E 1, 3, 5 by max_steps 10,
    200, 500); the configuration as bench_suite.py calls it (pop 10k,
    ``mlp_policy((4, 16, 2))`` genomes N(0, 0.5^2), the mean return over
    3 fixed episode starts of up to 500 steps, blend and Gaussian
    variation, tournaments of 3, on the one-device mesh) for 20
    generations, J5 launched 21 times and K1 never, best and mean fitness
    higher than at gen 0; J5 bitwise on its gen-0 and last populations,
    timed on both beside its bound, its plain version and its chain floor
    (the longest episode's steps times one thread's clocks a step); then
    ``var_and(fused='auto')`` with ``mut_uniform_int`` through K1's set
    kind, bitwise against the unfused composition.
19. resilience (``deap_tpu_torch.resilience``): phase 3's OneMax
    ``ea_simple`` (pop 100k, L 100) for 20 generations, then the same run
    through ``ResilientRun`` in segments of 5, synchronous and
    double-buffered, each bitwise equal to it (population, fitness,
    logbook, hall of fame) with K1 launched 20 times; the checkpoint's
    bytes, save (synchronous, double-buffered) and restore seconds and the
    segmented runs' ms/gen beside the uninterrupted run's, also over 60
    generations in segments of 20; a child process
    on the same run (``--resilience-child``) SIGKILLed once its journal
    shows generation 10 checkpointed, its newest file corrupted with
    ``corrupt_file``, and a second child that falls back one file to
    generation 5, launches K1 15 times, and writes its result, which must
    equal the uninterrupted run bitwise (the time from its start to its
    first resumed segment printed); GP symbreg (pop 4096, K9) preempted by
    a real SIGTERM at generation 10 of 20 and resumed, bitwise against the
    uninterrupted run, K9 launched once an evaluation of the generations
    left; CMA-ES (dim 100, lambda 4096, ``eigh_impl='jacobi'``) for 12
    generations in segments of 4, bitwise, J1 launched 12 times.
20. telemetry (``deap_tpu_torch.telemetry``): phase 3's OneMax
    ``ea_simple`` (pop 100k, L 100, K1) for 20 generations bare and with
    ``RunTelemetry`` (``DiversityProbe``, ``FitnessProbe``,
    ``SelectionProbe``, a ``HealthMonitor``), bitwise equal (population,
    logbook, hall of fame, generator), a ``meter`` row a generation and
    gen 0's, ms/gen of both and the tax; the bare and telemetered
    generation steps under ``torch.cuda.set_sync_debug_mode("error")``
    (where the bare one synchronises, the call is printed and the meter's
    host copies counted: one); GP symbreg (pop 4096, K9) under
    ``TreeDiversityProbe``, ``'jacobi'`` CMA-ES (dim 100, lambda 4096,
    J1) under ``strategy_probe`` for 10 generations each, and a
    ``sel_nsga2`` (mu + lambda) run on 3-objective DTLZ2 (mu 50k, K7)
    under ``FrontProbe`` for 3, each bitwise equal to its bare run with a
    journal that ``read_journal(strict=True)`` parses; ``ResilientRun``
    with ``telemetry=``, ``metrics=`` and ``trace_every=2`` on the OneMax
    run (segments of 5) inside a ``ProgramObservatory``: bitwise equal to
    the bare run, its ``flight_trace`` files on disk, one
    ``program_profile`` for its label with K1's device microseconds, and
    a second segment length (a second signature) with no drift alarm.

Every launch counter is set to 0 just before a main-path run and read
just after it. The last lines are one JSON object with each kernel's
numbers, the card's name and power limit from ``nvidia-smi``, and the
result line ``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import math
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

N, L, TOURNSIZE = 100_000, 100, 3
CXPB, MUTPB, INDPB = 0.5, 0.2, 0.05
EA_NGEN, PACKED_NGEN = 20, 200
# bench.py's NSGA-II headline: mu 50k on 3-objective DTLZ2, 12 variables
MO_POP, MO_NOBJ, MO_DIM, MO_NGEN = 50_000, 3, 12, 3
ENGINE_N, DC_UNION, MO_SMALL = 8192, 16_384, 2048
# bench.py's fused and whole-GA candidates: 200 generations; K5 takes them
# in calls of 50
FUSED_NGEN, EVOLVE_NGEN, EVOLVE_CALL = 200, 200, 50
# K5 at more children than the card holds in one resident wave of tiles
K5_WAVE = 300_001
# bench_suite.py's continuous GA, rastrigin_n30_pop100k (NGEN 50)
RA_N, RA_DIM, RA_NGEN, RA_UNFUSED_NGEN = 100_000, 30, 50, 10
RA_CXPB, RA_MUTPB, RA_INDPB, RA_ALPHA, RA_SIGMA = 0.5, 0.2, 0.1, 0.5, 0.3
RA_LOW, RA_UP = -5.12, 5.12
# bench_gp.py's GP symbolic regression: the quartic on 256 points, pop
# 4096, genome width 64, 50 generations, gate best MSE <= 0.05 (MSE_GATE)
GP_POP, GP_ML, GP_P, GP_NGEN, GP_CXPB, GP_MUTPB = 4096, 64, 256, 50, 0.5, 0.1
GP_MSE_GATE, GP_SMALL_POP, GP_SMALL_NGEN = 0.05, 256, 5
# the rest of GP at full width: examples/gp/spambase.py's typed program
# (spam_set, make_generator_typed(1, 4), typed one-point crossover and
# node replacement, tournament 3, cxpb 0.5, mutpb 0.2) at bench_gp.py's
# pop 4096 and width 64 on the UCI spambase's shape (57 features, 4601
# rows, made by make_dataset's rule), and examples/gp/ant.py's program
# (gen_half_and_half(1, 4), one-point crossover and mut_uniform under
# static_limit(17), tournament 7) at pop 4096, width 80, 543 moves; 10
# generations each
SPAM_FEATURES, SPAM_ROWS, SPAM_POP, SPAM_ML, SPAM_NGEN = 57, 4601, 4096, 64, 10
ANT_POP, ANT_ML, ANT_MOVES, ANT_NGEN = 4096, 80, 543, 10
# the integer operations a rollout step needs at least (the stack read,
# the node load, its test and the stack pointer, then an operator's end
# load and push or an action's move count and turn or step): J2's bound
# counts them at the card's 64 integer operations a clock an SM
J2_STEP_OPS = 8
# J2's stack walk on trees that are not complete runs at this step bound
# (random trees may loop without an action up to it); the step bounds
# that fall inside the smoke's trees' folded prog runs; the ants whose
# iterations the Python replay checks (the longest walks and the first)
J2_STACK_STEPS, J2_CUT_STEPS, J2_REPLAY = 3000, (1, 2, 3, 4, 5, 7, 9, 17,
                                                 100), 16
# the examples' own sizes, a few generations each: adf_symbreg.py (pop
# 200), symbreg_harm.py (pop 300, 600 trial children), and the semantic
# operators on math_set(1) plus lf (pop 256, programs up to 128 nodes)
ADF_POP, ADF_NGEN = 200, 3
HARM_POP, HARM_NBR, HARM_NGEN = 300, 600, 5
SEM_POP, SEM_ML, SEM_NGEN = 256, 128, 3
# measuring kernels that the script builds beside ``_build.SOURCES``
# (no path of the port runs them): J2's chain floor's shared-memory load
PROBE_SOURCES = ("shared_chase",)
# Koza's hand solution of the Santa Fe trail: 89 pieces in 543 moves
KOZA_SOLUTION = (
    "if_food_ahead(move_forward, prog3(turn_left, "
    "prog2(if_food_ahead(move_forward, turn_right), "
    "prog2(turn_right, prog2(turn_left, turn_right))), "
    "prog2(if_food_ahead(move_forward, turn_left), move_forward)))")
# device memory rates by card name (NVIDIA data sheets), bytes per second
MEMORY_RATES = (("H200", 4.8e12), ("H100 PCIe", 2.0e12), ("H100", 3.35e12))
# float32 compares issued per SM per clock (4 schedulers x 32 lanes)
COMPARES_PER_SM_CLOCK = 128
# 32-bit integer multiply-adds per SM per clock on compute capability 9.0
# (CUDA C Programming Guide, arithmetic instruction throughput), and the
# integer multiplies of one Philox4x32-10 call (10 rounds x 2 products x
# hi and lo halves)
IMADS_PER_SM_CLOCK, PHILOX_IMADS = 64, 40
# Random123's known answers for Philox4x32-10: (counter, key, output)
PHILOX_KAT = (
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)))
# the libraries whose kernels draw with Philox (each carries the device
# function and its known-answer entry)
PHILOX_LIBRARIES = ("fused_variation_eval", "packed_variation",
                    "selgather_packed", "evolve_packed",
                    "fused_variation_real")
# seeds and generations of the in-distribution check of 'hw' against
# 'input'
DIST_SEEDS, DIST_NGEN = 4, 20
# bench_suite.py's cmaes_n100_lam4096: Hansen CMA-ES on sphere, dim 100,
# lambda 4096, centroid 5.0, sigma 0.5, 50 generations (NGEN)
CMA_DIM, CMA_LAMBDA, CMA_START, CMA_SIGMA, CMA_NGEN = 100, 4096, 5.0, 0.5, 50
# J1, the Jacobi eigensolver: d at every edge of its design (an odd d's
# bye; two 2x2 blocks a pass thread from 11; a second V warp at 35, the
# twelfth at 96; two SMs a matrix from 39 (linalg.J1_SPLIT_MIN_D); a
# second and third pivot warp at 65 and 129; the shared-memory limit at
# 169 and 170, one ring slot at 170; device memory above) by batches of 1
# and 3, the d of the split range also by one matrix more than half the
# SMs (one SM a matrix, j1_shapes), and the batched shapes of a CMA
# serving bucket
J1_DIMS = (2, 3, 5, 8, 9, 11, 16, 31, 32, 33, 35, 38, 39, 40, 64, 65, 96,
           100, 127, 128, 129, 169, 170, 171, 192)
J1_BATCHES, J1_BUCKETS = (1, 3), ((1024, 10), (256, 30))
# the shapes of J1's phase clock (port_profile.J1_SHAPES' names)
J1_PHASE_SHAPES = ("j1", "j1_1024x10", "j1_256x30")
# float32 operations an SM issues per clock, a fused multiply-add counted
# as two (the data sheet's 67 TFLOP/s at 132 SMs and 1980 MHz)
FP32_FLOPS_PER_SM_CLOCK = 256
# the JAX package's quality gates of the (1+lambda), MO-CMA-ES and BIPOP
# examples (tests/test_strategies.py, tests/test_multiswarm_bipop.py):
# (1+lambda) on sphere, N 5, lambda 8, 300 generations, best < 1e-6;
# MO-CMA-ES on ZDT1, mu = lambda = 16, 5 genes, 500 generations,
# hypervolume of ref [11, 11] > 116; BIPOP on sphere, dim 5, 2 restarts,
# best < 1e-8; and MO-CMA-ES at examples/es/cma_mo.py's width (mu = lambda
# = 100, 30 genes), timed
OPL_DIM, OPL_LAMBDA, OPL_NGEN, OPL_GATE = 5, 8, 300, 1e-6
MOC_MU, MOC_DIM, MOC_NGEN, MOC_HV_GATE = 16, 5, 500, 116.0
MOC_WIDE_MU, MOC_WIDE_DIM, MOC_WIDE_NGEN = 100, 30, 30
BIPOP_DIM, BIPOP_RESTARTS, BIPOP_GATE = 5, 2, 1e-8
# var_or's loops at the main path's width (bench.py's OneMax operators):
# (mu + lambda) with mu = lambda = N, (mu, lambda) with mu 20k, lambda N
MU_COMMA, MU_NGEN = 20_000, 20
# examples/es/fctmin.py and examples/ga/kursawefct.py
FCT_MU, FCT_LAMBDA, FCT_DIM, FCT_NGEN, FCT_MIN_STRATEGY = 10, 100, 30, 100, 0.5
KUR_N, KUR_NGEN = 100, 50
# the JAX package's gates of the rest of the strategies and of NSGA-III
# (tests/test_strategies.py, tests/test_multiswarm_bipop.py,
# tests/test_mo.py): DE on sphere, PSO on h1, PBIL on OneMax, EMNA on
# sphere, multi-swarm and speciation PSO on two peaks, NSGA-III on ZDT1
DE_N, DE_DIM, DE_NGEN, DE_GATE = 300, 10, 200, 1e-2
PSO_N, PSO_NGEN, PSO_GATE = 20, 1000, 1.6
PBIL_DIM, PBIL_LAMBDA, PBIL_NGEN, PBIL_GATE = 50, 20, 50, 45.0
EMNA_DIM, EMNA_LAMBDA, EMNA_NGEN, EMNA_GATE = 30, 1000, 150, 1e-3
MS_STEPS, SP_N, SP_STEPS, PEAK_GATE = 40, 60, 30, 9.0
N3_MU, N3_DIM, N3_NGEN, N3_P, N3_HV_GATE = 16, 5, 100, 12, 116.0
# NSGA-III at bench.py's NSGA-II width: uniform_reference_points(3, 12);
# DE and PSO at the continuous GA's width (RA_N x RA_DIM Rastrigin), 20
# generations after 2; dense SPEA2 on an over-full ZDT1 union
N3_WIDE_P, WIDE_NGEN, WIDE_WARM = 12, 20, 2
SPEA2_N, SPEA2_K = 2000, 1000
# bench_suite.py's two ZDT1 NSGA-II configurations (bench_nsga2,
# bench_nsga2_50k): 30 genes in [0, 1], bounded SBX (eta 20) with cxpb
# 0.9, polynomial mutation (eta 20, indpb 1/30) with mutpb 1.0, DCD mating
# selection, sel_nsga2 over the union; mu 2000 with nd='standard' for
# bench_suite.py's NGEN 50, mu 50k with nd='staircase' for its 10
ZDT1_DIM, ZDT1_CXPB, ZDT1_MUTPB, ZDT1_ETA = 30, 0.9, 1.0, 20.0
ZDT1_SMALL_MU, ZDT1_SMALL_NGEN, ZDT1_MU, ZDT1_NGEN = 2000, 50, 50_000, 10
# J3 at the 50k run's two sizes (DCD's parents, the union) and J4 on
# DTLZ2 unions at 16,384 and 100k rows; the kinds of rows both are held
# against their plain versions on
J3_SIZES, J4_SIZES = (ZDT1_MU, 2 * ZDT1_MU), (16_384, 2 * MO_POP)
ND_KINDS = ("random", "ties", "neg_inf", "nan", "duplicates", "one_front",
            "chain")
# the row counts both are held at on each kind: around one and two chunks
ND_SIZES = (1, 2, 31, 32, 33, 63, 64, 65, 1000)
# bench_suite.py's cartpole_neuro_pop10k: pop 10k mlp_policy((4, 16, 2))
# genomes N(0, 0.5^2), the mean return over 3 fixed episode starts of up to
# 500 steps, blend (alpha 0.1), Gaussian mutation (sigma 0.3, indpb 0.1),
# tournaments of 3, cxpb and mutpb 0.5, 20 generations
CP_POP, CP_SIZES, CP_EPISODES, CP_STEPS, CP_NGEN = 10_000, (4, 16, 2), 3, 500, 20
CP_SIGMA, CP_ALPHA, CP_MUT_SIGMA, CP_INDPB = 0.5, 0.1, 0.3, 0.1
CP_CXPB, CP_MUTPB = 0.5, 0.5
# J5's checked shapes (policies x episodes x max_steps), and the gains of
# the balancing controller (x, x_dot, theta, theta_dot)
J5_POPS, J5_EPISODES, J5_STEPS = (1, 3, 33, 1001, 10_000), (1, 3, 5), (
    10, 200, 500)
J5_BALANCE = (0.5, 1.0, 10.0, 2.0)
# J5's population whose every episode reaches the cap: the balancing genome
# perturbed by N(0, J5_CAPPED_SIGMA^2) across J5_CAPPED_POP policies, where
# the launch is set by the issue of the warps at the cap, not by one chain
J5_CAPPED_POP, J5_CAPPED_SIGMA = 10_000, 0.05
# J5's widths held beside the configuration's 16 (P 257, E 3, 200 steps):
# two widths of the runtime-H instance
J5_WIDTHS = (7, 64)
# phase 19, resilience: the OneMax ea_simple run of phase 3 for 20
# generations in segments of 5, a child process killed once generation 10
# is checkpointed; GP symbreg preempted at 10 of 20; CMA-ES with J1 for 12
# generations in segments of 4
RS_NGEN, RS_SEG, RS_KILL_AT = 20, 5, 10
# the same run for 60 generations in segments of 20, each as long as a
# checkpoint's write: the tax of a longer segment
RS_LONG_NGEN, RS_LONG_SEG = 60, 20
RS_GP_NGEN, RS_GP_PREEMPT, RS_CMA_NGEN, RS_CMA_SEG = 20, 10, 12, 4
# phase 20, telemetry: phase 3's OneMax run for 20 generations, GP and
# CMA-ES for 10, a (mu + lambda) NSGA-II on DTLZ2 at mu 50k for 3; the
# resilient OneMax run in segments of 5 with every 2nd one traced, then
# in segments of 4 (a second signature for the observatory)
TL_NGEN, TL_GP_NGEN, TL_CMA_NGEN, TL_MO_NGEN = 20, 10, 10, 3
TL_SEG, TL_TRACE_EVERY, TL_SEG2, TL_SYNC_GENS = 5, 2, 4, 3
# bare and telemetered runs alternate (after one untimed telemetered
# warm-up) this many times each; the least wall of each is reported
TL_REPS, TL_OTHER_REPS = 3, 2
TL_MO_REF = (-4.0, -4.0, -4.0)
# the kernels' function names as the profiler lists them
K1_KERNEL = "fused_variation_kernel"
# clocks the card spins before each timed call (about 1 ms): the host
# enqueues the call meanwhile, so its events time device work only
SPIN_CYCLES = 2_000_000
EXACT = 2.0 ** 24  # float32 integers are exact below this


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


def max_sm_clock_hz():
    """The card's maximum SM clock, from ``nvidia-smi``."""
    import subprocess
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], check=True,
                         capture_output=True, text=True, timeout=30)
    return float(out.stdout.split()[0]) * 1e6


def ptxas_report(log):
    """``(kernel, "registers ...; spills ...")`` for each kernel in an
    ``nvcc -Xptxas -v`` log, the kernel's mangled name shortened to its
    name and template argument."""
    import re
    out, kernel, spill = [], "?", ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = re.search(r"\d+([a-z_]+kernel[a-z_]*)"
                             r"(?:I(\w)Li(\d+)E(?:Li(\d+)E)?|ILi(\d+)E"
                             r"|ILb([01])E|I(\w)E)?", entry.group(1))
            arg = name and (
                (name.group(2) and ",".join(
                    g for g in name.group(2, 3, 4) if g is not None))
                or name.group(5) or name.group(7) or (
                    name.group(6) and ("false", "true")[int(name.group(6))]))
            kernel = entry.group(1) if name is None else name.group(1) + (
                f"<{arg}>" if arg else "")
            # K6's tile on its draw source: <philox|bits, threads x rows,
            # narrow|wide, blocks an SM>
            tile = re.search(r"(Philox|Loaded)DrawsELi(\d+)ELi(\d+)ELb([01])"
                             r"ELi(\d+)E", entry.group(1))
            if tile:
                source = "philox" if tile.group(1) == "Philox" else "bits"
                kernel = (f"{name.group(1)}<{source},{tile.group(2)}x"
                          f"{tile.group(3)},"
                          f"{('narrow', 'wide')[int(tile.group(4))]},"
                          f"{tile.group(5)}>")
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            out.append((kernel, line.split(":", 1)[-1].strip() + "; "
                        + spill))
    return out


def print_ptxas(src, kernel):
    """Print the registers, spills and shared memory of ``kernel`` (and
    its instances) in the build of ``csrc/<src>.cu``."""
    from deap_tpu_torch import _build
    for name, line in ptxas_report(_build.build_log(src)):
        if name.startswith(kernel):
            print(f"  ptxas {src} {name}: {line}")


def compare_rate(dev):
    """float32 compares per second: SMs x 128 lanes x the max SM clock."""
    import torch
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * COMPARES_PER_SM_CLOCK * max_sm_clock_hz()


def time_ms(fn, flush, reps=25):
    """Median device time of one call, each call after an L2 flush and a
    spin of the card during which the host enqueues the call's work (a
    wrapper's host work does not enter the time)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def whole_ms(torch, fn, reps=5):
    """Median host time of ``fn()`` from a synchronised card to its work's
    end (one call first, as warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def k7_pairs(kernels, w, rows=None):
    """The (query, row) pairs K7 compares on ``w``: each block of ``rows``
    queries (by default the kernel's) against the sorted rows up to its
    prune limit."""
    import torch
    n, m = w.shape
    rows = rows or kernels._DOM_THREADS * kernels._k7_rows_per_thread(m)
    _, limit = kernels._k7_order(w, rows)
    block_rows = torch.full_like(limit, rows)
    block_rows[-1] = n - rows * (limit.shape[0] - 1)
    return float((limit.double() * block_rows).sum())


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
    clock = max_sm_clock_hz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    compares_per_s = compare_rate(dev)
    imads_per_s = sms * IMADS_PER_SM_CLOCK * clock
    print(f"card: {facts}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; memory rate for bounds {rate / 1e12} TB/s; "
          f"{sms} SMs at max {clock / 1e6:.0f} MHz = {compares_per_s:.4e} "
          f"float32 compares/s, {imads_per_s:.4e} integer multiplies/s")

    # ------------------------------------------------------------ build --
    t0 = time.perf_counter()
    seconds = _build.build((*_build.SOURCES, *PROBE_SOURCES))
    print(f"build: {time.perf_counter() - t0:.2f} s wall for "
          f"{len(seconds)} kernels "
          + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()))
    for src in _build.SOURCES:
        for kernel, report_line in ptxas_report(_build.build_log(src)):
            print(f"  ptxas {src} {kernel}: {report_line}")

    flush = torch.empty(2**27, dtype=torch.int32, device=dev)  # 512 MB
    report = {}

    def record(key, name, source, replaces, err, ms, plain_ms, nbytes,
               compares=0, imads=0, int_ops=0, f32_ops=0):
        """One kernel's line; the bound is the larger of its bytes over the
        memory rate and its operations (float32 compares and other float32
        operations at 128 lanes an SM a clock, the integer multiplies of
        its Philox calls, or other integer operations, at the integer
        multiply's rate) over their rate."""
        bytes_ms = nbytes / rate * 1e3
        ops_ms = ((compares + f32_ops) / compares_per_s
                  + (imads + int_ops) / imads_per_s) * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        report[key] = {"name": name, "route": "cuda", "source": source,
                       "replaces": replaces, "launches": None,
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": None}
        print(f"{tag} {name}: {ms * 1e3:.2f} us (bound {bound_ms * 1e3:.2f} "
              f"us by {bound_by}: {nbytes / 1e6:.2f} MB, {compares:.3e} "
              f"compares, {f32_ops:.3e} other float32 operations, "
              f"{imads:.3e} integer multiplies, {int_ops:.3e} other "
              f"integer operations; plain {plain_ms * 1e3:.2f} us), "
              f"max_abs_err {err}")

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
        ms = time_ms(lambda: kernels.fused_variation(*args, mut_kind=kind),
                     flush)
        # a torch copy of its output: the floor of moving these bytes
        # under this timer
        copy_to = torch.empty_like(got)
        copy_ms = time_ms(lambda: copy_to.copy_(got), flush)
        print(f"{tag} fused_variation[{dtype}, {kind}]: {ms * 1e3:.2f} us; "
              f"a torch copy of its output {copy_ms * 1e3:.2f} us")
        if kind == "flip":  # the main path's case is the one recorded
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
    cases = 0
    for L_, n_, N_, dtype, kind, cxpb, mutpb, aligned in k1_sweep():
        args = k1_inputs(torch, dev, cases, n_, N_, L_, dtype, kind, cxpb,
                         mutpb, aligned)
        got = kernels.fused_variation(*args, mut_kind=kind)
        want = variation.apply_variation(*args, kind).to(dtype)
        torch.cuda.synchronize()
        if not bitwise_equal(got, want):
            fail(f"fused_variation[{dtype}, {kind}] differs from "
                 f"apply_variation at n={n_}, N={N_}, L={L_}, cxpb={cxpb}, "
                 f"mutpb={mutpb}, aligned={aligned}")
        cases += 1
    print(f"{tag} fused_variation == apply_variation bitwise at {cases} "
          f"more shapes (L 1-101, n 1-1001, N != n, segments empty, from 0 "
          f"and to L, cxpb and mutpb 0 and 1, genomes off 4-byte "
          f"alignment, every kind in both dtypes; var_or's λ 1-100k from N "
          f"2-100k)")

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
    n_cx, n_mut = pairs_mating(bits[0], CXPB), rows_below(bits[1], MUTPB)
    # what this run's draws need: rows in and out, fitness out, pair word 0
    # of every pair and words 1-2 of mating pairs, row bits, and of
    # mutating rows the L gene-bit planes of real genes
    nbytes = (2 * N * W * 4 + N * 4 + (N // 2) * 4 + n_cx * 8 + N * 4
              + n_mut * L * 4)
    record("k3", "fused_variation_eval_packed",
           "deap_tpu_torch/csrc/packed_variation.cu",
           "deap_tpu/ops/packed.py:264", err,
           time_ms(lambda: packed.fused_variation_eval_packed(pk, L, *bits,
                                                              **probs), flush),
           time_ms(lambda: packed.fused_variation_eval_packed_plain(
               pk, L, *bits, **probs), flush), nbytes)
    print(f"  (of {N} rows {n_mut} mutate, of {N // 2} pairs {n_cx} mate)")
    # the practical floor of moving these genomes under this timer: a torch
    # copy of the same 1.6 MB (it does not compute the function)
    copy_to = torch.empty_like(pk)
    print(f"  K3: a torch copy of the same {pk.numel() * 4 / 1e6:.2f} MB "
          f"genomes {time_ms(lambda: copy_to.copy_(pk), flush) * 1e3:.2f} us "
          f"under the same timer")
    print_ptxas("packed_variation", "packed_variation_kernel")
    del copy_to
    cases = 0
    for n_, L_, probs_ in k3_sweep():
        pkn = packed.pack_genomes(torch.rand((n_, L_), generator=gen,
                                             device=dev) < 0.5)
        if n_ == 257:  # genomes and genebits off 16-byte alignment
            pkn = offset_copy(torch, pkn)
        bn = packed.variation_bits(gen, n_, pkn.shape[1])
        if n_ == 257:
            bn = bn[:2] + (offset_copy(torch, bn[2]),)
        kw = dict(zip(("cxpb", "mutpb", "indpb"), probs_))
        got = packed.fused_variation_eval_packed(pkn, L_, *bn, **kw)
        want = packed.fused_variation_eval_packed_plain(pkn, L_, *bn, **kw)
        torch.cuda.synchronize()
        if not (bitwise_equal(got[0], want[0])
                and bitwise_equal(got[1], want[1])):
            fail(f"fused_variation_eval_packed differs from the plain "
                 f"version at n={n_}, L={L_}, (cxpb, mutpb, indpb)={probs_}")
        cases += 1
    print(f"{tag} fused_variation_eval_packed == plain bitwise at {cases} "
          f"more shapes (n 1, 2, 255, 256, 257 off 16-byte alignment, 1001 "
          f"by L 1, 31, 32, 33, {L}, 128, 300; cxpb and mutpb at 0 and 1)")

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
    # its floor under the same timer: a torch copy of its 1.6 MB output
    copy_to = torch.empty_like(pk)
    print(f"  K4 {report['k4']['ms'] * 1e3:.2f} us; a torch copy of its "
          f"output {time_ms(lambda: copy_to.copy_(pk), flush) * 1e3:.2f} us "
          f"under the same timer")
    print_ptxas("selgather_packed", "selgather_kernel")
    del flush, copy_to

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

    reset_counts()
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
        reset_counts()
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

    whole_generation_phases(torch, dev, tag, report, record)
    hw_phases(torch, dev, tag, report, record)
    mo_phases(torch, dev, tag, report, record)
    nd_scan_phases(torch, dev, tag, report, record)
    gp_phases(torch, dev, tag, report, record)
    gp_rest_phases(torch, dev, tag, report, record)
    real_hw_phases(torch, dev, tag, report, record)
    cma_phases(torch, dev, tag, report, record)
    mu_lambda_phases(torch, dev, tag, report)
    strategy_phases(torch, dev, tag, report)
    swarm_nsga3_phases(torch, dev, tag, report)
    cartpole_phases(torch, dev, tag, report, record)
    resilience_phases(torch, dev, tag, onemax_run)
    telemetry_phases(torch, dev, tag, onemax_run)

    print(json.dumps({"kernels": [report[k] for k in
                                  ("k1", "k2", "k3", "k4", "k5", "k6", "k7",
                                   "k8", "k9", "k2_hw", "k3_hw", "k4_hw",
                                   "k5_hw", "k6_hw", "j1", "j2", "j3",
                                   "j4", "j5")]}))
    print(facts)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def launch_counters():
    """Every kernel wrapper's launch counter."""
    from deap_tpu_torch.benchmarks import cartpole
    from deap_tpu_torch.gp import ant
    from deap_tpu_torch.mo import emo, ndsort
    from deap_tpu_torch.ops import kernels, kernels_real, linalg, packed
    return (cartpole.cartpole_rollout, kernels.fused_variation,
            kernels.fused_variation_eval,
            packed.fused_variation_eval_packed,
            packed.sel_tournament_gather_packed, packed.evolve_packed,
            kernels_real.fused_variation_eval_real,
            kernels.dominated_weight_sums, kernels.dominated_weight_maxes,
            kernels.gp_grouped_dispatch, linalg.eigh_jacobi,
            ant.ant_rollout, emo.nd_rank_staircase, ndsort.nd_rank_sweep3)


def reset_counts():
    """Set every launch count to 0 just before a main-path run (the
    Philox and vector launches counted within them too)."""
    from deap_tpu_torch.ops import kernels, kernels_real, packed
    for fn in launch_counters():
        fn.launches = 0
    kernels.gp_grouped_dispatch.levels = 0
    kernels.fused_variation_eval.vector_launches = 0
    for fn in (kernels.fused_variation_eval,
               packed.fused_variation_eval_packed,
               packed.sel_tournament_gather_packed, packed.evolve_packed,
               kernels_real.fused_variation_eval_real):
        fn.hw_launches = 0


def whole_generation_phases(torch, dev, tag, report, record):
    """Phases 5-7: K2, K5 and K6 at their main paths' shapes, and the
    loops that drive them."""
    from deap_tpu_torch import FitnessSpec, algorithms, ops
    from deap_tpu_torch.core.population import init_population
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.ops import kernels, kernels_real, packed
    from deap_tpu_torch.support.stats import fitness_stats

    flush = torch.empty(2**27, dtype=torch.int32, device=dev)  # 512 MB
    probs = dict(cxpb=CXPB, mutpb=MUTPB, indpb=INDPB)
    gen = make_generator(31, dev)

    # ----------------------------------- K2 fused_variation_eval check --
    worst = 0.0
    # L % 4 == 0 takes the vector variant, L 33 the scalar one; the main
    # path's case comes last and is the one timed
    for n, length, dtype in ((1001, 33, torch.bool),
                             (1001, 33, torch.float32),
                             (1001, L, torch.float32), (N, L, torch.bool)):
        variant = "vector" if length % 4 == 0 else "scalar"
        g = (torch.rand((n, length), generator=gen, device=dev)
             < 0.5).to(dtype)
        bits = kernels.fused_bits(gen, n, length)
        before = kernels.fused_variation_eval.vector_launches
        got = kernels.fused_variation_eval(g, *bits, **probs)
        if (kernels.fused_variation_eval.vector_launches - before
                != (variant == "vector")):
            fail(f"fused_variation_eval[{dtype}] at L={length} did not take "
                 f"the {variant} variant")
        want = kernels.fused_variation_eval_plain(g, *bits, **probs)
        torch.cuda.synchronize()
        for a, b, what in zip(got, want, ("children", "fitness")):
            if not bitwise_equal(a, b):
                fail(f"fused_variation_eval[{dtype}] {what} differ from the "
                     f"plain version at n={n}, L={length}")
            worst = max(worst, max_abs_err(a, b))
        print(f"{tag} fused_variation_eval[{dtype}] ({variant} variant) == "
              f"plain bitwise at n={n}, L={length}")
    n_cx, n_mut = pairs_mating(bits[0], CXPB), rows_below(bits[1], MUTPB)
    # what this run's draws need: genomes in and out, fitness out, pair
    # word 0 of every pair and words 1-2 of mating pairs, row bits, gene
    # bits of mutating rows
    nbytes = (2 * N * L + 4 * N + 4 * (N // 2) + 8 * n_cx + 4 * N
              + 4 * L * n_mut)
    record("k2", "fused_variation_eval",
           "deap_tpu_torch/csrc/fused_variation_eval.cu",
           "deap_tpu/ops/kernels.py:697", worst,
           time_ms(lambda: kernels.fused_variation_eval(g, *bits, **probs),
                   flush),
           time_ms(lambda: kernels.fused_variation_eval_plain(g, *bits,
                                                              **probs),
                   flush), nbytes)
    print(f"  (of {N} rows {n_mut} mutate, of {N // 2} pairs {n_cx} mate)")

    def onemax_start(seed, n):
        g = make_generator(seed, dev)
        genomes = ops.bernoulli_genome(L)(g, n)
        return g, genomes, genomes.sum(1).to(torch.float32)

    runs = []
    for variation in (kernels.fused_variation_eval,
                      kernels.fused_variation_eval_plain):
        g, genomes, fit = onemax_start(13, 1001)
        for _ in range(5):
            genomes, fit = fused_onemax_generation(g, genomes, fit, variation)
        runs.append((genomes, fit))
    if not (bitwise_equal(runs[0][0], runs[1][0])
            and bitwise_equal(runs[0][1], runs[1][1])):
        fail("the fused OneMax loop through K2 differs from it through the "
             "plain version")
    print(f"{tag} fused OneMax loop (n=1001, 5 gens) through K2 == plain "
          f"version bitwise")

    g, genomes, fit = onemax_start(17, N)
    means = [float(fit.mean())]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(FUSED_NGEN):
        genomes, fit = fused_onemax_generation(g, genomes, fit)
        if i % 50 == 49:
            means.append(float(fit.mean()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    report["k2"]["launches"] = kernels.fused_variation_eval.launches
    vector = kernels.fused_variation_eval.vector_launches
    if not (kernels.fused_variation_eval.launches == vector == FUSED_NGEN):
        fail(f"K2 launched {kernels.fused_variation_eval.launches} times "
             f"({vector} of them the vector variant) in {FUSED_NGEN} "
             f"generations")
    if not (torch.equal(fit, genomes.sum(1).to(torch.float32))
            and means[-1] > means[0] + 10):
        fail(f"the fused OneMax loop's fitness is wrong or did not climb: "
             f"{means}")
    print(f"{tag} fused OneMax loop n={N} L={L}: {FUSED_NGEN} generations in "
          f"{wall:.3f} s = {FUSED_NGEN / wall:.2f} gens/s (the mean reads "
          f"included); mean fitness every 50 gens "
          + " -> ".join(f"{m:.3f}" for m in means)
          + f"; K2 launches {report['k2']['launches']}, all of the vector "
          f"variant")

    # ------------------------------------------- K5 evolve_packed check --
    W = packed.words_for(L)

    def packed_start(seed, n):
        g = make_generator(seed, dev)
        pk = packed.pack_genomes(ops.bernoulli_genome(L)(g, n))
        return g, pk, packed.packed_fitness(pk)

    worst = 0.0
    for n in (1001, N):
        g, pk, fit = packed_start(19, n)
        bits = packed.evolve_bits(g, 5, TOURNSIZE, n, W)
        got = packed.evolve_packed(pk, fit, L, *bits, **probs)
        want = packed.evolve_packed_plain(pk, fit, L, *bits, **probs)
        torch.cuda.synchronize()
        for a, b, what in zip(got, want, ("population", "fitness")):
            if not bitwise_equal(a, b):
                fail(f"evolve_packed {what} differs from the plain version "
                     f"after 5 generations at n={n}")
            worst = max(worst, max_abs_err(a, b))
        print(f"{tag} evolve_packed == plain bitwise after 5 generations at "
              f"n={n}, W={W}")
    cases = 0
    for n_, L_, ts, ngen_, probs_ in k5_sweep():
        g = make_generator(41 + cases, dev)
        pk_ = packed.pack_genomes(torch.rand((n_, L_), generator=g,
                                             device=dev) < 0.5)
        fit_ = packed.packed_fitness(pk_)
        bn = packed.evolve_bits(g, ngen_, ts, n_, pk_.shape[1])
        if n_ == 1000:  # the draws off 16-byte alignment: 4-byte copies
            bn = bn[:3] + (offset_copy(torch, bn[3]),)
        kw = dict(zip(("cxpb", "mutpb", "indpb"), probs_))
        got = packed.evolve_packed(pk_, fit_, L_, *bn, **kw)
        want = packed.evolve_packed_plain(pk_, fit_, L_, *bn, **kw)
        torch.cuda.synchronize()
        if not (bitwise_equal(got[0], want[0])
                and bitwise_equal(got[1], want[1])):
            fail(f"evolve_packed differs from the plain version at n={n_}, "
                 f"L={L_}, tournsize={ts}, ngen={ngen_}, "
                 f"(cxpb, mutpb, indpb)={probs_}")
        cases += 1
    print(f"{tag} evolve_packed == plain bitwise at {cases} more shapes (n "
          f"1, 2, 255, 257, 1000 with draws off 16-byte alignment, 1001 and "
          f"{K5_WAVE} past one resident wave, by L 1-300, tournament 1-9, 1 "
          f"to 3 generations, cxpb and mutpb at 0 and 1)")
    print_ptxas("evolve_packed", "evolve_kernel")
    g, pk, fit = packed_start(23, N)
    bits = packed.evolve_bits(g, EVOLVE_CALL, TOURNSIZE, N, W)
    call_bytes = evolve_bytes(bits, N, W, L, CXPB, MUTPB)
    sector_bytes = evolve_sector_bytes(bits, N, W, L, CXPB, MUTPB)
    rate = memory_rate(torch.cuda.get_device_name(0))
    print(f"  K5 bound per generation: {call_bytes / EVOLVE_CALL / 1e6:.3f} MB "
          f"(draws of {EVOLVE_CALL} generations "
          f"{sum(b.numel() for b in bits) * 4 / 1e9:.3f} GB per call, of which "
          f"the call needs {call_bytes / 1e9:.3f} GB: "
          f"{call_bytes / rate * 1e6:.2f} us); sector floor "
          f"{sector_bytes / 1e9:.3f} GB a call (the 32-byte sectors that hold "
          f"a needed word), {sector_bytes / rate * 1e6:.2f} us at "
          f"{rate / 1e12} TB/s")
    record("k5", "evolve_packed", "deap_tpu_torch/csrc/evolve_packed.cu",
           "deap_tpu/ops/packed.py:496", worst,
           time_ms(lambda: packed.evolve_packed(pk, fit, L, *bits, **probs),
                   flush, reps=10),
           time_ms(lambda: packed.evolve_packed_plain(pk, fit, L, *bits,
                                                      **probs),
                   flush, reps=3), call_bytes)
    # the practical floor of reading the call's draws under this timer: a
    # read-only torch pass over them (a sum; it computes nothing of K5's)
    read_ms = time_ms(lambda: [b.view(torch.float32).sum() for b in bits],
                      flush, reps=5)
    print(f"  K5: a read-only torch pass (a float32 sum) over the call's "
          f"draws {read_ms * 1e3:.2f} us under the same timer")
    del bits
    g, pk, fit = packed_start(29, N)
    start_mean = float(fit.mean())
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(EVOLVE_NGEN // EVOLVE_CALL):
        pk, fit = packed.evolve_packed(
            pk, fit, L, *packed.evolve_bits(g, EVOLVE_CALL, TOURNSIZE, N, W),
            **probs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    report["k5"]["launches"] = packed.evolve_packed.launches
    if packed.evolve_packed.launches != EVOLVE_NGEN // EVOLVE_CALL:
        fail(f"K5 launched {packed.evolve_packed.launches} times for "
             f"{EVOLVE_NGEN} generations")
    if not (torch.equal(fit, packed.packed_fitness(pk))
            and float(fit.mean()) > start_mean + 10):
        fail("evolve_packed's fitness is wrong or did not climb")
    print(f"{tag} evolve_packed n={N}: {EVOLVE_NGEN} generations in "
          f"{EVOLVE_NGEN // EVOLVE_CALL} calls of {EVOLVE_CALL} in {wall:.3f} "
          f"s = {EVOLVE_NGEN / wall:.2f} gens/s (the draws included); mean "
          f"fitness {start_mean:.3f} -> {float(fit.mean()):.3f}; K5 launches "
          f"{report['k5']['launches']}")

    # ------------------------------- K6 fused_variation_eval_real check --
    ra = dict(cxpb=RA_CXPB, mutpb=RA_MUTPB, indpb=RA_INDPB, alpha=RA_ALPHA,
              sigma=RA_SIGMA, evaluate="rastrigin")
    genomes = ops.uniform_genome(RA_DIM, RA_LOW, RA_UP)(gen, RA_N)
    bits = kernels_real.real_bits(gen, RA_N, RA_DIM)
    got = kernels_real.fused_variation_eval_real(genomes, *bits, **ra)
    want = kernels_real.fused_variation_eval_real_plain(genomes, *bits, **ra)
    torch.cuda.synchronize()
    errs = kernels_real.real_kernel_errors(got, want, *bits, mutpb=RA_MUTPB,
                                           indpb=RA_INDPB, mu=0.0,
                                           sigma=RA_SIGMA)
    if not errs["ok"]:
        fail(f"fused_variation_eval_real differs from the plain version: "
             f"{errs}")
    print(f"{tag} fused_variation_eval_real vs plain at n={RA_N}, "
          f"L={RA_DIM}: {errs['unmutated']} crossed or untouched genes "
          f"bitwise; {errs['mutated']} mutated genes within "
          f"{kernels_real.STEP_ULPS} "
          f"ulp of the step + 1 of the gene, largest "
          f"{errs['max_ulps']} ulp of step + gene ({errs['max_abs']:.3e} "
          f"absolute); fitness largest relative error "
          f"{errs['max_fit_rel']:.3e}")
    n_cx = pairs_mating(bits[0], RA_CXPB)
    n_mut = rows_below(bits[1], RA_MUTPB)
    # genomes in and out, fitness out, pair word 0 of every pair, row bits,
    # the gamma plane of mating pairs, the gate plane of mutating rows and
    # u1/u2 of mutated genes
    nbytes = (8 * RA_N * RA_DIM + 4 * RA_N + 4 * (RA_N // 2) + 4 * RA_N
              + 4 * RA_DIM * (n_cx + n_mut) + 8 * errs["mutated"])
    record("k6", "fused_variation_eval_real",
           "deap_tpu_torch/csrc/fused_variation_real.cu",
           "deap_tpu/ops/kernels_real.py:142",
           max(errs["max_abs"], errs["max_fit_abs"]),
           time_ms(lambda: kernels_real.fused_variation_eval_real(
               genomes, *bits, **ra), flush),
           time_ms(lambda: kernels_real.fused_variation_eval_real_plain(
               genomes, *bits, **ra), flush), nbytes)
    copy_to = torch.empty_like(genomes)
    print(f"  (of {RA_N} rows {n_mut} mutate, of {RA_N // 2} pairs {n_cx} "
          f"mate, {errs['mutated']} genes mutated; it reads "
          f"{8 * (n_mut * RA_DIM - errs['mutated']) / 1e6:.3f} MB above the "
          f"bound's bytes, the u1 and u2 words of the ungated genes of "
          f"mutating rows; a torch copy of the same genomes "
          f"{time_ms(lambda: copy_to.copy_(genomes), flush) * 1e3:.2f} us "
          f"under the same timer)")
    print_ptxas("fused_variation_real", "real_tile_kernel<bits")
    del flush, copy_to

    # the bits body's tiles of 16 rows on generic streams: n below a tile,
    # a partial tile, an odd last row, one column chunk (L <= 32) and
    # several, the rates at 0 and 1 (empty and full lists), and the main
    # path's n; each against its plain version at K6's tolerance
    cases = 0
    for n, length, probs in k6_sweep():
        gn = (torch.rand((n, length), generator=gen, device=dev) * 10.24
              - 5.12)
        bn = kernels_real.real_bits(gen, n, length)
        kw = dict(ra, evaluate=("rastrigin", "sphere")[cases % 2], **probs)
        got = kernels_real.fused_variation_eval_real(gn, *bn, **kw)
        want = kernels_real.fused_variation_eval_real_plain(gn, *bn, **kw)
        torch.cuda.synchronize()
        errs = kernels_real.real_kernel_errors(
            got, want, *bn, mutpb=kw["mutpb"], indpb=kw["indpb"], mu=0.0,
            sigma=RA_SIGMA)
        if not errs["ok"]:
            fail(f"fused_variation_eval_real differs from the plain version "
                 f"at n={n}, L={length}, {probs}: {errs}")
        cases += 1
    print(f"{tag} fused_variation_eval_real == plain at K6's tolerance at "
          f"{cases} more shapes on real_bits streams (n 1, 2, 3, 15, 16, 17, "
          f"63, 64, 65, 127, 129, 1001 by L 1, 30, 31, 33, 64, 100 and n "
          f"{RA_N} at L "
          f"{RA_DIM}; cxpb, mutpb, indpb at 0 and 1)")

    g = make_generator(37, dev)
    genomes = ops.uniform_genome(RA_DIM, RA_LOW, RA_UP)(g, RA_N)
    fit = kernels_real.eval_rastrigin(genomes)
    bests = [float(fit.min())]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RA_NGEN):
        genomes, fit = rastrigin_fused_generation(g, genomes, fit)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bests.append(float(fit.min()))
    report["k6"]["launches"] = kernels_real.fused_variation_eval_real.launches
    if report["k6"]["launches"] != RA_NGEN:
        fail(f"K6 launched {report['k6']['launches']} times in {RA_NGEN} "
             f"generations")
    check = kernels_real.eval_rastrigin(genomes)
    if not (bool(torch.isfinite(fit).all()) and bests[1] < bests[0]
            and torch.allclose(fit, check, rtol=kernels_real.FIT_RTOL,
                               atol=1e-3)):
        fail(f"the fused Rastrigin loop's fitness is wrong or did not fall: "
             f"best {bests}")
    print(f"{tag} fused Rastrigin loop n={RA_N} dim={RA_DIM}: {RA_NGEN} "
          f"generations in {wall:.3f} s = {RA_NGEN / wall:.2f} gens/s; best "
          f"{bests[0]:.4f} -> {bests[1]:.4f}, mean {float(fit.mean()):.4f}; "
          f"K6 launches {report['k6']['launches']}")

    g = make_generator(41, dev)
    pop = init_population(g, RA_N, ops.uniform_genome(RA_DIM, RA_LOW, RA_UP),
                          FitnessSpec((-1.0,)), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pop, logbook, _ = algorithms.ea_simple(
        g, pop, rastrigin_toolbox(), RA_CXPB, RA_MUTPB, RA_UNFUSED_NGEN,
        stats=fitness_stats(), device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mins = logbook.select("min")
    if not (mins[-1] < mins[0] and bool(torch.isfinite(pop.fitness).all())):
        fail(f"unfused Rastrigin ea_simple did not improve: {mins}")
    print(f"{tag} unfused Rastrigin ea_simple n={RA_N}: {RA_UNFUSED_NGEN} "
          f"generations in {wall:.3f} s incl. gen-0 evaluation = "
          f"{RA_UNFUSED_NGEN / wall:.2f} gens/s; best {mins[0]:.4f} -> "
          f"{mins[-1]:.4f}")


def hw_phases(torch, dev, tag, report, record):
    """Phase 8: the ``prng='hw'`` paths of K2-K5 (Philox in the kernel):
    the known answers of the device function, each path bitwise against
    its plain version, the invariants of the counter layout, ``bench.py``'s
    OneMax loops with ``'hw'`` and ``'auto'``, peak memory of an
    ``evolve_packed`` call, ``'hw'`` against ``'input'`` in distribution,
    and the binned selector."""
    from deap_tpu_torch import algorithms, ops
    from deap_tpu_torch.core.fitness import lex_sort_desc
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.ops import kernels, packed, philox, selection

    flush = torch.empty(2**27, dtype=torch.int32, device=dev)  # 512 MB
    probs = dict(cxpb=CXPB, mutpb=MUTPB, indpb=INDPB)
    gen = make_generator(53, dev)
    W = packed.words_for(L)
    gene_calls = -(-L // 4)
    u32 = torch.uint32

    def same(a, b, what):
        for x, y, part in zip(a, b, ("children", "fitness")):
            if not bitwise_equal(x, y):
                fail(f"{what}: {part} differ")

    # ------------------------------------------------ known answers --
    ctr = torch.tensor([c for c, _, _ in PHILOX_KAT]).to(u32).to(dev)
    keys = torch.tensor([k for _, k, _ in PHILOX_KAT]).to(u32).to(dev)
    want = torch.tensor([o for _, _, o in PHILOX_KAT]).to(u32).to(dev)
    rctr = philox._u32(torch.randint(0, 2**32, (4096, 4), generator=gen,
                                     device=dev, dtype=torch.int64))
    rkey = philox._u32(torch.randint(0, 2**32, (4096, 2), generator=gen,
                                     device=dev, dtype=torch.int64))
    rwant = philox.philox4x32_10(rctr, rkey).to(u32)
    if not bitwise_equal(philox.philox4x32_10(ctr, keys).to(u32), want):
        fail("ops.philox.philox4x32_10 misses Random123's known answers")
    for lib in PHILOX_LIBRARIES:
        if not bitwise_equal(kernels.philox_kat(ctr, keys, lib), want):
            fail(f"philox4x32_10 in lib{lib} misses the known answers")
        if not bitwise_equal(kernels.philox_kat(rctr.to(u32), rkey.to(u32),
                                                lib), rwant):
            fail(f"philox4x32_10 in lib{lib} differs from the plain version")
    print(f"{tag} philox4x32_10 on the card (in each of "
          f"{', '.join(PHILOX_LIBRARIES)}): Random123's 3 known answers, and "
          f"== ops.philox.philox4x32_10 on 4096 random counters and keys")

    # ------------------------------------------------- K2 Philox path --
    worst = 0.0
    # the vector variant's edges: L 4 (one word), L 200 and 300 (more
    # words than lanes: two slots a lane, then two chunks), L 1000, odd n
    # and n 1; the main path's case (N, L, bool) is the last
    edges = [(n, length, dtype) for dtype in (torch.bool, torch.float32)
             for n, length in ((1, 4), (1, L), (3, 4), (1001, 4), (1001, 200),
                               (999, 300), (257, 1000), (N - 1, L))]
    for n, length, dtype in ((1001, 33, torch.bool), (1001, 33, torch.float32),
                             (N, 33, torch.bool), (N, 33, torch.float32),
                             (1001, L, torch.bool), (1001, L, torch.float32),
                             *edges, (N, L, torch.float32),
                             (N, L, torch.bool)):
        variant = "vector" if length % 4 == 0 else "scalar"
        g = (torch.rand((n, length), generator=gen, device=dev)
             < 0.5).to(dtype)
        key = kernels.philox_key(gen)
        fn = kernels.fused_variation_eval
        before = (fn.vector_launches, fn.hw_launches)
        got = fn(g, prng="hw", key=key, **probs)
        if (fn.vector_launches - before[0] != (variant == "vector")
                or fn.hw_launches - before[1] != 1):
            fail(f"fused_variation_eval(prng='hw')[{dtype}] at L={length} "
                 f"did not take the {variant} variant of the Philox path")
        bits = philox.hw_fused_bits(key, n, length)
        want = kernels.fused_variation_eval_plain(g, *bits, **probs)
        torch.cuda.synchronize()
        same(got, want, f"fused_variation_eval(prng='hw')[{dtype}] at "
             f"n={n}, L={length}")
        worst = max(worst, max_abs_err(got[0], want[0]),
                    max_abs_err(got[1], want[1]))
        print(f"{tag} fused_variation_eval(prng='hw')[{dtype}] ({variant} "
              f"variant) == plain on ops.philox's streams bitwise at n={n}, "
              f"L={length}")
    # the main path's case (N, L, bool) is the last and the one timed
    again = kernels.fused_variation_eval(g, prng="hw", key=key, **probs)
    other = kernels.fused_variation_eval(g, prng="hw", key=other_key(key),
                                         **probs)
    if bitwise_equal(got[0], other[0]):
        fail("fused_variation_eval(prng='hw') gave the same children for "
             "two keys")
    same(got, again, "fused_variation_eval(prng='hw') twice with one key")
    n_mut = rows_below(bits[1], MUTPB)
    record("k2_hw", "fused_variation_eval (prng='hw')",
           "deap_tpu_torch/csrc/fused_variation_eval.cu",
           "deap_tpu/ops/kernels.py:609", worst,
           time_ms(lambda: kernels.fused_variation_eval(
               g, prng="hw", key=key, **probs), flush),
           time_ms(lambda: kernels.fused_variation_eval_plain(
               g, *philox.hw_fused_bits(key, N, L), **probs), flush),
           2 * N * L + 4 * N,
           imads=PHILOX_IMADS * (N + n_mut * gene_calls))
    print(f"  (of {N} rows {n_mut} mutate: {N + n_mut * gene_calls} Philox "
          f"calls; one key twice bitwise equal, two keys differ)")

    # ---------------------------------------------- K3 and K4 Philox --
    # K3-hw's tiles of 256 rows: a partial tile, an odd last row, one and
    # two flip-word chunks (W > 8 from L 257), no row or every row
    # mutating; each against its plain version and pack_genomes(K2-hw)
    k3_shapes = [(n, length, MUTPB) for n in (1, 3, 255, 257, 1001, N)
                 for length in (2, 31, 33, L, 257, 300)]
    k3_shapes += [(n, length, mutpb) for n, length in ((257, 33), (1001, 300))
                  for mutpb in (0.0, 1.0)]
    for n, length, mutpb in k3_shapes:
        bools = torch.rand((n, length), generator=gen, device=dev) < 0.5
        pkn = packed.pack_genomes(bools)
        key = kernels.philox_key(gen)
        kw = dict(probs, mutpb=mutpb)
        got = packed.fused_variation_eval_packed(pkn, length, prng="hw",
                                                 key=key, **kw)
        want = packed.fused_variation_eval_packed_plain(
            pkn, length, *philox.hw_packed_bits(key, n, pkn.shape[1],
                                                length), **kw)
        byte = kernels.fused_variation_eval(bools, prng="hw", key=key, **kw)
        torch.cuda.synchronize()
        what = f"n={n}, L={length}, mutpb={mutpb}"
        same(got, want, f"fused_variation_eval_packed(prng='hw') at {what}")
        same(got, (packed.pack_genomes(byte[0]), byte[1]),
             f"K3-hw against pack_genomes of K2-hw at {what}")
    print(f"{tag} fused_variation_eval_packed(prng='hw') == plain on "
          f"ops.philox's streams and == pack_genomes(K2-hw) bitwise at "
          f"{len(k3_shapes)} shapes: n 1, 3, 255, 257, 1001, {N} by L 2, 31, "
          f"33, {L}, 257, 300; mutpb 0 and 1 at (257, 33) and (1001, 300)")
    bools = torch.rand((N, L), generator=gen, device=dev) < 0.5
    pk = packed.pack_genomes(bools)
    key = kernels.philox_key(gen)
    got = packed.fused_variation_eval_packed(pk, L, prng="hw", key=key,
                                             **probs)
    bits = philox.hw_packed_bits(key, N, W, L)
    want = packed.fused_variation_eval_packed_plain(pk, L, *bits, **probs)
    torch.cuda.synchronize()
    same(got, want, "fused_variation_eval_packed(prng='hw')")
    k3_err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
    # invariant: K3-hw on packed rows == K2-hw on the rows, packed
    byte = kernels.fused_variation_eval(bools, prng="hw", key=key, **probs)
    same(got, (packed.pack_genomes(byte[0]), byte[1]),
         "K3-hw on pack_genomes(g) against pack_genomes of K2-hw on g")
    print(f"{tag} fused_variation_eval_packed(prng='hw') == plain on "
          f"ops.philox's streams bitwise at n={N}, W={W}; == "
          f"pack_genomes(K2-hw) with the same key, fitness too")
    n_mut = rows_below(bits[1], MUTPB)
    record("k3_hw", "fused_variation_eval_packed (prng='hw')",
           "deap_tpu_torch/csrc/packed_variation.cu",
           "deap_tpu/ops/packed.py:239", k3_err,
           time_ms(lambda: packed.fused_variation_eval_packed(
               pk, L, prng="hw", key=key, **probs), flush),
           time_ms(lambda: packed.fused_variation_eval_packed_plain(
               pk, L, *philox.hw_packed_bits(key, N, W, L), **probs), flush),
           2 * N * W * 4 + 4 * N,
           imads=PHILOX_IMADS * (N + n_mut * gene_calls))
    # the practical floor of moving these genomes under this timer: a
    # torch copy of the same 1.6 MB (it does not compute the function)
    copy_to = torch.empty_like(pk)
    copy_ms = time_ms(lambda: copy_to.copy_(pk), flush)
    print(f"  K3-hw: of {N} rows {n_mut} mutate, "
          f"{N + n_mut * gene_calls} Philox calls; a torch copy of the same "
          f"{pk.numel() * 4 / 1e6:.2f} MB genomes {copy_ms * 1e3:.2f} us "
          f"under the same timer")
    print_ptxas("packed_variation", "packed_variation_hw_kernel")
    del copy_to

    # K4-hw and K4's row copies: uint4 rows (W 4), the warp's word walk
    # (W 1, 2, 9, 10), a last warp part full, 1-3 Philox calls a
    # tournament (tournsize 1-9); each bitwise against the plain version
    k4_shapes = [(n, length, ts) for n in (1, 3, 257, 1001)
                 for length, ts in ((2, 1), (31, 3), (33, 4), (L, 5),
                                    (257, 9), (300, 3))]
    k4_shapes += [(N, length, ts) for length, ts in ((33, 9), (300, 5))]
    for n, length, ts in k4_shapes:
        pkn = packed.pack_genomes(torch.rand((n, length), generator=gen,
                                             device=dev) < 0.5)
        fitn = torch.randint(0, 8, (n,), generator=gen, device=dev).float()
        key = kernels.philox_key(gen)
        got = packed.sel_tournament_gather_packed(pkn, fitn, prng="hw",
                                                  key=key, tournsize=ts)
        want = packed.sel_tournament_gather_packed_plain(
            pkn, fitn, philox.hw_tournament_bits(key, ts, n))
        draws = packed.tournament_bits(gen, ts, n)
        body = packed.sel_tournament_gather_packed(pkn, fitn, draws)
        body_want = packed.sel_tournament_gather_packed_plain(pkn, fitn, draws)
        torch.cuda.synchronize()
        if not (bitwise_equal(got, want) and bitwise_equal(body, body_want)):
            fail(f"sel_tournament_gather_packed differs from the plain "
                 f"version at n={n}, L={length}, tournsize={ts}")
    print(f"{tag} sel_tournament_gather_packed (prng='hw' and bits) == plain "
          f"bitwise at {len(k4_shapes)} shapes: n 1, 3, 257, 1001 by L 2, 31, "
          f"33, {L}, 257, 300 (tournsize 1, 3, 4, 5, 9), and n {N} at L 33, "
          f"300")
    fit = packed.packed_fitness(pk)
    key = kernels.philox_key(gen)
    got = packed.sel_tournament_gather_packed(pk, fit, prng="hw", key=key,
                                              tournsize=TOURNSIZE)
    draws = philox.hw_tournament_bits(key, TOURNSIZE, N)
    want = packed.sel_tournament_gather_packed_plain(pk, fit, draws)
    torch.cuda.synchronize()
    if not bitwise_equal(got, want):
        fail("sel_tournament_gather_packed(prng='hw') differs from the plain "
             "version")
    print(f"{tag} sel_tournament_gather_packed(prng='hw') == plain on "
          f"ops.philox's streams bitwise at n={N}, tournsize={TOURNSIZE}")

    def k4_hw():
        return packed.sel_tournament_gather_packed(
            pk, fit, prng="hw", key=key, tournsize=TOURNSIZE)
    record("k4_hw", "sel_tournament_gather_packed (prng='hw')",
           "deap_tpu_torch/csrc/selgather_packed.cu",
           "deap_tpu/ops/packed.py:331", max_abs_err(got, want),
           time_ms(k4_hw, flush),
           time_ms(lambda: packed.sel_tournament_gather_packed_plain(
               pk, fit, philox.hw_tournament_bits(key, TOURNSIZE, N)), flush),
           4 * (N + 2 * N * W),
           imads=PHILOX_IMADS * N * -(-TOURNSIZE // 4))
    # its floors under the same timer: a torch copy of its 1.6 MB output,
    # torch.index_select of the winners (computed beforehand by the plain
    # rule: the gather half alone), and K4-hw without the flush, as the
    # packed loop finds the genomes and fitness K3-hw has just written
    winners = tournament_winners(fit, draws)
    gathered = torch.index_select(pk.view(torch.int32), 0, winners)
    if not bitwise_equal(gathered.view(torch.uint32), got):
        fail("index_select of the plain rule's winners differs from K4-hw")
    copy_to = torch.empty_like(pk)
    floors = {
        "torch copy of the output": time_ms(lambda: copy_to.copy_(pk), flush),
        "index_select of the winners": time_ms(lambda: torch.index_select(
            pk.view(torch.int32), 0, winners), flush),
        "K4-hw unflushed": time_ms(k4_hw, torch.empty(1, device=dev))}
    print(f"  K4-hw {report['k4_hw']['ms'] * 1e3:.2f} us; under the same "
          f"timer " + ", ".join(f"{k} {v * 1e3:.2f} us"
                                for k, v in floors.items()))
    print_ptxas("selgather_packed", "selgather")
    del copy_to

    # ------------------------------------------------- K5 Philox path --
    worst = 0.0
    # (n, L, tournsize): one pair (n 1) and an odd lane (n 3), a ragged
    # last word (L 33, 70), two tournament calls (tournsize 5), the small
    # odd case, and the main path's size last
    for n, length, ts in ((1, L, TOURNSIZE), (3, L, TOURNSIZE), (1, 33, 5),
                          (3, 70, 5), (1001, 33, TOURNSIZE), (1001, 70, 5),
                          (1001, L, TOURNSIZE), (N, 70, 5),
                          (N, L, TOURNSIZE)):
        g = make_generator(59, dev)
        pkn = packed.pack_genomes(ops.bernoulli_genome(length)(g, n))
        fitn = packed.packed_fitness(pkn)
        key = kernels.philox_key(g)
        got = packed.evolve_packed(pkn, fitn, length, ngen=5, tournsize=ts,
                                   prng="hw", key=key, **probs)
        want = packed.evolve_packed_plain(
            pkn, fitn, length, *philox.hw_evolve_bits(key, 5, ts, n, length),
            **probs)
        torch.cuda.synchronize()
        what = f"n={n}, L={length}, tournsize={ts}"
        same(got, want, f"evolve_packed(prng='hw') after 5 generations at "
             f"{what}")
        worst = max(worst, max_abs_err(got[0], want[0]),
                    max_abs_err(got[1], want[1]))
        # invariant: one generation of K5-hw == K4-hw then K3-hw, one key
        one = packed.evolve_packed(pkn, fitn, length, ngen=1, tournsize=ts,
                                   prng="hw", key=key, **probs)
        parents = packed.sel_tournament_gather_packed(
            pkn, fitn, prng="hw", key=key, tournsize=ts)
        same(one, packed.fused_variation_eval_packed(
            parents, length, prng="hw", key=key, **probs),
            f"evolve_packed(prng='hw', ngen=1) against K4-hw then K3-hw at "
            f"{what}")
        print(f"{tag} evolve_packed(prng='hw') == plain on ops.philox's "
              f"streams bitwise after 5 generations at {what}; one "
              f"generation == K4-hw then K3-hw with the same key")
    again = packed.evolve_packed(pkn, fitn, L, ngen=5, prng="hw", key=key,
                                 **probs)
    other = packed.evolve_packed(pkn, fitn, L, ngen=5, prng="hw",
                                 key=other_key(key), **probs)
    same(got, again, "evolve_packed(prng='hw') twice with one key")
    if bitwise_equal(got[0], other[0]):
        fail("evolve_packed(prng='hw') gave the same population for two "
             "keys")
    g = make_generator(23, dev)
    pk = packed.pack_genomes(ops.bernoulli_genome(L)(g, N))
    fit = packed.packed_fitness(pk)
    key = kernels.philox_key(g)
    calls = 0
    for gi in range(EVOLVE_CALL):
        mut = philox.draws(key, torch.arange(N, device=dev), 0, gi,
                           philox.PAIR_ROW)[:, 3].to(u32)
        calls += N * (1 + -(-TOURNSIZE // 4)) + rows_below(mut, MUTPB) \
            * gene_calls
    # one whole call of the main path against the plain version
    got = packed.evolve_packed(pk, fit, L, ngen=EVOLVE_CALL, prng="hw",
                               key=key, **probs)
    want = packed.evolve_packed_plain(
        pk, fit, L, *philox.hw_evolve_bits(key, EVOLVE_CALL, TOURNSIZE, N, L),
        **probs)
    torch.cuda.synchronize()
    same(got, want, f"evolve_packed(prng='hw') after {EVOLVE_CALL} "
         f"generations at n={N}")
    worst = max(worst, max_abs_err(got[0], want[0]),
                max_abs_err(got[1], want[1]))
    del got, want
    print(f"{tag} evolve_packed(prng='hw') == plain on ops.philox's streams "
          f"bitwise after {EVOLVE_CALL} generations at n={N}")
    blocks, per_sm, tiles = packed._k5_hw_grid(N)
    barrier_ms = (
        time_ms(lambda: packed._k5_hw_barrier(key, N, EVOLVE_CALL), flush,
                reps=10)
        - time_ms(lambda: packed._k5_hw_barrier(key, N, 0), flush, reps=10))
    record("k5_hw", "evolve_packed (prng='hw')",
           "deap_tpu_torch/csrc/evolve_packed.cu",
           "deap_tpu/ops/packed.py:462", worst,
           time_ms(lambda: packed.evolve_packed(
               pk, fit, L, ngen=EVOLVE_CALL, prng="hw", key=key, **probs),
               flush, reps=10),
           time_ms(lambda: packed.evolve_packed_plain(
               pk, fit, L, *philox.hw_evolve_bits(key, EVOLVE_CALL, TOURNSIZE,
                                                  N, L), **probs),
               flush, reps=3),
           2 * (4 * N * W + 4 * N), imads=PHILOX_IMADS * calls)
    print(f"  K5-hw: {calls} Philox calls in {EVOLVE_CALL} generations "
          f"({calls / EVOLVE_CALL:.0f} a generation); one key twice bitwise "
          f"equal, two keys differ; grid {blocks} blocks of 256 children "
          f"({tiles} tiles at n={N}, {per_sm} blocks a SM at most); grid "
          f"barrier {barrier_ms / EVOLVE_CALL * 1e3:.3f} us a generation "
          f"(the same kernel on the same grid with no child, "
          f"{EVOLVE_CALL} generations less 0), "
          f"{barrier_ms / report['k5_hw']['ms']:.1%} of the call")
    del flush

    # ---------------------------------------- memory of one K5 call --
    def peak(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base
    g = make_generator(67, dev)
    mem_in = peak(lambda: packed.evolve_packed(
        pk, fit, L, *packed.evolve_bits(g, EVOLVE_CALL, TOURNSIZE, N, W),
        **probs))
    mem_hw = peak(lambda: packed.evolve_packed(
        pk, fit, L, ngen=EVOLVE_CALL, prng="hw", generator=g, **probs))
    print(f"{tag} peak device memory of one {EVOLVE_CALL}-generation "
          f"evolve_packed call at n={N} above what was allocated before: "
          f"prng='input' {mem_in / 1e9:.4f} GB (its draws included), "
          f"prng='hw' {mem_hw / 1e9:.6f} GB")

    # ----------------------------------- the loops, 'hw' and 'auto' --
    def onemax_start(seed, n):
        g = make_generator(seed, dev)
        genomes = ops.bernoulli_genome(L)(g, n)
        return g, genomes, genomes.sum(1).to(torch.float32)

    def plain_hw(genomes, prng, generator, **kw):
        key = kernels.philox_key(generator)
        return kernels.fused_variation_eval_plain(
            genomes, *philox.hw_fused_bits(key, *genomes.shape), **kw)

    runs = []
    for variation in (None, plain_hw):
        g, genomes, fit = onemax_start(13, 1001)
        for _ in range(5):
            genomes, fit = fused_onemax_generation(g, genomes, fit, variation,
                                                   prng="hw")
        runs.append((genomes, fit))
    same(runs[0], runs[1], "the fused OneMax loop through K2-hw against its "
         "plain version")
    print(f"{tag} fused OneMax loop (n=1001, 5 gens) through K2-hw == plain "
          f"version bitwise")

    def timed(run):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for prng in ("hw", "auto"):
        g, genomes, fit = onemax_start(17, N)
        start_mean = float(fit.mean())

        def fused_loop():
            gg, ff = genomes, fit
            for _ in range(FUSED_NGEN):
                gg, ff = fused_onemax_generation(g, gg, ff, prng=prng)
            return gg, ff
        (gg, ff), wall = timed(fused_loop)
        fn = kernels.fused_variation_eval
        if not (fn.launches == fn.hw_launches == fn.vector_launches
                == FUSED_NGEN):
            fail(f"fused OneMax loop (prng={prng!r}): K2 launches "
                 f"{fn.launches}, Philox {fn.hw_launches}, vector "
                 f"{fn.vector_launches} in {FUSED_NGEN} generations")
        if not (torch.equal(ff, gg.sum(1).to(torch.float32))
                and float(ff.mean()) > start_mean + 10):
            fail(f"fused OneMax loop (prng={prng!r}): fitness wrong or flat")
        if prng == "hw":
            report["k2_hw"]["launches"] = fn.hw_launches
        print(f"{tag} fused OneMax loop prng={prng!r} n={N} L={L}: "
              f"{FUSED_NGEN} generations in {wall:.3f} s = "
              f"{FUSED_NGEN / wall:.2f} gens/s; mean fitness "
              f"{start_mean:.3f} -> {float(ff.mean()):.3f}; K2 launches "
              f"{fn.launches}, Philox {fn.hw_launches}")

    def packed_start(seed, n):
        g = make_generator(seed, dev)
        pk = packed.pack_genomes(ops.bernoulli_genome(L)(g, n))
        return g, pk, packed.packed_fitness(pk)

    # small reference: three generations equal the plain versions in turn
    g, pk, fit = packed_start(3, 1001)
    got = algorithms.ea_simple_packed(g, pk, fit, L, 3, **probs, prng="hw",
                                      device=dev)
    g, want_pk, want_fit = packed_start(3, 1001)
    for _ in range(3):
        key = kernels.philox_key(g)
        parents = packed.sel_tournament_gather_packed_plain(
            want_pk, want_fit, philox.hw_tournament_bits(key, TOURNSIZE, 1001))
        want_pk, want_fit = packed.fused_variation_eval_packed_plain(
            parents, L, *philox.hw_packed_bits(key, 1001, W, L), **probs)
    same(got, (want_pk, want_fit), "ea_simple_packed(prng='hw') against the "
         "plain versions")
    print(f"{tag} ea_simple_packed(prng='hw', n=1001, 3 gens) through the "
          f"Philox kernels == plain versions bitwise")

    for select in ("gather", "sorted", "binned"):
        for prng in ("hw", "auto"):
            g, pk, fit = packed_start(5, N)
            start_mean = float(fit.mean())
            (pk, fit), wall = timed(lambda: algorithms.ea_simple_packed(
                g, pk, fit, L, PACKED_NGEN, tournsize=TOURNSIZE,
                select=select, prng=prng, **probs, device=dev))
            k3, k4 = (packed.fused_variation_eval_packed,
                      packed.sel_tournament_gather_packed)
            want_k4 = PACKED_NGEN if select == "gather" else 0
            if not (k3.launches == k3.hw_launches == PACKED_NGEN
                    and k4.launches == k4.hw_launches == want_k4):
                fail(f"ea_simple_packed select={select} prng={prng!r}: K3 "
                     f"launches {k3.launches} (Philox {k3.hw_launches}), K4 "
                     f"{k4.launches} (Philox {k4.hw_launches})")
            if not (torch.equal(fit, packed.packed_fitness(pk))
                    and float(fit.mean()) > start_mean + 10):
                fail(f"ea_simple_packed select={select} prng={prng!r}: "
                     f"fitness wrong or flat")
            if select == "gather" and prng == "hw":
                report["k3_hw"]["launches"] = k3.hw_launches
                report["k4_hw"]["launches"] = k4.hw_launches
            print(f"{tag} ea_simple_packed select={select} prng={prng!r} "
                  f"n={N}: {PACKED_NGEN} generations in {wall:.3f} s = "
                  f"{PACKED_NGEN / wall:.2f} gens/s; mean fitness "
                  f"{start_mean:.3f} -> {float(fit.mean()):.3f}; K3 Philox "
                  f"launches {k3.hw_launches}, K4 {k4.hw_launches}")

    for prng in ("hw", "auto"):
        g, pk, fit = packed_start(29, N)
        start_mean = float(fit.mean())

        def evolve_loop():
            p, f = pk, fit
            for _ in range(EVOLVE_NGEN // EVOLVE_CALL):
                p, f = packed.evolve_packed(p, f, L, ngen=EVOLVE_CALL,
                                            prng=prng, generator=g, **probs)
            return p, f
        (p, f), wall = timed(evolve_loop)
        k5 = packed.evolve_packed
        if not k5.launches == k5.hw_launches == EVOLVE_NGEN // EVOLVE_CALL:
            fail(f"evolve_packed prng={prng!r}: launches {k5.launches} "
                 f"(Philox {k5.hw_launches}) for {EVOLVE_NGEN} generations")
        if not (torch.equal(f, packed.packed_fitness(p))
                and float(f.mean()) > start_mean + 10):
            fail(f"evolve_packed prng={prng!r}: fitness wrong or flat")
        if prng == "hw":
            report["k5_hw"]["launches"] = k5.hw_launches
        print(f"{tag} evolve_packed prng={prng!r} n={N}: {EVOLVE_NGEN} "
              f"generations in {EVOLVE_NGEN // EVOLVE_CALL} calls of "
              f"{EVOLVE_CALL} in {wall:.3f} s = {EVOLVE_NGEN / wall:.2f} "
              f"gens/s; mean fitness {start_mean:.3f} -> "
              f"{float(f.mean()):.3f}; K5 Philox launches {k5.hw_launches}")

    # ----------------------------------- 'hw' against 'input' in law --
    def fused_final(seed, prng):
        g, genomes, fit = onemax_start(1000 + seed, N)
        for _ in range(DIST_NGEN):
            genomes, fit = fused_onemax_generation(g, genomes, fit,
                                                   prng=prng)
        return fit

    def evolve_final(seed, prng):
        g, pk, fit = packed_start(2000 + seed, N)
        if prng == "input":
            return packed.evolve_packed(pk, fit, L, *packed.evolve_bits(
                g, DIST_NGEN, TOURNSIZE, N, W), **probs)[1]
        return packed.evolve_packed(pk, fit, L, ngen=DIST_NGEN, prng=prng,
                                    generator=g, **probs)[1]

    for name, final in (("fused OneMax", fused_final),
                        ("evolve_packed", evolve_final)):
        fits = {prng: [final(s, prng) for s in range(DIST_SEEDS)]
                for prng in ("hw", "input")}
        parts = []
        for stat, reduce in (("best", torch.amax), ("average", torch.mean)):
            a = [float(reduce(f)) for f in fits["hw"]]
            b = [float(reduce(f)) for f in fits["input"]]
            se = (statistics.variance(a) / DIST_SEEDS
                  + statistics.variance(b) / DIST_SEEDS) ** 0.5
            diff = abs(statistics.mean(a) - statistics.mean(b))
            if diff > 3 * se:
                fail(f"{name}: final {stat} fitness with prng='hw' "
                     f"({statistics.mean(a)}) and 'input' "
                     f"({statistics.mean(b)}) differ by {diff}, more than 3 "
                     f"standard errors ({se})")
            parts.append(f"{stat} {statistics.mean(a):.4f} against "
                         f"{statistics.mean(b):.4f} (3 SE {3 * se:.4f})")
        print(f"{tag} {name} n={N}, {DIST_NGEN} gens, {DIST_SEEDS} seeds, "
              f"prng='hw' against 'input': " + "; ".join(parts))

    # ------------------------------------------------ binned selector --
    # on the evolved population's fitness: 101 buckets, many ties
    flush = torch.empty(2**27, dtype=torch.int32, device=dev)  # 512 MB
    v = f.clone()
    w = v[:, None]
    want = lex_sort_desc(w)
    times = {"lex_sort_desc": time_ms(lambda: lex_sort_desc(w), flush)}
    for mode in ("scan", "mxu"):
        got = selection.counting_order_desc(v, 0, L, mode)
        if not bitwise_equal(got, want):
            fail(f"counting_order_desc(mode={mode!r}) differs from "
                 f"lex_sort_desc")
        times[mode] = time_ms(lambda: selection.counting_order_desc(
            v, 0, L, mode), flush)
    g1, g2 = make_generator(71, dev), make_generator(71, dev)
    if not bitwise_equal(selection.sel_tournament_binned(g1, w, N, TOURNSIZE,
                                                         0, L),
                         selection.sel_tournament_sorted(g2, w, N,
                                                         TOURNSIZE)):
        fail("sel_tournament_binned differs from sel_tournament_sorted")
    faster = min(("scan", "mxu"), key=times.get)
    print(f"{tag} counting_order_desc at n={N} over {L + 1} buckets: 'scan' "
          f"and 'mxu' == lex_sort_desc bitwise; sel_tournament_binned == "
          f"sel_tournament_sorted from one generator state; us "
          + ", ".join(f"{k} {t * 1e3:.2f}" for k, t in times.items())
          + f"; faster: {faster!r}; 'auto' takes "
          f"{selection.AUTO_COUNTING_MODE!r}")
    del flush


def real_hw_phases(torch, dev, tag, report, record):
    """Phase 13: K6's Philox path (``prng='hw'``) against its plain version
    on ``ops.philox.hw_real_bits``' streams, ``bench_suite.py``'s fused
    Rastrigin loop with ``'hw'`` and ``'auto'``, the memory a generation
    saves, and ``'hw'`` against ``'input'`` in distribution."""
    from deap_tpu_torch import ops
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.ops import kernels, kernels_real, philox

    flush = torch.empty(2**27, dtype=torch.int32, device=dev)  # 512 MB
    ra = dict(cxpb=RA_CXPB, mutpb=RA_MUTPB, indpb=RA_INDPB, alpha=RA_ALPHA,
              sigma=RA_SIGMA, evaluate="rastrigin")
    tol = dict(mutpb=RA_MUTPB, indpb=RA_INDPB, mu=0.0, sigma=RA_SIGMA)
    fn = kernels_real.fused_variation_eval_real
    gen = make_generator(73, dev)
    init = ops.uniform_genome(RA_DIM, RA_LOW, RA_UP)

    # ------------------------------------------------- K6 Philox path --
    worst = 0.0
    for n in (1001, RA_N):  # the main path's case last: the one timed
        genomes = init(gen, n)
        key = kernels.philox_key(gen)
        before = (fn.launches, fn.hw_launches)
        got = fn(genomes, prng="hw", key=key, **ra)
        if (fn.launches - before[0], fn.hw_launches - before[1]) != (1, 1):
            fail("fused_variation_eval_real(prng='hw') did not launch its "
                 "Philox path once")
        bits = philox.hw_real_bits(key, n, RA_DIM)
        want = kernels_real.fused_variation_eval_real_plain(genomes, *bits,
                                                            **ra)
        torch.cuda.synchronize()
        errs = kernels_real.real_kernel_errors(got, want, *bits, **tol)
        if not errs["ok"]:
            fail(f"fused_variation_eval_real(prng='hw') differs from the "
                 f"plain version on ops.philox's streams at n={n}: {errs}")
        worst = max(worst, errs["max_abs"], errs["max_fit_abs"])
        print(f"{tag} fused_variation_eval_real(prng='hw') vs plain on "
              f"ops.philox's streams at n={n}, L={RA_DIM}: "
              f"{errs['unmutated']} crossed or untouched genes bitwise; "
              f"{errs['mutated']} mutated genes within "
              f"{kernels_real.STEP_ULPS} ulp of the step + 1 of the gene, "
              f"largest {errs['max_ulps']} ulp ({errs['max_abs']:.3e} "
              f"absolute); fitness largest relative error "
              f"{errs['max_fit_rel']:.3e}")
    again = fn(genomes, prng="hw", key=key, **ra)
    other = fn(genomes, prng="hw", key=other_key(key), **ra)
    # the bits body on the same streams: one arithmetic, one sum order
    body = fn(genomes, *bits, **ra)
    for a, b, c, part in zip(got, again, body, ("children", "fitness")):
        if not bitwise_equal(a, b):
            fail(f"fused_variation_eval_real(prng='hw') twice with one key: "
                 f"{part} differ")
        if not bitwise_equal(a, c):
            fail(f"fused_variation_eval_real(prng='hw'): {part} differ from "
                 f"the bits body's on the same streams")
    if bitwise_equal(got[0], other[0]):
        fail("fused_variation_eval_real(prng='hw') gave the same children "
             "for two keys")
    # the Philox calls this run's decisions need: a pair+row call a row,
    # ceil(L/4) gamma calls a mating pair, ceil(L/4) gate calls a mutating
    # row, a normal call a mutated gene
    calls4 = -(-RA_DIM // 4)
    n_cx = pairs_mating(bits[0], RA_CXPB)
    n_mut = rows_below(bits[1], RA_MUTPB)
    calls = RA_N + calls4 * (n_cx + n_mut) + errs["mutated"]
    record("k6_hw", "fused_variation_eval_real (prng='hw')",
           "deap_tpu_torch/csrc/fused_variation_real.cu",
           "deap_tpu/ops/kernels_real.py:124", worst,
           time_ms(lambda: fn(genomes, prng="hw", key=key, **ra), flush),
           time_ms(lambda: kernels_real.fused_variation_eval_real_plain(
               genomes, *philox.hw_real_bits(key, RA_N, RA_DIM), **ra),
               flush),
           8 * RA_N * RA_DIM + 4 * RA_N, imads=PHILOX_IMADS * calls)
    copy_to = torch.empty_like(genomes)
    copy_ms = time_ms(lambda: copy_to.copy_(genomes), flush)
    print(f"  (of {RA_N} rows {n_mut} mutate, of {RA_N // 2} pairs {n_cx} "
          f"mate, {errs['mutated']} genes mutated: {calls} Philox calls; one "
          f"key twice bitwise equal, two keys differ; children and fitness "
          f"bitwise equal to the bits body's on the same streams; a torch "
          f"copy of the same {genomes.numel() * 4 / 1e6:.2f} MB genomes "
          f"{copy_ms * 1e3:.2f} us under the same timer)")
    print_ptxas("fused_variation_real", "real_tile_kernel<philox")
    del flush, copy_to

    # K6-hw's tiles of 64 rows: n below a tile, a partial tile, an odd
    # last row, one column chunk (L <= 32) and several, empty and full
    # lists, and each evaluation (none: a callable afterwards); each
    # against its plain version and the bits body on the same streams
    k6_shapes = [(n, length, {}, ("rastrigin", "sphere")[(n + length) % 2])
                 for n in (1, 2, 3, 63, 64, 65, 127, 129, 257, 1001)
                 for length in (1, 4, 30, 31, 33, 64, 100)]
    k6_shapes += [(257, length, {prob: value}, "rastrigin")
                  for length in (30, 70) for prob in ("cxpb", "mutpb", "indpb")
                  for value in (0.0, 1.0)]
    k6_shapes += [(1001, length, {}, kernels_real.eval_sphere)
                  for length in (30, 33)]
    k6_shapes += [(RA_N, length, {}, "sphere") for length in (4, 33, 100)]
    for n, length, probs, evaluate in k6_shapes:
        genomes = init(gen, n) if length == RA_DIM else (
            torch.rand((n, length), generator=gen, device=dev) * 10.24 - 5.12)
        key = kernels.philox_key(gen)
        kw = dict(ra, evaluate=evaluate, **probs)
        got = fn(genomes, prng="hw", key=key, **kw)
        bits = philox.hw_real_bits(key, n, length)
        want = kernels_real.fused_variation_eval_real_plain(genomes, *bits,
                                                            **kw)
        body = fn(genomes, *bits, **kw)
        torch.cuda.synchronize()
        errs = kernels_real.real_kernel_errors(
            got, want, *bits, **dict(tol, **{k: v for k, v in probs.items()
                                              if k in tol}))
        if not (errs["ok"] and bitwise_equal(got[0], body[0])
                and bitwise_equal(got[1], body[1])):
            fail(f"fused_variation_eval_real(prng='hw') at n={n}, L={length}, "
                 f"{probs}, evaluate={evaluate}: {errs}, bitwise against the "
                 f"bits body {bitwise_equal(got[0], body[0])}, "
                 f"{bitwise_equal(got[1], body[1])}")
    print(f"{tag} fused_variation_eval_real(prng='hw') == plain at K6's "
          f"tolerance and == the bits body bitwise at {len(k6_shapes)} "
          f"shapes: n 1, 2, 3, 63, 64, 65, 127, 129, 257, 1001 by L 1, 4, 30, "
          f"31, 33, 64, 100; cxpb, mutpb, indpb at 0 and 1; evaluation none; "
          f"n {RA_N} at L 4, 33, 100")

    # ------------------------------- the fused loop, 'hw' and 'auto' --
    def start(seed, n):
        g = make_generator(seed, dev)
        genomes = init(g, n)
        return g, genomes, kernels_real.eval_rastrigin(genomes)

    for prng in ("hw", "auto"):
        g, genomes, fit = start(37, RA_N)
        best0 = float(fit.min())
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RA_NGEN):
            genomes, fit = rastrigin_fused_generation(g, genomes, fit,
                                                      prng=prng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not fn.launches == fn.hw_launches == RA_NGEN:
            fail(f"fused Rastrigin loop (prng={prng!r}): K6 launches "
                 f"{fn.launches}, Philox {fn.hw_launches} in {RA_NGEN} "
                 f"generations")
        best = float(fit.min())
        check = kernels_real.eval_rastrigin(genomes)
        if not (bool(torch.isfinite(fit).all()) and best < best0
                and torch.allclose(fit, check, rtol=kernels_real.FIT_RTOL,
                                   atol=1e-3)):
            fail(f"fused Rastrigin loop (prng={prng!r}): fitness wrong or "
                 f"did not fall: best {best0} -> {best}")
        if prng == "hw":
            report["k6_hw"]["launches"] = fn.hw_launches
        print(f"{tag} fused Rastrigin loop prng={prng!r} n={RA_N} "
              f"dim={RA_DIM}: {RA_NGEN} generations in {wall:.3f} s = "
              f"{RA_NGEN / wall:.2f} gens/s; best {best0:.4f} -> "
              f"{best:.4f}, mean {float(fit.mean()):.4f}; K6 launches "
              f"{fn.launches}, Philox {fn.hw_launches}")

    # ------------------------------------------- memory of a generation --
    def peak(prng):
        g, genomes, fit = start(79, RA_N)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        rastrigin_fused_generation(g, genomes, fit, prng=prng)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base
    mem = {prng: peak(prng) for prng in ("input", "hw")}
    print(f"{tag} peak device memory of one fused Rastrigin generation at "
          f"n={RA_N} above what was allocated before: prng='input' "
          f"{mem['input'] / 1e6:.3f} MB (its draws included), 'hw' "
          f"{mem['hw'] / 1e6:.3f} MB")

    # ----------------------------------- 'hw' against 'input' in law --
    def final(seed, prng):
        g, genomes, fit = start(3000 + seed, RA_N)
        for _ in range(DIST_NGEN):
            genomes, fit = rastrigin_fused_generation(g, genomes, fit,
                                                      prng=prng)
        return fit

    fits = {prng: [final(s, prng) for s in range(DIST_SEEDS)]
            for prng in ("hw", "input")}
    parts = []
    for stat, reduce in (("best", torch.amin), ("average", torch.mean)):
        a = [float(reduce(f)) for f in fits["hw"]]
        b = [float(reduce(f)) for f in fits["input"]]
        se = (statistics.variance(a) / DIST_SEEDS
              + statistics.variance(b) / DIST_SEEDS) ** 0.5
        diff = abs(statistics.mean(a) - statistics.mean(b))
        if diff > 3 * se:
            fail(f"fused Rastrigin: final {stat} fitness with prng='hw' "
                 f"({statistics.mean(a)}) and 'input' ({statistics.mean(b)}) "
                 f"differ by {diff}, more than 3 standard errors ({se})")
        parts.append(f"{stat} {statistics.mean(a):.4f} against "
                     f"{statistics.mean(b):.4f} (3 SE {3 * se:.4f})")
    print(f"{tag} fused Rastrigin n={RA_N}, {DIST_NGEN} gens, {DIST_SEEDS} "
          f"seeds, prng='hw' against 'input': " + "; ".join(parts))


def cma_phases(torch, dev, tag, report, record):
    """Phase 14: ``bench_suite.py``'s cmaes_n100_lam4096, Hansen CMA-ES on
    sphere, through ``ea_generate_update`` and as the bare generate /
    evaluate / update loop ``bench_suite.bench_cmaes`` runs; one update on
    the card against the same update on the CPU."""
    from deap_tpu_torch import Toolbox, algorithms, benchmarks, convert
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.strategies import cma
    from deap_tpu_torch.support.stats import fitness_stats

    if not (torch.get_float32_matmul_precision() == "highest"
            and not torch.backends.cuda.matmul.allow_tf32):
        fail("float32 matmuls are not at full precision (TF32 is on)")
    args = (torch.full((CMA_DIM,), CMA_START),)
    kw = dict(sigma=CMA_SIGMA, lambda_=CMA_LAMBDA)
    strat = cma.Strategy(*args, **kw, device=dev)
    tb = Toolbox()
    tb.register("evaluate", benchmarks.sphere)
    tb.register("generate", strat.generate)
    tb.register("update", strat.update)

    def bare(g, st, ngen):
        for _ in range(ngen):
            pop = strat.generate(g, st)
            st = strat.update(st, pop, benchmarks.sphere(pop))
        return st

    # warm-up: the first calls load cuBLAS, cuSOLVER and the kernels
    algorithms.ea_generate_update(
        make_generator(1, dev), strat.initial_state(), tb, 3, strat.spec,
        stats=fitness_stats(), halloffame_size=1, device=dev)
    bare(make_generator(1, dev), strat.initial_state(), 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, logbook, hof = algorithms.ea_generate_update(
        make_generator(83, dev), strat.initial_state(), tb, CMA_NGEN,
        strat.spec, stats=fitness_stats(), halloffame_size=1, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mins = logbook.select("min")
    C = state.C
    asym = float((C - C.T).abs().max() / C.abs().max())
    recon = cma.reconstruction_error(state)
    if not (len(logbook) == CMA_NGEN and mins[-1] < mins[0]
            and float(hof.fitness[0, 0]) == min(mins)
            and bool(torch.isfinite(C).all()) and asym <= 1e-5
            and recon <= cma.RECON_TOL):
        fail(f"CMA-ES through ea_generate_update: best {mins[0]} -> "
             f"{mins[-1]}, hall of fame {float(hof.fitness[0, 0])}, C "
             f"asymmetry {asym}, reconstruction {recon}")
    print(f"{tag} CMA-ES ea_generate_update dim={CMA_DIM} "
          f"lambda={CMA_LAMBDA} on sphere: {CMA_NGEN} generations in "
          f"{wall:.3f} s = {CMA_NGEN / wall:.2f} gens/s "
          f"({wall / CMA_NGEN * 1e3:.3f} ms/gen, logbook and hall of fame "
          f"included); best {mins[0]:.4f} "
          f"-> {mins[-1]:.4f}; sigma {float(state.sigma):.5f}, cond "
          f"{float(state.cond):.4f}; C symmetric to {asym:.2e} of its "
          f"largest entry, ||B D^2 B^T - C|| / ||C|| = {recon:.3e}")

    g = make_generator(89, dev)
    st = strat.initial_state()
    best0 = float(benchmarks.sphere(strat.generate(g, st)).min())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = bare(g, st, CMA_NGEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    best = float(benchmarks.sphere(strat.generate(g, st)).min())
    if not (best < best0 and bool(torch.isfinite(st.C).all())):
        fail(f"CMA-ES bare loop: best {best0} -> {best}")
    print(f"{tag} CMA-ES bare generate/evaluate/update loop (bench_suite's "
          f"bench_cmaes), after 3 of warm-up like the loop above: "
          f"{CMA_NGEN} generations in {wall:.3f} s = "
          f"{CMA_NGEN / wall:.2f} gens/s ({wall / CMA_NGEN * 1e3:.3f} "
          f"ms/gen); sampled best {best0:.4f} -> {best:.4f}")

    # one update on the card against the same update on the CPU
    genomes = strat.generate(g, st)
    values = benchmarks.sphere(genomes)
    got = strat.update(st, genomes, values)
    cpu = cma.Strategy(*args, **kw, device="cpu")
    want = cpu.update(convert.cma_state_from_arrays(
        **convert.cma_state_to_arrays(st), device="cpu"), genomes.cpu(),
        values.cpu())
    got_cpu = convert.cma_state_from_arrays(
        **convert.cma_state_to_arrays(got), device="cpu")
    errs = cma.state_errors(got_cpu, want)
    if not errs["ok"]:
        fail(f"CMA-ES update on the card differs from it on the CPU: {errs}")
    print(f"{tag} CMA-ES update on the card == on the CPU within the stated "
          f"tolerances: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()
                                      if k != "ok"))


def mu_lambda_phases(torch, dev, tag, report):
    """Phase 15: ``var_or`` through K1 and the (μ + λ) / (μ, λ) loops,
    fctmin's ES and kursawefct's NSGA-II. Adds K1's launches on these
    loops and its times at ``var_or``'s shapes to K1's line."""
    from deap_tpu_torch import FitnessSpec, Toolbox, algorithms, mo, ops
    from deap_tpu_torch.core.population import init_population
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.ops import kernels, variation
    from deap_tpu_torch.support.stats import fitness_stats

    # ------------------------------------ K1 at var_or's masks and shapes --
    flush = torch.empty(2**27, dtype=torch.int32, device=dev)  # 512 MB
    rate = memory_rate(torch.cuda.get_device_name(0))
    for cases, (lam, n_par, dtype, kind) in enumerate(k1_var_or_shapes()):
        args = var_or_k1_inputs(torch, dev, 61 + cases, lam, n_par, dtype,
                                kind)
        got = kernels.fused_variation(*args, mut_kind=kind)
        want = variation.apply_variation(*args, kind).to(dtype)
        torch.cuda.synchronize()
        if not bitwise_equal(got, want):
            fail(f"fused_variation differs from apply_variation on var_or's "
                 f"masks at λ={lam}, N={n_par}, {dtype}, {kind}")
    print(f"{tag} fused_variation == apply_variation bitwise on var_or_masks "
          f"at {cases + 1} shapes (λ 1, 63, 64, 1000, {N} by N 2, 48, "
          f"{MU_COMMA}, {N}; bool flip, float32 add and set)")
    var_or_times = {}
    for n_par in (MU_COMMA, N):
        args = var_or_k1_inputs(torch, dev, 59, N, n_par, torch.bool, "flip")
        g, base, partner, cx, _, _, mut = args[:7]
        # what these masks need: the distinct parent rows read (base rows,
        # and the partner rows of mating children) once, the children out,
        # the gene mask of mutating children, base/cx/mut of every child
        # and partner/lo/hi of mating children
        rows = torch.unique(torch.cat([base, partner[cx]])).numel()
        n_mut, n_cx = int(mut.sum()), int(cx.sum())
        nbytes = rows * L + N * L + n_mut * L + 6 * N + 12 * n_cx
        ms = time_ms(lambda: kernels.fused_variation(*args, mut_kind="flip"),
                     flush)
        plain_ms = time_ms(lambda: variation.apply_variation(*args, "flip"),
                           flush)
        var_or_times[f"lambda{N}_N{n_par}"] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": nbytes / rate * 1e3}
        print(f"{tag} fused_variation on var_or's masks, λ={N} from N="
              f"{n_par}, bool flip: {ms * 1e3:.2f} us (bound "
              f"{nbytes / rate * 1e6:.2f} us by bytes: {nbytes / 1e6:.2f} MB, "
              f"{rows} distinct parent rows read, {n_cx} children mate, "
              f"{n_mut} mutate; plain {plain_ms * 1e3:.2f} us)")
    del flush

    # --------------------------------------- the (mu + lambda) / (mu, lambda)
    tb = _onemax_toolbox(Toolbox, ops)
    spec = FitnessSpec((1.0,))
    var_or_launches = 0
    for name, run, mu in (("ea_mu_plus_lambda", algorithms.ea_mu_plus_lambda,
                           N),
                          ("ea_mu_comma_lambda",
                           algorithms.ea_mu_comma_lambda, MU_COMMA)):
        def onemax(seed, ngen, fused):
            g = make_generator(seed, dev)
            pop = init_population(g, mu, ops.bernoulli_genome(L), spec,
                                  device=dev)
            return run(g, pop, tb, mu, N, CXPB, MUTPB, ngen,
                       stats=fitness_stats(), halloffame_size=1, fused=fused,
                       device=dev)

        runs = {}
        for fused in ("kernel", "plain", False):
            onemax(43, 1, fused)  # warm-up generation
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pop, logbook, hof = onemax(47, MU_NGEN, fused)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernels.fused_variation.launches
            if launches != (MU_NGEN if fused == "kernel" else 0):
                fail(f"{name}(fused={fused!r}) launched K1 {launches} times "
                     f"in {MU_NGEN} generations")
            if fused == "kernel":
                var_or_launches += launches
            maxes = logbook.select("max")
            if not (pop.fitness.shape == (mu, 1) and bool(pop.valid.all())
                    and torch.equal(pop.fitness[:, 0],
                                    pop.genomes.sum(-1).to(torch.float32))
                    and float(hof.fitness[0, 0]) >= max(maxes)
                    and logbook[-1]["avg"] > logbook[0]["avg"]):
                fail(f"{name}(fused={fused!r}): population, fitness or hall "
                     f"of fame is wrong, or the average did not climb")
            runs[fused] = (pop, logbook, hof)
            print(f"{tag} {name} OneMax mu={mu} lambda={N} L={L} "
                  f"fused={fused!r}: {MU_NGEN} generations in {wall:.3f} s "
                  f"incl. gen-0 evaluation = {wall / MU_NGEN * 1e3:.3f} "
                  f"ms/gen; max {maxes[0]} -> {maxes[-1]}, avg "
                  f"{logbook[0]['avg']:.3f} -> {logbook[-1]['avg']:.3f}; K1 "
                  f"launches {launches}")
        (pop, logbook, hof) = runs["kernel"]
        for fused in ("plain", False):
            other = runs[fused]
            if not (all(bitwise_equal(getattr(pop, f), getattr(other[0], f))
                        for f in ("genomes", "fitness", "valid"))
                    and all(bitwise_equal(getattr(hof, f),
                                          getattr(other[2], f))
                            for f in ("genomes", "fitness", "filled"))
                    and list(logbook) == list(other[1])):
                fail(f"{name}: the run with fused={fused!r} differs from the "
                     f"run through K1")
        print(f"{tag} {name}: populations, halls of fame and logbooks "
              f"bitwise equal with fused='kernel', 'plain' and False")
    report["k1"]["var_or_launches"] = var_or_launches
    report["k1"]["var_or"] = var_or_times

    # --------------------------------------------------------- fctmin ES --
    g = make_generator(53, dev)
    pop = init_population(g, FCT_MU, fctmin_init, FitnessSpec((-1.0,)),
                          device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pop, logbook, _ = algorithms.ea_mu_comma_lambda(
        g, pop, fctmin_toolbox(), FCT_MU, FCT_LAMBDA, 0.6, 0.3, FCT_NGEN,
        stats=fitness_stats(), device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mins = logbook.select("min")
    best = float(-pop.wvalues.max())
    if not (math.isfinite(best) and best < mins[0]
            and float(pop.genomes["strategy"].min()) >= FCT_MIN_STRATEGY):
        fail(f"fctmin's ES: best {mins[0]} -> {best}")
    print(f"{tag} fctmin (mu, lambda) ES mu={FCT_MU} lambda={FCT_LAMBDA} "
          f"dim={FCT_DIM}: {FCT_NGEN} generations in {wall:.3f} s; best "
          f"sphere {mins[0]:.4f} -> {best:.6f}")

    # ------------------------------------------------- kursawefct NSGA-II --
    g = make_generator(59, dev)
    pop = init_population(g, KUR_N, ops.uniform_genome(3, -5.0, 5.0),
                          FitnessSpec((-1.0, -1.0)), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pop, logbook, _ = algorithms.ea_mu_plus_lambda(
        g, pop, kursawe_toolbox(), KUR_N, KUR_N, 0.5, 0.3, KUR_NGEN,
        device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    nd = int(mo.nondominated_mask(pop.wvalues).sum())
    if not (bool(torch.isfinite(pop.fitness).all()) and nd >= 1
            and len(logbook) == KUR_NGEN + 1):
        fail(f"kursawefct's NSGA-II: {nd} non-dominated")
    print(f"{tag} kursawefct (mu + lambda) NSGA-II n={KUR_N}: {KUR_NGEN} "
          f"generations in {wall:.3f} s; {nd} of {KUR_N} non-dominated")


def strategy_phases(torch, dev, tag, report):
    """Phase 16: J1 (the Jacobi eigensolver) against its plain version,
    bitwise, at ``j1_shapes`` on ``j1_inputs`` and timed; cmaes_n100_lam4096
    with ``eigh_impl='jacobi'`` beside ``'lapack'``; the (1+λ)-CMA-ES,
    MO-CMA-ES and BIPOP gates. Adds J1's line to the report."""
    from deap_tpu_torch import Toolbox, _build, algorithms, benchmarks
    from deap_tpu_torch import convert
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.native import hypervolume
    from deap_tpu_torch.ops import linalg
    from deap_tpu_torch.strategies import (
        StrategyMultiObjective, StrategyOnePlusLambda, bipop_cmaes, cma)
    from deap_tpu_torch.support.stats import fitness_stats

    # ------------------------ CMA-ES, 'lapack' then 'jacobi', same phase --
    args = (torch.full((CMA_DIM,), CMA_START),)
    kw = dict(sigma=CMA_SIGMA, lambda_=CMA_LAMBDA)
    runs = {}
    for impl in ("lapack", "jacobi"):
        strat = cma.Strategy(*args, **kw, eigh_impl=impl, device=dev)
        tb = Toolbox()
        tb.register("evaluate", benchmarks.sphere)
        tb.register("generate", strat.generate)
        tb.register("update", strat.update)
        algorithms.ea_generate_update(  # warm-up
            make_generator(1, dev), strat.initial_state(), tb, 3, strat.spec,
            stats=fitness_stats(), halloffame_size=1, device=dev)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, logbook, hof = algorithms.ea_generate_update(
            make_generator(83, dev), strat.initial_state(), tb, CMA_NGEN,
            strat.spec, stats=fitness_stats(), halloffame_size=1, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = linalg.eigh_jacobi.launches
        reset_counts()
        g = make_generator(89, dev)
        st = strat.initial_state()
        best0 = float(benchmarks.sphere(strat.generate(g, st)).min())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CMA_NGEN):
            pop = strat.generate(g, st)
            st = strat.update(st, pop, benchmarks.sphere(pop))
        torch.cuda.synchronize()
        bare = time.perf_counter() - t0
        bare_launches = linalg.eigh_jacobi.launches
        best = float(benchmarks.sphere(strat.generate(g, st)).min())
        mins = logbook.select("min")
        C = state.C
        asym = float((C - C.T).abs().max() / C.abs().max())
        recon = cma.reconstruction_error(state)
        want = CMA_NGEN + 1 if impl == "jacobi" else 0
        if not (len(logbook) == CMA_NGEN and mins[-1] < mins[0]
                and float(hof.fitness[0, 0]) == min(mins)
                and bool(torch.isfinite(C).all()) and asym <= 1e-5
                and recon <= cma.RECON_TOL and best < best0
                and bool(torch.isfinite(st.C).all())):
            fail(f"CMA-ES eigh_impl={impl!r}: best {mins[0]} -> {mins[-1]}, "
                 f"hall of fame {float(hof.fitness[0, 0])}, C asymmetry "
                 f"{asym}, reconstruction {recon}, bare loop {best0} -> "
                 f"{best}")
        if launches != want or bare_launches != want:
            fail(f"CMA-ES eigh_impl={impl!r}: J1 launched {launches} and "
                 f"{bare_launches} times in {CMA_NGEN} generations and "
                 f"initial_state")
        runs[impl] = (strat, st, wall, bare, launches)
        print(f"{tag} CMA-ES eigh_impl={impl!r} dim={CMA_DIM} "
              f"lambda={CMA_LAMBDA}: ea_generate_update {CMA_NGEN} gens "
              f"{wall / CMA_NGEN * 1e3:.3f} ms/gen, bare loop "
              f"{bare / CMA_NGEN * 1e3:.3f} ms/gen; best {mins[0]:.4f} -> "
              f"{mins[-1]:.4f}; C symmetric to {asym:.2e}, reconstruction "
              f"{recon:.3e}; J1 launches {launches} and {bare_launches} "
              f"(generations + initial_state)")
    print(f"{tag} CMA-ES ms/gen, 'jacobi' against 'lapack' in one call: "
          f"ea_generate_update {runs['jacobi'][2] / CMA_NGEN * 1e3:.3f} vs "
          f"{runs['lapack'][2] / CMA_NGEN * 1e3:.3f}, bare loop "
          f"{runs['jacobi'][3] / CMA_NGEN * 1e3:.3f} vs "
          f"{runs['lapack'][3] / CMA_NGEN * 1e3:.3f}")

    # one 'jacobi' update on the card against the same update on the CPU
    strat, st, *_, report_launches = runs["jacobi"]
    genomes = strat.generate(make_generator(97, dev), st)
    values = benchmarks.sphere(genomes)
    got = strat.update(st, genomes, values)
    cpu = cma.Strategy(*args, **kw, eigh_impl="jacobi", device="cpu")
    want = cpu.update(convert.cma_state_from_arrays(
        **convert.cma_state_to_arrays(st), device="cpu"), genomes.cpu(),
        values.cpu())
    errs = cma.state_errors(convert.cma_state_from_arrays(
        **convert.cma_state_to_arrays(got), device="cpu"), want)
    if not errs["ok"]:
        fail(f"'jacobi' CMA-ES update on the card differs from it on the "
             f"CPU: {errs}")
    print(f"{tag} 'jacobi' CMA-ES update on the card == on the CPU within "
          f"the stated tolerances: " + ", ".join(
              f"{k} {v:.3g}" for k, v in errs.items() if k != "ok"))

    # ---------------------------------- J1 against its plain version --
    cma_C = runs["lapack"][1].C
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst, cases = 0.0, 0
    for d, batch in j1_shapes(sms):
        inputs = j1_inputs(torch, dev, d, batch, cma_C)
        got = [linalg.eigh_jacobi(C) for C in inputs.values()]
        want = linalg.eigh_jacobi_plain(torch.cat(list(inputs.values())))
        torch.cuda.synchronize()
        for k, (name, (w, V)) in enumerate(zip(inputs, got)):
            ws = want[0][k * batch:(k + 1) * batch]
            Vs = want[1][k * batch:(k + 1) * batch]
            if not (bitwise_equal(w, ws) and bitwise_equal(V, Vs)):
                fail(f"eigh_jacobi differs from its plain version at d={d}, "
                     f"batch={batch}, input {name}: max_abs_err "
                     f"{max(max_abs_err(w, ws), max_abs_err(V, Vs))}")
            worst = max(worst, max_abs_err(w, ws), max_abs_err(V, Vs))
            cases += 1
    print(f"{tag} eigh_jacobi == eigh_jacobi_plain bitwise at {cases} cases "
          f"(d {', '.join(map(str, J1_DIMS))} by batch 1 and 3, those from "
          f"{linalg.J1_SPLIT_MIN_D} to {linalg.J1_SHARED_MAX_D} also by "
          f"batch {sms // 2 + 1} on one SM each, and "
          f"{' and '.join(f'[{b}, {d}]' for b, d in J1_BUCKETS)}; random "
          f"SPD, identity, repeated diagonal, an off-diagonal below tiny, "
          f"CMA-ES's C): worst max_abs_err {worst}; shared memory up to d "
          f"{linalg.J1_SHARED_MAX_D}, device memory above")
    print_ptxas("jacobi_eigh", "jacobi_rounds_kernel")

    flush = torch.empty(2**27, dtype=torch.int32, device=dev)  # 512 MB
    # J1's phase clock: a -DDTT_J1_PHASES build, bitwise equal to J1
    import port_profile
    split = port_profile.j1_phases(dev, flush, shapes=J1_PHASE_SHAPES)
    for name in J1_PHASE_SHAPES:
        head = f"{name}_clocks_per_round_"
        print(f"{tag} J1's phase clock, {name}, SM clocks a round of a "
              f"block (thread 0 of the A warps, the first V thread): "
              + ", ".join(f"{k.removeprefix(head)} {v:.1f}"
                          for k, v in split.items() if k.startswith(head))
              + "; the instrumented call "
              f"{split[f'{name}_phases_ms'] * 1e3:.2f} us")
    rate = memory_rate(torch.cuda.get_device_name(0))
    flops_per_sm = FP32_FLOPS_PER_SM_CLOCK * max_sm_clock_hz()
    times = {}
    for shape in ((CMA_DIM, CMA_DIM),) + tuple((b, d, d)
                                               for b, d in J1_BUCKETS):
        d = shape[-1]
        nmat = math.prod(shape[:-2])
        C = j1_inputs(torch, dev, d, nmat, cma_C)["spd"].reshape(shape)
        ms = time_ms(lambda: linalg.eigh_jacobi(C), flush)
        plain_ms = time_ms(lambda: linalg.eigh_jacobi_plain(C), flush, reps=3)
        library_ms = time_ms(lambda: torch.linalg.eigh(C), flush)
        ops = j1_flops(d) * nmat
        nbytes = nmat * (2 * d * d + d) * 4
        # the SMs the launch can use: two a matrix where J1 splits
        used = linalg.j1_sms(d, nmat, sms)
        ops_ms = ops / (used * flops_per_sm) * 1e3
        bytes_ms = nbytes / rate * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        times[str(list(shape))] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
        print(f"{tag} eigh_jacobi {list(shape)}: {ms * 1e3:.2f} us (bound "
              f"{bound_ms * 1e3:.2f} us by operations: {ops:.3e} float32 "
              f"operations on {used} SMs, {nbytes / 1e6:.3f} MB; "
              f"plain {plain_ms * 1e3:.1f} us, its launches timed from the "
              f"host; torch.linalg.eigh {library_ms * 1e3:.2f} us)")
    del flush
    main = times[str([CMA_DIM, CMA_DIM])]
    report["j1"] = {"name": "eigh_jacobi", "route": "cuda",
                    "source": "deap_tpu_torch/csrc/jacobi_eigh.cu",
                    "replaces": "deap_tpu/ops/linalg.py:62",
                    "launches": report_launches, "max_abs_err": worst,
                    "ms": main["ms"], "plain_ms": main["plain_ms"],
                    "bound_ms": main["bound_ms"],
                    "bound_by": main["bound_by"],
                    "library_ms": main["library_ms"],
                    "batched": {k: v for k, v in times.items()
                                if k != str([CMA_DIM, CMA_DIM])}}

    # --------------------------------------------------- (1+λ)-CMA-ES --
    parent = torch.full((OPL_DIM,), 2.0, device=dev)
    strat = StrategyOnePlusLambda(parent, benchmarks.sphere(parent[None]),
                                  sigma=1.0, lambda_=OPL_LAMBDA, device=dev)
    tb = Toolbox()
    tb.register("evaluate", benchmarks.sphere)
    tb.register("generate", strat.generate)
    tb.register("update", strat.update)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, logbook, _ = algorithms.ea_generate_update(
        make_generator(11, dev), strat.initial_state(), tb, OPL_NGEN,
        strat.spec, device=dev)
    best = float(-state.parent_w[0])
    wall = time.perf_counter() - t0
    if not (best < OPL_GATE and len(logbook) == OPL_NGEN
            and bool(torch.isfinite(state.A).all())):
        fail(f"(1+lambda)-CMA-ES on sphere: best {best}")
    print(f"{tag} (1+lambda)-CMA-ES sphere N={OPL_DIM} lambda={OPL_LAMBDA}: "
          f"{OPL_NGEN} generations in {wall:.3f} s = "
          f"{wall / OPL_NGEN * 1e3:.3f} ms/gen; best {best:.3e} "
          f"(gate < {OPL_GATE})")

    # ------------------------------------------------------- MO-CMA-ES --
    def zdt1_run(seed, mu, dim, ngen):
        g = make_generator(seed, dev)
        x0 = torch.rand((mu, dim), generator=g, device=dev)
        strat = StrategyMultiObjective(x0, benchmarks.zdt1(x0), sigma=0.05,
                                       mu=mu, lambda_=mu, device=dev)
        tb = Toolbox()
        tb.register("evaluate",
                    lambda gen: benchmarks.zdt1(gen["x"].clamp(0, 1)))
        tb.register("generate", strat.generate)
        tb.register("update", strat.update)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _, _ = algorithms.ea_generate_update(
            g, strat.initial_state(), tb, ngen, strat.spec, device=dev)
        torch.cuda.synchronize()
        return state, time.perf_counter() - t0

    state, wall = zdt1_run(128, MOC_MU, MOC_DIM, MOC_NGEN)
    front = benchmarks.zdt1(state.x.clamp(0, 1)).cpu().numpy()
    hv = hypervolume(front, [11.0, 11.0])
    if not (hv > MOC_HV_GATE and (front[:, 0] >= 0).all()
            and (front[:, 0] <= 1).all()):
        fail(f"MO-CMA-ES on ZDT1: hypervolume {hv}")
    print(f"{tag} MO-CMA-ES ZDT1 mu=lambda={MOC_MU} dim={MOC_DIM}: "
          f"{MOC_NGEN} generations in {wall:.3f} s = "
          f"{wall / MOC_NGEN * 1e3:.3f} ms/gen; hypervolume of [11, 11] "
          f"{hv:.4f} (gate > {MOC_HV_GATE})")
    state, wall = zdt1_run(7, MOC_WIDE_MU, MOC_WIDE_DIM, MOC_WIDE_NGEN)
    if not bool(torch.isfinite(state.A).all()):
        fail("MO-CMA-ES at mu 100: a Cholesky factor is not finite")
    print(f"{tag} MO-CMA-ES ZDT1 mu=lambda={MOC_WIDE_MU} "
          f"dim={MOC_WIDE_DIM} (examples/es/cma_mo.py's width): "
          f"{MOC_WIDE_NGEN} generations in {wall:.3f} s = "
          f"{wall / MOC_WIDE_NGEN * 1e3:.3f} ms/gen")

    # ----------------------------------------------------------- BIPOP --
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best_x, best_f, logbooks = bipop_cmaes(
        make_generator(12, dev), lambda x: (x * x).sum(-1), dim=BIPOP_DIM,
        sigma0=2.0, nrestarts=BIPOP_RESTARTS, device=dev)
    wall = time.perf_counter() - t0
    gens = sum(len(lb) for lb in logbooks)
    if not (best_f < BIPOP_GATE and len(logbooks) >= 2
            and best_x.shape == (BIPOP_DIM,)):
        fail(f"BIPOP-CMA-ES on sphere: best {best_f}, {len(logbooks)} "
             f"logbooks")
    print(f"{tag} BIPOP-CMA-ES sphere dim={BIPOP_DIM} "
          f"nrestarts={BIPOP_RESTARTS}: {len(logbooks)} runs, {gens} "
          f"generations in {wall:.3f} s = {wall / gens * 1e3:.3f} ms/gen; "
          f"best {best_f:.3e} (gate < {BIPOP_GATE})")


def swarm_nsga3_phases(torch, dev, tag, report):
    """Phase 17: the rest of the strategies and NSGA-III / dense SPEA2 —
    the JAX package's gates, the reference examples timed, then NSGA-III
    at mu 50,000 through K7 (from a random start and on a converged
    union), DE and PSO at pop 100k and dense SPEA2 at 2,000 rows. Adds
    NSGA-III's K7 launches to K7's line. The card-against-CPU checks of
    each step are ``tests/test_torch_a6_cuda.py``."""
    from deap_tpu_torch import Toolbox, algorithms, benchmarks, mo, ops
    from deap_tpu_torch.core.fitness import FitnessSpec
    from deap_tpu_torch.core.population import init_population
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.mo import emo
    from deap_tpu_torch.native import hypervolume
    from deap_tpu_torch.ops import kernels
    from deap_tpu_torch.ops.linalg import norm_rn
    from deap_tpu_torch.strategies import (
        EMNA, PBIL, PSO, DifferentialEvolution, MultiSwarmPSO,
        SpeciationPSO)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def gate(what, ok, detail, wall, gens):
        if not ok:
            fail(f"{what}: {detail}")
        print(f"{tag} {what}: {gens} generations in {wall:.3f} s = "
              f"{wall / gens * 1e3:.3f} ms/gen; {detail}")

    def monotone(traj):
        return bool((traj[1:] >= traj[:-1]).all())

    # ----------------------------------------- the JAX package's gates --
    de = DifferentialEvolution(benchmarks.sphere, F=1.0, CR=0.25)
    g = make_generator(2, dev)
    pop = init_population(g, DE_N, ops.uniform_genome(DE_DIM, -3.0, 3.0),
                          FitnessSpec((-1.0,)), device=dev)
    (pop, traj), wall = timed(lambda: de.run(g, pop, DE_NGEN))
    best = float(-pop.wvalues[:, 0].max())
    gate(f"DE sphere n={DE_N} dim={DE_DIM}", best < DE_GATE
         and monotone(traj), f"best {best:.3e} (gate < {DE_GATE}), "
         f"monotone {monotone(traj)}", wall, DE_NGEN)

    pso = PSO(benchmarks.h1, smin=0.001, smax=3.0, device=dev)
    g = make_generator(9, dev)
    s = pso.init(g, PSO_N, 2, pmin=-6.0, pmax=6.0, smin=-3.0, smax=3.0)
    (s, traj), wall = timed(lambda: pso.run(g, s, PSO_NGEN))
    best = float(s.gbest_w[0])
    gate(f"PSO h1 n={PSO_N}", best > PSO_GATE and monotone(traj),
         f"gbest {best:.5f} (gate > {PSO_GATE}), monotone "
         f"{monotone(traj)}", wall, PSO_NGEN)

    pbil = PBIL(ndim=PBIL_DIM, learning_rate=0.3, mut_prob=0.1,
                mut_shift=0.05, lambda_=PBIL_LAMBDA, device=dev)
    tb = Toolbox()
    tb.register("evaluate", lambda x: x.sum(-1))
    tb.register("generate", pbil.generate)
    tb.register("update", pbil.update)
    (_, _, hof), wall = timed(lambda: algorithms.ea_generate_update(
        make_generator(1, dev), pbil.initial_state(make_generator(2, dev)),
        tb, PBIL_NGEN, pbil.spec, halloffame_size=1, device=dev))
    best = float(hof.fitness[0, 0])
    gate(f"PBIL OneMax L={PBIL_DIM} lambda={PBIL_LAMBDA}",
         best >= PBIL_GATE, f"hall of fame {best} (gate >= {PBIL_GATE})",
         wall, PBIL_NGEN)

    emna = EMNA(centroid=[5.0] * EMNA_DIM, sigma=5.0, mu=EMNA_LAMBDA // 4,
                lambda_=EMNA_LAMBDA, device=dev)
    tb = Toolbox()
    tb.register("evaluate", benchmarks.sphere)
    tb.register("generate", emna.generate)
    tb.register("update", emna.update)
    (_, _, hof), wall = timed(lambda: algorithms.ea_generate_update(
        make_generator(4, dev), emna.initial_state(), tb, EMNA_NGEN,
        emna.spec, halloffame_size=1, device=dev))
    best = float(hof.fitness[0, 0])
    gate(f"EMNA sphere N={EMNA_DIM} lambda={EMNA_LAMBDA}", best < EMNA_GATE,
         f"best {best:.3e} (gate < {EMNA_GATE})", wall, EMNA_NGEN)

    ms = MultiSwarmPSO(two_peaks, pmin=-6.0, pmax=6.0, rcloud=0.5,
                       device=dev)
    g = make_generator(0, dev)
    s = ms.init(g, nswarms=3, nparticles=8, dim=2, capacity=8)

    def ms_run(s):
        for _ in range(MS_STEPS):
            s = ms.step(g, s)
        return s
    s, wall = timed(lambda: ms_run(s))
    best = float(ms.best(s)[1])
    gate("multi-swarm PSO two peaks, 3 swarms of 8 in 8 slots",
         best > PEAK_GATE and int(s.nevals) > 0,
         f"best {best:.4f} (gate > {PEAK_GATE}), {int(s.active.sum())} "
         f"swarms", wall, MS_STEPS)

    sp = SpeciationPSO(two_peaks, pmin=-6.0, pmax=6.0, rs=3.0, pmax_size=10,
                       device=dev)
    g = make_generator(8, dev)
    s = sp.init(g, n=SP_N, dim=2)

    def sp_run(s):
        for _ in range(SP_STEPS):
            s = sp.step(g, s)
        return s
    s, wall = timed(lambda: sp_run(s))
    best = float(s.pbest_f.max())
    near = float(norm_rn(s.pbest_x - 3.0).min())
    gate(f"speciation PSO two peaks n={SP_N}", best > PEAK_GATE
         and near < 1.5, f"best {best:.4f} (gate > {PEAK_GATE}), nearest "
         f"to the second peak {near:.4f} (gate < 1.5)", wall, SP_STEPS)

    pop, wall = timed(lambda: nsga3_zdt1_run(make_generator(12, dev), dev))
    hv = hypervolume(pop.fitness.cpu().numpy(), [11.0, 11.0])
    gate(f"NSGA-III ZDT1 mu={N3_MU} dim={N3_DIM} p={N3_P}",
         hv > N3_HV_GATE and float(pop.genomes.min()) >= 0.0
         and float(pop.genomes.max()) <= 1.0,
         f"hypervolume of [11, 11] {hv:.4f} (gate > {N3_HV_GATE})", wall,
         N3_NGEN)

    # ------------------------------------ the reference examples, timed --
    for name, fn in (("examples/pso/multiswarm.py", multiswarm_example),
                     ("examples/pso/speciation.py", speciation_example),
                     ("examples/de/dynamic.py", de_dynamic_example),
                     ("examples/ga/nsga3.py", nsga3_example)):
        (result, gens, detail), wall = timed(lambda fn=fn: fn(dev))
        if not math.isfinite(result):
            fail(f"{name}: {detail}")
        print(f"{tag} {name}: {gens} generations in {wall:.3f} s = "
              f"{wall / gens * 1e3:.3f} ms/gen; {detail}")

    # ---------------------------------- NSGA-III at mu 50k through K7 --
    @contextlib.contextmanager
    def k7_clock(events):
        """CUDA events around each peel's K7 count while open
        (``kernels.dominated_counts``, which ``nd_rank_tiled`` calls once
        a peel: K7 and a cast to int32): K7's device time inside a run.
        K7's wrapper counts its launches through its own module name, so
        that name stays bound."""
        k7_fn = kernels.dominated_counts

        def clocked(*args, **kwargs):
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record()
            out = k7_fn(*args, **kwargs)
            pair[1].record()
            events.append(pair)
            return out
        kernels.dominated_counts = clocked
        try:
            yield
        finally:
            kernels.dominated_counts = k7_fn

    def k7_ms(events):
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in events)

    def selection_parts(wu):
        """One NSGA-III selection of MO_POP rows from ``wu`` in its parts:
        the plan (K7's device time and launches in it), the draws, the
        niching loop; the peak memory above what was allocated before."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        events = []
        with k7_clock(events):
            plan, t_plan = timed(lambda: emo.nsga3_plan(wu, MO_POP, ref))
        u, t_draws = timed(lambda: emo.nsga3_draws(g, plan))
        keep, t_fill = timed(lambda: emo.nsga3_select_scaled(plan, MO_POP,
                                                             u))
        peak = torch.cuda.max_memory_allocated() - base
        if not (keep.shape == (MO_POP,)
                and int(torch.unique(keep).shape[0]) == MO_POP):
            fail(f"NSGA-III's selection from a union of {wu.shape[0]} rows "
                 f"is not {MO_POP} distinct rows")
        return plan, {"plan": t_plan * 1e3, "k7": k7_ms(events),
                      "k7_launches": len(events), "draws": t_draws * 1e3,
                      "niching": t_fill * 1e3,
                      "peak_mib": peak / 2 ** 20}

    m = MO_NOBJ
    ref = mo.uniform_reference_points(m, N3_WIDE_P).to(dev)
    g = make_generator(5, dev)
    x = torch.rand((MO_POP, MO_DIM), generator=g, device=dev)
    wm = -benchmarks.dtlz2(x, m)
    x, wm = nsga3_generation(g, x, wm, ref)  # warm-up
    inputs, fills, events = [], [], []
    reset_counts()
    with k7_clock(events):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MO_NGEN):
            x, wm = nsga3_generation(g, x, wm, ref, inputs, fills)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    k7 = kernels.dominated_weight_sums.launches
    k8 = kernels.dominated_weight_maxes.launches
    peels = [mo.nd_rank(v, impl="tiled", return_peels=True,
                        cover_k=MO_POP if kind == "nsga3" else None)[1]
             for kind, v in inputs]
    if k7 != sum(peels) or k8 != 0 or len(events) != k7:
        fail(f"NSGA-III: K7 launched {k7} times ({len(events)} clocked) "
             f"for {sum(peels)} fronts peeled (K8 {k8})")
    report["k7"]["nsga3_launches"] = k7
    if not (x.shape == (MO_POP, MO_DIM) and bool(torch.isfinite(wm).all())
            and float(x.min()) >= 0.0 and float(x.max()) <= 1.0
            and torch.allclose(wm, -benchmarks.dtlz2(x, m), rtol=1e-6,
                               atol=0.0)):
        fail("NSGA-III's final population is wrong")
    ms_gen = wall_s / MO_NGEN * 1e3
    k7_gen = k7_ms(events) / MO_NGEN
    print(f"{tag} NSGA-III DTLZ2 mu={MO_POP} (union {2 * MO_POP}, m={m}, "
          f"dim {MO_DIM}, {ref.shape[0]} reference points): {MO_NGEN} "
          f"generations in {wall_s:.3f} s = {ms_gen:.3f} ms/gen; fronts "
          f"peeled per selection {peels} (dcd, nsga3 per generation); K7 "
          f"launches {k7} = the fronts peeled, K7 device time {k7_gen:.3f} "
          f"ms/gen ({k7_gen / ms_gen:.1%}); n_fill per generation "
          f"{[f[0] for f in fills]} of partial fronts {[f[1] for f in fills]}")
    # the last selection's union, then a converged one: DTLZ2's distance
    # variables at 0.5 put every row on the front, so n_fill = mu
    xc = torch.rand((2 * MO_POP, MO_DIM), generator=g, device=dev)
    xc[:, m - 1:] = 0.5
    for what, wu in (("the last selection's union", inputs[-1][1]),
                     ("a converged union", -benchmarks.dtlz2(xc, m))):
        plan, t = selection_parts(wu)
        _, t_sel = timed(lambda wu=wu: mo.sel_nsga3(g, wu, MO_POP, ref))
        print(f"{tag} NSGA-III selection alone on {what} ({wu.shape[0]} "
              f"rows, n_fill {plan.n_fill}, partial front "
              f"{plan.partial_idx.shape[0]}): sel_nsga3 "
              f"{t_sel * 1e3:.3f} ms; plan {t['plan']:.3f} ms (K7 "
              f"{t['k7']:.3f} ms device time in {t['k7_launches']} "
              f"launches), draws {t['draws']:.3f} ms, niching on the host "
              f"{t['niching']:.3f} ms ({t['niching'] / ms_gen:.1%} of the "
              f"ms/gen above); peak memory {t['peak_mib']:.1f} MiB above "
              f"the union")

    # ----------------------------- DE and PSO at pop 100k, Rastrigin --
    lo, hi = RA_LOW, RA_UP
    de = DifferentialEvolution(benchmarks.rastrigin, F=1.0, CR=0.25)
    g = make_generator(21, dev)
    pop = init_population(g, RA_N, ops.uniform_genome(RA_DIM, lo, hi),
                          FitnessSpec((-1.0,)), device=dev)
    pop, _ = de.run(g, pop, WIDE_WARM)
    start = float(-pop.wvalues[:, 0].max())
    (pop, traj), wall = timed(lambda: de.run(g, pop, WIDE_NGEN))
    best = float(-pop.wvalues[:, 0].max())
    gate(f"DE Rastrigin n={RA_N} dim={RA_DIM} (after {WIDE_WARM} of "
         f"warm-up)", best <= start and monotone(traj)
         and bool(torch.isfinite(pop.fitness).all()),
         f"best {start:.4f} -> {best:.4f}", wall, WIDE_NGEN)
    pso = PSO(benchmarks.rastrigin, smin=0.001, smax=3.0,
              spec=FitnessSpec((-1.0,)), device=dev)
    g = make_generator(22, dev)
    s = pso.init(g, RA_N, RA_DIM, lo, hi, -3.0, 3.0)
    s, _ = pso.run(g, s, WIDE_WARM)
    start = float(-s.gbest_w[0])
    (s, traj), wall = timed(lambda: pso.run(g, s, WIDE_NGEN))
    best = float(-s.gbest_w[0])
    gate(f"PSO Rastrigin n={RA_N} dim={RA_DIM} (after {WIDE_WARM} of "
         f"warm-up)", best <= start and monotone(traj)
         and bool(torch.isfinite(s.x).all()),
         f"gbest {start:.4f} -> {best:.4f}", wall, WIDE_NGEN)

    # ---------------------------------- dense SPEA2, over-full 2,000 --
    g = make_generator(31, dev)
    f1 = torch.sort(torch.rand(SPEA2_N, generator=g, device=dev)).values
    w = -torch.stack([f1, 1.0 - torch.sqrt(f1)], 1)   # ZDT1's front
    idx, wall = timed(lambda: mo.sel_spea2(None, w, SPEA2_K))
    nd = emo.dominance_matrix(w).sum(1) == 0
    n_nd = int(nd.sum())
    if not (idx.shape == (SPEA2_K,) and len(set(idx.tolist())) == SPEA2_K
            and bool(nd[idx].all())):
        fail("dense sel_spea2 on the over-full union is wrong")
    print(f"{tag} dense sel_spea2 on an over-full ZDT1 union of {SPEA2_N} "
          f"rows ({n_nd} non-dominated) to {SPEA2_K}: {wall:.3f} s for "
          f"{n_nd - SPEA2_K} removals = {wall / (n_nd - SPEA2_K) * 1e3:.3f} "
          f"ms a removal")


def j1_shapes(sms):
    """``(d, batch)`` of J1's card check on a card of ``sms`` SMs:
    ``J1_DIMS`` by ``J1_BATCHES``, the d that split over two SMs at those
    batches also at one matrix more than a split launch holds (one SM a
    matrix), then the serving buckets."""
    from deap_tpu_torch.ops import linalg
    split = [(d, sms // 2 + 1) for d in J1_DIMS
             if linalg._j1_splits(d, 1, sms)]
    return [(d, b) for d in J1_DIMS for b in J1_BATCHES] + split + [
        (d, b) for b, d in J1_BUCKETS]


def j1_inputs(torch, dev, d, batch, cma_C):
    """J1's inputs at ``[batch, d, d]``, by name: a random SPD matrix, the
    identity (every pair skipped), a diagonal with repeated entries, a
    diagonal with one off-diagonal pair below float32's tiny (subnormal),
    and CMA-ES's covariance ``cma_C`` (its leading block, or it beside an
    identity block)."""
    g = torch.Generator(device=dev).manual_seed(1000 * d + batch)
    M = torch.randn((batch, d, d), generator=g, device=dev)
    eye = torch.eye(d, device=dev).expand(batch, d, d)
    diag = torch.randn((batch, d), generator=g, device=dev)
    tiny = torch.diag_embed(diag)
    tiny[:, 0, 1] = tiny[:, 1, 0] = 1e-39
    repeated = torch.tensor([2.0, -1.0, 2.0], device=dev).repeat(d)[:d]
    k = min(d, cma_C.shape[0])
    C = torch.eye(d, device=dev)
    C[:k, :k] = cma_C[:k, :k]
    return {"spd": (M @ M.mT + d * eye).contiguous(),
            "identity": eye.contiguous(),
            "repeated": torch.diag(repeated).expand(batch, d, d).contiguous(),
            "tiny_offdiagonal": tiny.contiguous(),
            "cma": C.expand(batch, d, d).contiguous()}


def j1_flops(d):
    """J1's float32 operations on one d x d matrix: each round, a pair's
    c and s (13) and its rows, A's columns and V's columns (3 updates of 2
    entries by 2 products and a sum, across d), byes included."""
    from deap_tpu_torch.ops import linalg
    m = d + d % 2
    return linalg.default_sweeps(d) * (m - 1) * (m // 2) * (18 * d + 13)


def k1_sweep():
    """The shapes K1 is held at beside the main path's: ``(L, n, N, dtype,
    kind, cxpb, mutpb, aligned)`` over the lengths its units branch on
    (L % 4, one unit, a row of more than 32 units), odd n, n above and
    below N, every kind in both dtypes, the probabilities at 0 and 1,
    and genomes one gene off their unit's alignment."""
    import torch
    out = []
    for L in (1, 3, 4, 5, 100, 101):
        for n, N in ((1, 4), (33, 20), (1001, 1001)):
            for dtype in (torch.bool, torch.float32):
                for kind in ("flip", "add", "set"):
                    for cxpb, mutpb in ((0.7, 0.6), (0.0, 0.0), (1.0, 1.0),
                                        (0.0, 1.0), (1.0, 0.0)):
                        out.append((L, n, N, dtype, kind, cxpb, mutpb, True))
                    out.append((L, n, N, dtype, kind, 0.7, 0.6, False))
    out += [(100, lam, N, dtype, kind, CXPB, MUTPB, True)
            for lam, N, dtype, kind in k1_var_or_shapes()]
    return out


def k1_var_or_shapes():
    """``var_or``'s shapes of K1, ``(λ, N, dtype, kind)``: λ children of
    N parent rows at L 100, λ below, at and above a warp's 32 rows and
    the loops' 100k, N from the fewest that can mate to 100k, for bool
    ``flip`` and float32 ``add`` and ``set``."""
    import torch
    return [(lam, N, dtype, kind) for lam in (1, 63, 64, 1000, 100_000)
            for N in (2, 48, 20_000, 100_000)
            for dtype, kind in ((torch.bool, "flip"), (torch.float32, "add"),
                                (torch.float32, "set"))]


def var_or_k1_inputs(torch, dev, seed, lam, N, dtype, kind):
    """K1's arguments ``(genomes, base_idx, partner_idx, choice_cx, lo,
    hi, choice_mut, mask, arg)`` as ``var_or`` makes them for ``lam``
    children of ``N`` 0/1 rows at L 100: ``variation.var_or_masks`` with
    ``cx_two_point``'s segments and a mask of density ``INDPB`` (for
    ``add`` Gaussian steps, for ``set`` normal values)."""
    from deap_tpu_torch import ops
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.ops import variation

    def mut_draw(g, n, length, dtype_):
        mask = torch.rand((n, length), generator=g, device=dev) < INDPB
        arg = (None if kind == "flip" else
               torch.randn((n, length), generator=g, device=dev))
        return mask, arg

    plan = variation.VariationPlan(ops.cx_two_point.fused_segment_draw,
                                   "cx_two_point", kind, mut_draw, kind)
    gen = make_generator(seed, dev)
    g = (torch.rand((N, L), generator=gen, device=dev) < 0.5).to(dtype)
    masks = variation.var_or_masks(gen, N, lam, L, CXPB, MUTPB, plan, dtype)
    return (g,) + masks


def k1_inputs(torch, dev, seed, n, N, L, dtype, kind, cxpb, mutpb,
              aligned=True):
    """K1's arguments ``(genomes, src, partner, cx_row, lo, hi, mut_row,
    mask, arg)`` for n children of N parents: 0/1 genomes (a view one gene
    off a unit's alignment unless ``aligned``), random parents, segments
    drawn in [0, L] with ``lo > hi`` (empty) among them and, on every
    5th/7th/9th row, ``lo = 0``, ``hi = L`` and ``lo == hi``, a mask of
    density 0.3 and, for add/set, normal arguments with zeros among
    them."""
    from deap_tpu_torch.device import make_generator
    gen = make_generator(seed, dev)
    bits = torch.rand(N * L + 1, generator=gen, device=dev) < 0.5
    g = bits.to(dtype)[0 if aligned else 1:][:N * L].view(N, L)
    src = torch.randint(0, N, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    partner = torch.randint(0, N, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
    cx_row = torch.rand(n, generator=gen, device=dev) < cxpb
    lo = torch.randint(0, L + 1, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    hi = torch.randint(0, L + 1, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    lo[::5] = 0
    hi[::7] = L
    hi[::9] = lo[::9]
    mut_row = torch.rand(n, generator=gen, device=dev) < mutpb
    mask = torch.rand((n, L), generator=gen, device=dev) < 0.3
    arg = None
    if kind != "flip":
        arg = torch.randn((n, L), generator=gen, device=dev)
        arg[torch.rand((n, L), generator=gen, device=dev) < 0.2] = 0.0
    return g, src, partner, cx_row, lo, hi, mut_row, mask, arg


def k8_sweep():
    """The shapes K8 is held at beside the prefix reduction's: ``(n, nq,
    m)`` over the objectives its kernels branch on (m 1-4, 5-8, the
    generic 9-32), queries fewer than a thread's, not a multiple of a
    block's and many blocks, and rows not a multiple of a split's chunk
    or of the tile, up to 100k rows and 2048 queries."""
    out = [(n, nq, m) for m in (1, 2, 3, 8, 9, 32)
           for n in (1, 31, 33, 2049) for nq in (1, 3, 513, 2048)]
    out += [(16_384, nq, m) for m in (3, 8, 9) for nq in (3, 512, 2048)]
    out += [(100_000, nq, 3) for nq in (511, 2048)]
    return out


def k8_inputs(torch, dev, seed, n, nq, m):
    """K8's arguments ``(w, weights, queries)``: integer grid values
    (ties) for even seeds and normal ones for odd seeds, each with rows of
    -inf and of NaN and duplicated rows, the queries drawn from the rows
    and from fresh values; integer weights 0-5, all 0 for every 4th
    seed."""
    from deap_tpu_torch.device import make_generator
    gen = make_generator(seed, dev)

    def values(k):
        if seed % 2 == 0:
            v = torch.randint(0, 4, (k, m), generator=gen,
                              device=dev).float()
        else:
            v = torch.randn((k, m), generator=gen, device=dev)
        if k > 4:
            rows = torch.randint(0, k, (2, k // 3), generator=gen,
                                 device=dev)
            v[rows[0]] = v[rows[1]]
            v[torch.rand(k, generator=gen, device=dev) < 0.05] = -torch.inf
            v[torch.rand(k, generator=gen, device=dev) < 0.03] = torch.nan
        return v

    w = values(n)
    weights = torch.randint(0, 6, (n,), generator=gen, device=dev).float()
    if seed % 4 == 3:
        weights.zero_()
    pool = torch.cat([w, values(nq)])
    queries = pool[torch.randint(0, n + nq, (nq,), generator=gen,
                                 device=dev)].contiguous()
    return w, weights, queries


def dc_cross_steps(torch, w, starts=None, block=512):
    """The ``(prefix, weights, queries)`` of each K8 call that
    ``mo.nd_rank_prefix`` makes on ``w``, in its order (or, with
    ``starts``, of the block of ``block`` lex-sorted rows at each start):
    the rows before the block with weights rank + 1, the ranks taken from
    the tiled engine (which equal the prefix reduction's)."""
    from deap_tpu_torch import mo
    from deap_tpu_torch.core.fitness import lex_sort_desc
    order = lex_sort_desc(w)
    ws = w[order].to(torch.float32).contiguous()
    rs = mo.nd_rank(w, impl="tiled")[order].to(torch.float32) + 1.0
    if starts is None:
        starts = range(block, w.shape[0], block)
    return [(ws[:start], rs[:start].contiguous(),
             ws[start:start + block])
            for start in starts]


def other_key(key):
    """A Philox key that differs from ``key`` in one bit."""
    from deap_tpu_torch.ops import philox
    return (philox._u32(key) ^ 1).to(key.dtype)


def tournament_winners(fit, draws):
    """The population index each tournament of ``draws`` (uint32
    ``[tournsize, n]``, aspirant ``draws % n``) selects by K4's rule: a
    strictly greater fitness wins, so the first drawn wins ties."""
    import torch
    from deap_tpu_torch.ops import kernels
    aspirants = kernels._words(draws) % fit.shape[0]
    winners, best_fit = aspirants[0], fit[aspirants[0]]
    for idx in aspirants[1:]:
        better = fit[idx] > best_fit
        winners = torch.where(better, idx, winners)
        best_fit = torch.where(better, fit[idx], best_fit)
    return winners


def rows_below(bits, p):
    """How many uint32 draws of ``bits`` give a uniform below ``p``."""
    from deap_tpu_torch.ops import kernels
    return int((kernels._u01(kernels._words(bits)) < kernels._f32(p)).sum())


def pairs_mating(pairbits, cxpb):
    """How many pairs of a ``[n, 4]`` pair stream mate (the even row's
    word 0 below ``cxpb``; an odd last row never mates)."""
    n = pairbits.shape[0]
    return rows_below(pairbits[0: 2 * (n // 2): 2, 0], cxpb)


def k6_sweep():
    """``(n, L, rates)`` of K6's bits-body sweep: its tile edges by its
    column chunks, each with the main path's rates and the rates at 0 and
    1, and the main path's n at its L."""
    edges = [{}, dict(cxpb=0.0, mutpb=0.0), dict(cxpb=1.0, mutpb=1.0,
                                                 indpb=1.0),
             dict(cxpb=1.0, mutpb=1.0, indpb=0.0), dict(cxpb=0.0, indpb=1.0)]
    return ([(n, length, probs)
             for n in (1, 2, 3, 15, 16, 17, 63, 64, 65, 127, 129, 1001)
             for length in (1, 30, 31, 33, 64, 100) for probs in edges]
            + [(RA_N, RA_DIM, probs) for probs in edges])


def k3_sweep():
    """``(n, L, (cxpb, mutpb, indpb))`` of K3's bits-body sweep: n at 1,
    2, a 256-row tile and either side of it (257 off 16-byte alignment),
    1001; L from 1 to 300 (W 1 to 10: one uint4 a lane, word loads, more
    than one 4-word chunk); each probability set, the rates at 0 and 1."""
    return [(n, length, probs) for n in (1, 2, 255, 256, 257, 1001)
            for length in (1, 31, 32, 33, 100, 128, 300)
            for probs in ((0.5, 0.2, 0.05), (1.0, 1.0, 0.5),
                          (0.0, 0.0, 0.3), (0.0, 1.0, 1.0))]


def k5_sweep():
    """``(n, L, tournsize, ngen, (cxpb, mutpb, indpb))`` of K5's bits-body
    sweep: n at 1, 2, 255, 257, 1000 (16-byte copies; its planes then off
    16-byte alignment), 1001 (4-byte copies) and past one resident wave of
    tiles; L 1 to 300 (1 to 10 words, one chunk of 4 or more), tournaments
    of 1 to 9, 1 to 3 generations, the rates at 0 and 1."""
    shapes = [(n, length, ts, ngen, probs)
              for n in (1, 2, 255, 257, 1000, 1001)
              for length, ts, ngen in ((1, 1, 3), (31, 2, 1), (33, 4, 3),
                                       (100, 3, 3), (128, 5, 2), (300, 9, 2))
              for probs in ((0.5, 0.2, 0.05), (1.0, 1.0, 0.5),
                            (0.0, 0.0, 0.3))]
    return shapes + [(K5_WAVE, L, TOURNSIZE, 3, (CXPB, MUTPB, INDPB))]


def offset_copy(torch, t):
    """``t``'s values in a tensor 4 bytes past a 16-byte boundary."""
    store = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = store[1:].view(t.shape)
    view.copy_(t)
    return view


def evolve_bytes(bits, n, W, L, cxpb, mutpb):
    """The bytes one :func:`evolve_packed` call on ``bits`` must move:
    the population and fitness in and out once; per generation every
    aspirant draw, pair word 0 of every pair and words 1-2 of mating
    pairs, every row draw and, of mutating lanes, the ``L`` gene-bit
    planes of real genes (the planes past gene ``L`` flip nothing)."""
    sel, pair, row, _ = bits
    ngen, tournsize = sel.shape[:2]
    n_cx = sum(pairs_mating(pair[g].T, cxpb) for g in range(ngen))
    n_mut = sum(rows_below(row[g], mutpb) for g in range(ngen))
    per_gen = 4 * (tournsize * n + n // 2 + n)
    return (2 * (4 * n * W + 4 * n) + ngen * per_gen + 8 * n_cx
            + 4 * L * n_mut)


def evolve_sector_bytes(bits, n, W, L, cxpb, mutpb):
    """The bytes of the 32-byte sectors (8 lanes) one :func:`evolve_packed`
    call on ``bits`` must fetch, each once: the population and fitness in
    and out once; per generation every sector of the aspirant and row
    draws, the sectors of pair word 0 (every one holds an even lane) and of
    words 1-2 that hold a mating pair, and of each of the ``L`` real gene
    planes the sectors that hold a mutating lane."""
    import torch
    from deap_tpu_torch.ops import kernels
    sel, pair, row, _ = bits
    ngen, tournsize = sel.shape[:2]
    sectors = -(-n // 8)

    def hit(lanes):
        padded = torch.zeros(sectors * 8, dtype=torch.bool,
                             device=lanes.device)
        padded[:n] = lanes
        return int(padded.view(-1, 8).any(1).sum())

    total = 2 * (4 * n * W + 4 * n)
    for g in range(ngen):
        mating = (kernels._u01(kernels._words(pair[g, 0]))
                  < kernels._f32(cxpb))
        mating[1::2] = False  # the even lane's word decides the pair
        if n % 2:
            mating[n - 1] = False  # an odd last lane never mates
        mutating = (kernels._u01(kernels._words(row[g, 0]))
                    < kernels._f32(mutpb))
        total += 32 * ((tournsize + 2) * sectors + 2 * hit(mating)
                       + L * hit(mutating))
    return total


def k9_bytes(sched, prims, P):
    """The bytes K9 must move for the grouped schedule ``sched`` at ``P``
    points: each row that some operand within its primitive's arity
    reads (argument or instruction rows; constants are inline) read once,
    each instruction row (pad rows too) written once, and the schedule
    arrays read once."""
    import numpy as np
    chunk = sched["src_idx"].shape[0] // sched["nchunks"]
    row_ar = np.repeat(np.asarray([p.arity for p in prims])[
        sched["chunk_ops"]], chunk)
    used = ((np.arange(sched["src_idx"].shape[1]) < row_ar[:, None])
            & ~sched["src_isc"])
    rows_read = np.unique(sched["src_idx"][used]).size
    return (4 * P * (rows_read + sched["src_idx"].shape[0])
            + sched["chunk_ops"].nbytes + sched["src_idx"].nbytes
            + sched["src_const"].nbytes + sched["src_isc"].nbytes)


def mo_phases(torch, dev, tag, report, record):
    """Phases 9-11: K7 and K8 at the NSGA-II path's shapes, the engines'
    agreement, and the NSGA-II 3-objective DTLZ2 run."""
    from deap_tpu_torch import benchmarks as bm
    from deap_tpu_torch import mo
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.ops import kernels

    flush = torch.empty(2**27, dtype=torch.int32, device=dev)  # 512 MB
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n2, m = 2 * MO_POP, MO_NOBJ
    gen = make_generator(11, dev)
    w = -bm.dtlz2(torch.rand((n2, MO_DIM), generator=gen, device=dev), m)
    if not (w.shape == (n2, m) and bool(torch.isfinite(w).all())):
        fail("dtlz2 gave non-finite or misshapen values")

    # ------------------------------------ K7 dominated_weight_sums check --
    ones = torch.ones(n2, device=dev)
    got = kernels.dominated_weight_sums(w, ones)        # a first peel
    want = kernels.dominated_weight_sums_plain(w, ones)
    torch.cuda.synchronize()
    if not (float(want.max()) < EXACT and bitwise_equal(got, want)):
        fail("dominated_weight_sums (0/1 weights) differs from the plain "
             "version")
    err = max_abs_err(got, want)
    strength = kernels.strengths_tiled(w)
    if not bitwise_equal(strength, kernels.dominated_weight_sums_plain(
            -w, ones)):
        fail("strengths_tiled differs from the plain version")
    raw = kernels.dominated_weight_sums(w, strength)     # SPEA2 raw
    raw_plain = kernels.dominated_weight_sums_plain(w, strength)
    raw_again = kernels.dominated_weight_sums(w, strength)
    torch.cuda.synchronize()
    exact = raw_plain < EXACT
    rel = float(((raw - raw_plain).abs() / raw_plain.clamp_min(1.0)).max())
    if not (bitwise_equal(raw[exact], raw_plain[exact])
            and rel <= kernels.K7_RTOL):
        fail(f"dominated_weight_sums (SPEA2 strengths) differs from the "
             f"plain version (max relative error {rel})")
    if not bitwise_equal(raw, raw_again):
        fail("dominated_weight_sums (SPEA2 strengths) differs from itself "
             "from launch to launch")
    splits = {k: kernels._k7_splits(k, m, torch.cuda.get_device_properties(
        dev).multi_processor_count) for k in (MO_POP, n2)}
    print(f"{tag} dominated_weight_sums == plain bitwise at n={n2}, m={m} "
          f"(0/1 weights, counts up to {int(want.max())}; strengths); SPEA2 "
          f"raw bitwise on the {int(exact.sum())} rows below 2^24, max "
          f"relative error {rel:.3e} on the {int((~exact).sum())} above; "
          f"two launches bitwise equal; j split in {splits[n2]} ranges "
          f"({splits[MO_POP]} at n={MO_POP})")
    # the bound counts the pairs K7 compares: each block of queries
    # against the sorted rows up to its prune limit
    rows = kernels._DOM_THREADS * kernels._k7_rows_per_thread(m)
    pairs = k7_pairs(kernels, w)
    print(f"  K7 sorts the rows by objective 0 and compares a block of "
          f"{rows} queries only with the rows up to its prune limit: "
          f"{pairs:.4e} of the {float(n2) ** 2:.4e} pairs "
          f"({pairs / n2 ** 2:.1%}); its bound counts these")
    # the DCD sort of the parents calls K7 at mu rows
    wp, onesp = w[:MO_POP].contiguous(), ones[:MO_POP]
    pairs_half = k7_pairs(kernels, wp)
    ms_half = time_ms(lambda: kernels.dominated_weight_sums(wp, onesp), flush)
    bound_half = 2 * m * pairs_half / compare_rate(dev) * 1e3
    all_half = 2 * m * MO_POP ** 2 / compare_rate(dev) * 1e3
    print(f"{tag} dominated_weight_sums at n={MO_POP}, m={m}: "
          f"{ms_half * 1e3:.2f} us (bound {bound_half * 1e3:.2f} us by "
          f"operations over the {pairs_half:.4e} pairs compared, "
          f"{bound_half / ms_half:.1%} of it; all {float(MO_POP) ** 2:.4e} "
          f"pairs would bound it at {all_half * 1e3:.2f} us, "
          f"{all_half / ms_half:.1%})")
    ms = time_ms(lambda: kernels.dominated_weight_sums(w, ones), flush)
    record("k7", "dominated_weight_sums", "deap_tpu_torch/csrc/dominance.cu",
           "deap_tpu/ops/kernels.py:106", err, ms,
           time_ms(lambda: kernels.dominated_weight_sums_plain(w, ones),
                   flush, reps=3),
           4 * (n2 * m + 2 * n2), compares=2 * m * pairs)
    all_ms = 2 * m * n2 * n2 / compare_rate(dev) * 1e3
    print(f"  all {float(n2) ** 2:.4e} pairs would bound K7 at "
          f"{all_ms * 1e3:.2f} us, {all_ms / ms:.1%} of its time")

    # ----------------------------------- K8 dominated_weight_maxes check --
    # one cross step of nd_rank_prefix as it calls K8: the block of 512
    # lex-sorted rows at `start` against the ranked prefix before it, with
    # weights rank + 1
    start, block = MO_POP, 512
    [(prefix, weights, queries)] = dc_cross_steps(torch, w, [start], block)
    got = kernels.dominated_weight_maxes(prefix, weights, queries)
    want = kernels.dominated_weight_maxes_plain(prefix, weights, queries)
    torch.cuda.synchronize()
    if not bitwise_equal(got, want):
        fail("dominated_weight_maxes differs from the plain version")
    print(f"{tag} dominated_weight_maxes == plain bitwise: {block} queries "
          f"against the {start}-row ranked prefix of {n2} lex-sorted rows, "
          f"max {float(got.max())}")
    record("k8", "dominated_weight_maxes", "deap_tpu_torch/csrc/dominance.cu",
           "deap_tpu/ops/kernels.py:173", max_abs_err(got, want),
           time_ms(lambda: kernels.dominated_weight_maxes(prefix, weights,
                                                          queries), flush),
           time_ms(lambda: kernels.dominated_weight_maxes_plain(
               prefix, weights, queries), flush, reps=5),
           4 * (start * m + start + block * m + block),
           compares=2 * m * block * start)
    print(f"  K8 splits the {start} rows in "
          f"{kernels._k8_splits(start, block, m, sms)} ranges for its "
          f"{block} queries")
    cases = 0
    for n_, nq, m_ in k8_sweep():
        args = k8_inputs(torch, dev, cases, n_, nq, m_)
        got = kernels.dominated_weight_maxes(*args)
        want = kernels.dominated_weight_maxes_plain(*args)
        torch.cuda.synchronize()
        if not bitwise_equal(got, want):
            fail(f"dominated_weight_maxes differs from the plain version at "
                 f"n={n_}, nq={nq}, m={m_} (seed {cases})")
        cases += 1
    print(f"{tag} dominated_weight_maxes == plain bitwise at {cases} more "
          f"shapes (n 1-100k, nq 1-2048, m 1-32; NaN, -inf and duplicated "
          f"rows, ties, all-zero weights)")
    # what a user of nd='dc' pays K8: its 31 launches in one selection at
    # the 16,384-row union, each timed alone
    steps = dc_cross_steps(torch, w[:DC_UNION].contiguous())
    dc_ms = [time_ms(lambda s=s: kernels.dominated_weight_maxes(*s), flush,
                     reps=9) for s in steps]
    dc_pairs = sum(p.shape[0] * q.shape[0] for p, _, q in steps)
    print(f"{tag} dominated_weight_maxes over the {len(steps)} cross steps "
          f"of nd='dc' at {DC_UNION} rows: {sum(dc_ms) * 1e3:.2f} us "
          f"({dc_ms[0] * 1e3:.2f} us at {steps[0][0].shape[0]} rows to "
          f"{dc_ms[-1] * 1e3:.2f} at {steps[-1][0].shape[0]}; bound "
          f"{2 * m * dc_pairs / compare_rate(dev) * 1e6:.2f} us by "
          f"operations over {dc_pairs:.4e} pairs)")
    del flush

    # ------------------------------------------- engines agree at 8192 --
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    w8 = w[:ENGINE_N].contiguous()
    want, t_matrix = timed(lambda: mo.nd_rank(w8, impl="matrix"))
    times = {"matrix": t_matrix}
    for name, fn in (
            ("tiled", lambda: mo.nd_rank(w8, impl="tiled")),
            ("dc", lambda: mo.nd_rank(w8, impl="dc")),
            ("sweep", lambda: mo.nd_rank(w8, impl="sweep"))):
        got, times[name] = timed(fn)
        if not torch.equal(got, want):
            fail(f"nd_rank {name} differs from the matrix engine at "
                 f"n={ENGINE_N}")
    w2 = w8[:, :2].contiguous()
    stair, times["staircase m2"] = timed(lambda: mo.nd_rank(
        w2, impl="staircase"))
    tiled2, times["tiled m2"] = timed(lambda: mo.nd_rank(w2, impl="tiled"))
    if not torch.equal(stair, tiled2):
        fail("nd_rank staircase differs from tiled at m=2")
    print(f"{tag} nd_rank engines agree at n={ENGINE_N} (m=3: tiled, "
          f"matrix, dc, sweep; m=2: staircase, tiled), "
          f"{int(want.max()) + 1} fronts; seconds "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))

    wu = w[:DC_UNION].contiguous()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    by_dc = mo.sel_nsga2(None, wu, DC_UNION // 2, nd="dc")
    torch.cuda.synchronize()
    t_dc = time.perf_counter() - t0
    report["k8"]["launches"] = kernels.dominated_weight_maxes.launches
    if kernels.dominated_weight_maxes.launches != DC_UNION // 512 - 1:
        fail(f"sel_nsga2(nd='dc') launched K8 "
             f"{kernels.dominated_weight_maxes.launches} times")
    by_tiled = mo.sel_nsga2(None, wu, DC_UNION // 2, nd="tiled")
    if not torch.equal(by_dc, by_tiled):
        fail("sel_nsga2 through K8 (dc) differs from it through K7 (tiled)")
    print(f"{tag} sel_nsga2 over a {DC_UNION}-row union: nd='dc' == "
          f"nd='tiled'; dc took {t_dc:.4f} s with "
          f"{report['k8']['launches']} K8 launches")

    # ------------------------------------------- NSGA-II 3-objective run --
    def start(seed, mu):
        g = make_generator(seed, dev)
        x = torch.rand((mu, MO_DIM), generator=g, device=dev)
        return g, x, -bm.dtlz2(x, m)

    runs = []
    for nd in ("tiled", "matrix"):
        g, x, wm = start(21, MO_SMALL)
        for _ in range(2):
            x, wm = nsga2_generation(g, x, wm, nd)
        runs.append((x, wm))
    if not (bitwise_equal(runs[0][0], runs[1][0])
            and bitwise_equal(runs[0][1], runs[1][1])):
        fail("NSGA-II through K7 differs from it through the dominance "
             "matrix")
    print(f"{tag} NSGA-II mu={MO_SMALL}, 2 generations: nd='tiled' == "
          f"nd='matrix' bitwise in the kept genomes and weighted values")

    g, x, wm = start(5, MO_POP)
    x, wm = nsga2_generation(g, x, wm, "standard")  # warm-up
    inputs = []
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MO_NGEN):
        x, wm = nsga2_generation(g, x, wm, "standard", inputs)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    k7 = kernels.dominated_weight_sums.launches
    k8 = kernels.dominated_weight_maxes.launches
    report["k7"]["launches"] = k7
    # the fronts each selection peeled, recomputed from its input
    peels = [mo.nd_rank(v, impl="tiled", return_peels=True,
                        cover_k=MO_POP if kind == "nsga2" else None)[1]
             for kind, v in inputs]
    if k7 != sum(peels) or k8 != 0:
        fail(f"K7 launched {k7} times for {sum(peels)} fronts peeled "
             f"(K8 {k8})")
    if not (x.shape == (MO_POP, MO_DIM) and wm.shape == (MO_POP, m)
            and bool(torch.isfinite(wm).all())
            and float(x.min()) >= 0.0 and float(x.max()) <= 1.0
            and torch.allclose(wm, -bm.dtlz2(x, m), rtol=1e-6, atol=0.0)):
        fail("NSGA-II's final population is wrong")
    front = wm[mo.nd_rank(wm) == 0]
    if int(kernels.dominated_counts(front, torch.ones(
            front.shape[0], device=dev)).max()) != 0:
        fail("the final first front is not mutually non-dominated")
    dist = float((front.norm(dim=1) - 1.0).mean())
    print(f"{tag} NSGA-II DTLZ2 mu={MO_POP} (union {n2}, m={m}, dim "
          f"{MO_DIM}): {MO_NGEN} generations in {wall_s:.3f} s = "
          f"{MO_NGEN / wall_s:.3f} gens/s; fronts peeled per selection "
          f"{peels} (dcd, nsga2 per generation); K7 launches {k7} = "
          f"{k7 / MO_NGEN:.1f} per generation; first front {front.shape[0]} "
          f"rows, mean ||f||-1 {dist:.4f}")



def nd_scan_rows(torch, dev, kind, n, m, seed):
    """Weighted values ``[n, m]`` of one of :data:`ND_KINDS` on ``dev``:
    uniform rows, a small integer grid (ties and duplicates), uniform rows
    with ``-inf`` rows and values among them (invalid individuals), the
    same with NaN, seven distinct rows repeated, rows on the plane ``Σ w =
    1`` (one front), and a chain (each row dominated by another: n
    fronts)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "ties":
        return torch.randint(0, 6, (n, m), generator=g, device=dev).float()
    if kind == "duplicates":
        rows = torch.rand((7, m), generator=g, device=dev)
        return rows[torch.randint(0, 7, (n,), generator=g, device=dev)]
    if kind == "chain":
        i = torch.randperm(n, generator=g, device=dev).float()
        return -i[:, None].expand(n, m).contiguous()
    w = torch.rand((n, m), generator=g, device=dev)
    if kind == "one_front":
        return w / w.sum(1, keepdim=True)
    if kind in ("neg_inf", "nan"):
        bad = -math.inf if kind == "neg_inf" else math.nan
        w[torch.rand(n, generator=g, device=dev) < 0.1, m - 1] = bad
        w[::17] = bad
    return w


def nd_random_tables(torch, dev, n, cols, F, u_valid, seed):
    """Gather and scatter tables ``Q``, ``U`` (int32 ``[n, cols]``) that
    any sweep takes, on ``dev``: random slots of a pool of F, each U row's
    distinct but for its pad F, ``u_valid`` of U's entries and 3% of Q's
    real (Q's pad F + 1), and the head flags (the first row a head)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    U = torch.rand((n, F), generator=g, device=dev).argsort(1)[:, :cols]
    U[torch.rand((n, cols), generator=g, device=dev) >= u_valid] = F
    Q = torch.randint(0, F, (n, cols), generator=g, device=dev)
    Q[torch.rand((n, cols), generator=g, device=dev) < 0.97] = F + 1
    head = torch.rand(n, generator=g, device=dev) < 0.8
    head[0] = True
    return Q.int(), U.int(), head


@contextlib.contextmanager
def j3_shared_slots(emo, slots):
    """J3 keeps its front maxima in shared memory up to ``slots`` (the
    rest in device memory) inside the ``with`` block."""
    saved, emo.J3_SHARED_SLOTS = emo.J3_SHARED_SLOTS, slots
    try:
        yield
    finally:
        emo.J3_SHARED_SLOTS = saved


def j5_shapes():
    """J5's checked shapes: (P, E, max_steps)."""
    return [(P, E, S) for P in J5_POPS for E in J5_EPISODES
            for S in J5_STEPS]


def j5_step_ops(H):
    """J5's float32 operations a step at hidden width H, each sin, cos and
    tanh counted as one: the hidden layer (a product, 3 fused
    multiply-adds, the bias and tanh a unit), the outputs (H products or
    fused multiply-adds, the bias and tanh each), the argmax's compare and
    the physics (sin, cos, 17 products, sums and quotients, 4 fused
    updates, 2 limit compares)."""
    return 6 * H + 2 * (H + 2) + 1 + 25


def balancing_genome(torch, dev, H=16):
    """A hand-made mlp_policy((4, H, 2)) genome that balances the pole: one
    hidden unit reads 0.5 x + 1.0 x_dot + 10 theta + 2 theta_dot, the
    outputs are -4 and +4 times it (push right when it is positive)."""
    g = torch.zeros(7 * H + 2, device=dev)
    for k, w in enumerate(J5_BALANCE):
        g[k * H] = w
    g[5 * H], g[5 * H + 1] = -4.0, 4.0
    return g


def j5_capped_population(torch, dev, g):
    """``J5_CAPPED_POP`` perturbations of :func:`balancing_genome`, every
    episode of which reaches the 500-step cap from the Gym starts."""
    bal = balancing_genome(torch, dev)
    return bal + J5_CAPPED_SIGMA * torch.randn(
        (J5_CAPPED_POP, bal.numel()), generator=g, device=dev)


def j5_warp_steps(r):
    """The steps of each warp of a J5 launch whose returns are ``r [P,
    E]``: a warp is 32 consecutive episodes and runs as long as its
    longest."""
    import torch
    flat = r.reshape(-1)
    flat = torch.cat([flat, flat.new_zeros((-flat.numel()) % 32)])
    return flat.reshape(-1, 32).amax(1)


def j5_issue_floor_ms(r, instructions, sms, clock):
    """The least time J5's warps can take to issue their steps on returns
    ``r``: the sum of every warp's steps x ``instructions`` a step over
    the card's 4 schedulers an SM, each issuing one instruction a clock."""
    return float(j5_warp_steps(r).double().sum()) * instructions / (
        4 * sms * clock) * 1e3


def sass_listing(library, kernel):
    """``(listing, [(address, opcode, branch target or None, predicated),
    ...])`` of the first function of ``cuobjdump -sass library`` whose
    mangled name contains ``kernel``."""
    import re
    import subprocess
    from deap_tpu_torch import _build
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(library)], check=True,
                          capture_output=True, text=True,
                          timeout=120).stdout
    funcs = re.split(r"\n\s*Function : ", sass)
    body = next(f for f in funcs[1:] if kernel in f.split("\n")[0])
    code = []
    for line in body.splitlines():
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                       r"([A-Z0-9_.]+)[^;]*?(0x[0-9a-f]+)?\s*;", line)
        if ins:
            code.append((int(ins.group(1), 16), ins.group(3),
                         int(ins.group(4), 16) if ins.group(4) else None,
                         ins.group(2) is not None))
    return body, code


def j5_step_instructions(library=None, H=16, out=None):
    """``(hot, whole, opcodes)``: the instructions of one step of J5's
    width-``H`` instance in ``cuobjdump -sass`` of ``library`` (by default
    this build's). The step loop is the narrowest backward branch's range
    that holds every ``tanhf``'s ``MUFU.EX2`` (``whole`` instructions);
    ``hot`` leaves out its slow paths, the ranges a conditional forward
    branch skips that hold a call (an IEEE division's out-of-range case), a
    loop or local memory (``sinf``'s and ``cosf``'s reduction of |x| >=
    105,615): what a step issues on ordinary inputs. ``opcodes`` counts the hot ones; the function's
    listing goes to ``out`` where given."""
    from deap_tpu_torch import _build
    body, code = sass_listing(library or _build._target("cartpole_rollout"),
                              f"cartpole_rollout_kernelILi{H}E")
    if out:
        with open(out, "w") as f:
            f.write(body)
    tanh = [a for a, op, _, _ in code if op == "MUFU.EX2"]
    _, start, end = min(
        (at - target, target, at) for at, op, target, _ in code
        if op.startswith("BRA") and target is not None and target < at
        and all(target <= a <= at for a in tanh))
    step = [c for c in code if start <= c[0] <= end]
    cold = set()
    for at, op, target, predicated in step:
        if not (op.startswith("BRA") and predicated and target > at):
            continue
        skipped = [c for c in step if at < c[0] < target]
        if any(o.startswith(("CALL", "LDL", "STL"))
               or (o.startswith("BRA") and t is not None and t < a)
               for a, o, t, _ in skipped):
            cold.update(c[0] for c in skipped)
    hot = [op for a, op, _, _ in step if a not in cold]
    return len(hot), len(step), {op: hot.count(op) for op in sorted(set(hot))}


def j5_division_check(torch, dev, chunk=1 << 28):
    """J5's division (``cartpole.cartpole_div``) against torch's division of
    two float32 tensors, bitwise (any NaN for a NaN): every float32 over
    1.1f (the total mass every step divides by), then ``chunk`` pairs of
    random bit patterns and ``chunk`` pairs of random numerators over
    divisors in [0.6, 0.7] (the pole's denominator). The pairs checked;
    fails on the first difference."""
    from deap_tpu_torch.benchmarks import cartpole
    g = torch.Generator(device=dev).manual_seed(43)

    def check(a, b, what):
        q, want = cartpole.cartpole_div(a, b), a / b
        same = (q.view(torch.int32) == want.view(torch.int32)) | (
            torch.isnan(q) & torch.isnan(want))
        if not bool(same.all()):
            i = int((~same).nonzero()[0, 0])
            fail(f"J5's division differs from torch's on {what}: "
                 f"{float(a[i])!r} / {float(b[i])!r} = {float(q[i])!r}, "
                 f"torch {float(want[i])!r}")
        return a.numel()

    pairs = 0
    for lo in range(-2 ** 31, 2 ** 31, chunk):
        a = torch.arange(lo, lo + chunk, dtype=torch.int64, device=dev).to(
            torch.int32).view(torch.float32)
        total_mass = cartpole.J5_CONSTANTS[2]
        pairs += check(a, torch.full_like(a, total_mass), "every float over "
                       "the total mass")
    bits = torch.randint(-2 ** 31, 2 ** 31, (2, chunk), generator=g,
                         device=dev, dtype=torch.int64).to(torch.int32)
    pairs += check(bits[0].view(torch.float32), bits[1].view(torch.float32),
                   "random bit patterns")
    a = torch.randn(chunk, generator=g, device=dev) * torch.pow(
        10.0, torch.rand(chunk, generator=g, device=dev) * 83 - 45)
    b = 0.6 + 0.1 * torch.rand(chunk, generator=g, device=dev)
    return pairs + check(a, b, "divisors in [0.6, 0.7]")


def j5_check(torch, genomes, starts, max_steps, what, sizes=CP_SIZES):
    """J5 against its plain version on the card, bitwise; its returns."""
    from deap_tpu_torch.benchmarks import cartpole
    got = cartpole.cartpole_rollout(genomes, starts, max_steps, sizes)
    want = cartpole.cartpole_rollout_plain(genomes, starts, max_steps, sizes)
    torch.cuda.synchronize()
    if not bitwise_equal(got, want):
        bad = int((got != want).sum())
        fail(f"J5 differs from its plain version on {what} ({bad} of "
             f"{got.numel()} returns)")
    return got


def cartpole_phases(torch, dev, tag, report, record):
    """Phase 18: bench_suite.py's cartpole_neuro_pop10k through J5
    (``csrc/cartpole_rollout.cu``). J5's sin, cos and tanh against torch's
    and its division against torch's on the card
    (``j5_division_check``); J5 bitwise against its plain version on a
    balancing genome, NaN and infinite genes, ``j5_shapes``,
    ``J5_WIDTHS`` and the all-at-the-cap population
    (``j5_capped_population``); the configuration as bench_suite.py calls
    it (pop 10k, 3 episodes of up to
    500 steps, 20 generations: J5 21 launches, K1 none), J5 bitwise on its
    gen-0 and last populations and timed on both and on the all-at-the-cap
    one beside its bound, its chain floor (the longest episode x one lone
    thread's clocks a step), its issue floor (``j5_issue_floor_ms`` with
    the width-16 instance's step from ``cuobjdump -sass``) and its plain
    version; then K1's set kind through ``var_and`` with
    ``mut_uniform_int``."""
    from deap_tpu_torch import FitnessSpec, Toolbox, algorithms, ops
    from deap_tpu_torch.benchmarks import cartpole
    from deap_tpu_torch.core.population import gather, init_population
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.ops import kernels
    from deap_tpu_torch.support.stats import mean0

    # --------------------------------------- J5's transcendentals --
    g = make_generator(31, dev)
    x = torch.cat([torch.randn(1 << 22, generator=g, device=dev) * sc
                   for sc in (0.05, 0.3, 3.0, 10.0, 1e4)] + [
        torch.randint(-2 ** 31, 2 ** 31, (1 << 22,), generator=g,
                      device=dev, dtype=torch.int32).view(torch.float32),
        torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan,
                      cartpole.TANH_ONE, -cartpole.TANH_ONE,
                      math.nextafter(cartpole.TANH_ONE, 0.0)], device=dev)])
    for name, got, want in zip(("sin", "cos", "tanh_sat"),
                               cartpole.cartpole_math(x),
                               (torch.sin(x), torch.cos(x),
                                cartpole.tanh_sat(x))):
        if not bitwise_equal(got, want):
            fail(f"J5's {name} differs from torch's on the card")
    print(f"{tag} J5's sinf, cosf and saturated tanhf == torch.sin, "
          f"torch.cos, tanh_sat bitwise on {x.numel()} floats (normal at 5 "
          f"scales, every bit pattern, edges)")
    pairs = j5_division_check(torch, dev)
    print(f"{tag} J5's division == torch's bitwise on {pairs} pairs (every "
          f"float32 over the total mass, random bit patterns, divisors in "
          f"[0.6, 0.7])")

    # ----------------------------------------------------- J5 checks --
    _, n = cartpole.mlp_policy(CP_SIZES)
    bal = balancing_genome(torch, dev)
    starts5 = cartpole.initial_state(g, 5)
    r = j5_check(torch, bal[None].repeat(3, 1), starts5, CP_STEPS,
                 "the balancing genome")
    if not bool((r == CP_STEPS).all()):
        fail(f"the balancing genome fell: {r.tolist()}")
    odd = torch.randn((33, n), generator=g, device=dev)
    odd[0, 0] = math.nan
    odd[1, 100] = math.inf
    odd[2, 112] = -math.inf
    odd[3] = math.nan
    odd[4, 64] = math.inf
    odd[5, 80:82] = torch.tensor([math.inf, -math.inf], device=dev)
    j5_check(torch, odd, starts5, 200, "NaN and infinite genes")
    cases = 0
    for P, E, S in j5_shapes():
        sigma = 3.0 if cases % 2 else CP_SIGMA
        gen_ = torch.randn((P, n), generator=g, device=dev) * sigma
        j5_check(torch, gen_, cartpole.initial_state(g, E), S,
                 f"P {P}, E {E}, max_steps {S}")
        cases += 1
    for H_ in J5_WIDTHS:
        j5_check(torch, torch.randn((257, 7 * H_ + 2), generator=g,
                                    device=dev),
                 cartpole.initial_state(g, 3), 200, f"H {H_}", (4, H_, 2))
    capped_genomes, capped_starts = (j5_capped_population(torch, dev, g),
                                     starts5[:CP_EPISODES])
    capped_r = j5_check(torch, capped_genomes, capped_starts, CP_STEPS,
                        "the all-at-the-cap population")
    if not bool((capped_r == CP_STEPS).all()):
        fail(f"the all-at-the-cap population fell: "
             f"{int((capped_r < CP_STEPS).sum())} episodes short of the cap")
    print(f"{tag} J5 == plain bitwise on the balancing genome (every "
          f"episode {CP_STEPS} steps), NaN and infinite genes, {cases} "
          f"shapes (P {J5_POPS} x E {J5_EPISODES} x max_steps {J5_STEPS}, "
          f"sigma {CP_SIGMA} and 3), H {J5_WIDTHS} (unrolled instance "
          f"{cartpole.J5_UNROLLED_HIDDEN}, the rest at run time) and "
          f"{J5_CAPPED_POP} perturbed balancing genomes x 3 starts, every "
          f"episode at the cap")
    print_ptxas("cartpole_rollout", "cartpole_rollout_kernel")

    # ------------------------- cartpole_neuro_pop10k at full width --
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g, starts, tb, pop = cartpole_start(dev, 11)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pop0 = pop
    fits = [pop.fitness[:, 0]]
    for _ in range(CP_NGEN):
        pop = cartpole_generation(g, pop, tb)
        fits.append(pop.fitness[:, 0])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    j5_launches = cartpole.cartpole_rollout.launches
    k1_launches = kernels.fused_variation.launches
    if j5_launches != CP_NGEN + 1 or k1_launches != 0:
        fail(f"cart-pole: J5 launched {j5_launches} times (want "
             f"{CP_NGEN + 1}), K1 {k1_launches} (want 0)")
    best = [float(f.max()) for f in fits]
    mean = [float(f.mean()) for f in fits]
    capped = [int((f == CP_STEPS).sum()) for f in fits]
    # the best fitness cannot pass the cap: where gen 0 already reaches it,
    # more policies must reach it after the run
    if not (bool(pop.valid.all()) and all(math.isfinite(v) for v in mean)
            and mean[-1] > mean[0] and (best[-1] > best[0] or (
                best[0] == best[-1] == CP_STEPS and capped[-1] > capped[0]))):
        fail(f"cart-pole did not improve: best {best[0]} -> {best[-1]}, "
             f"mean {mean[0]} -> {mean[-1]}, policies at the cap "
             f"{capped[0]} -> {capped[-1]}")
    returns = {}
    for label, p in (("gen 0", pop0), (f"gen {CP_NGEN}", pop)):
        r = j5_check(torch, p.genomes, starts, CP_STEPS,
                     f"the {label} population")
        returns[label] = r
        if not torch.equal(p.fitness[:, 0], mean0(r.T)):
            fail(f"cart-pole {label}: the fitness is not the mean return")
    r0, rn = returns["gen 0"], returns[f"gen {CP_NGEN}"]
    ms_gen = (t2 - t1) / CP_NGEN * 1e3
    print(f"{tag} cartpole_neuro_pop10k (bench_suite.py): pop {CP_POP}, "
          f"mlp_policy{CP_SIZES}, {CP_EPISODES} episodes of up to "
          f"{CP_STEPS} steps: start {(t1 - t0) * 1e3:.3f} ms (init and gen-0 "
          f"evaluation), {CP_NGEN} generations in {(t2 - t1):.3f} s = "
          f"{ms_gen:.3f} ms/gen; best {best[0]:.3f} -> {best[-1]:.3f}, mean "
          f"{mean[0]:.3f} -> {mean[-1]:.3f}, policies at the cap "
          f"{capped[0]} -> {capped[-1]}; J5 launches {j5_launches}, K1 "
          f"{k1_launches}; alive steps gen 0 {int(r0.sum())}, gen "
          f"{CP_NGEN} {int(rn.sum())}; longest episode {int(r0.max())} -> "
          f"{int(rn.max())} steps; episodes at the cap "
          f"{int((r0 == CP_STEPS).sum())} -> {int((rn == CP_STEPS).sum())}")

    # a generation in its parts (host clock to a synchronised card):
    # selection and variation, the evaluation (J5 and the mean), the whole
    idx = tb.select(g, pop.wvalues, pop.size)
    parts = {
        "select_vary": whole_ms(torch, lambda: algorithms.var_and(
            g, gather(pop, tb.select(g, pop.wvalues, pop.size)), tb,
            CP_CXPB, CP_MUTPB)),
        "evaluate": whole_ms(torch, lambda: tb.evaluate(pop.genomes[idx])),
        "generation": whole_ms(torch, lambda: cartpole_generation(g, pop,
                                                                  tb))}
    print(f"{tag} cart-pole generation in parts (evolved population, median "
          f"of 5, host clock): selection and variation "
          f"{parts['select_vary']:.3f} ms, evaluation "
          f"{parts['evaluate']:.3f} ms, the whole {parts['generation']:.3f} "
          f"ms")

    # ---------------------------------------------- J5 timed --
    flush = torch.empty(2 ** 27, dtype=torch.int32, device=dev)
    clocks = torch.zeros(1, dtype=torch.int64, device=dev)
    cartpole.cartpole_rollout(bal[None], starts[:1], CP_STEPS, clocks=clocks)
    step_clocks = int(clocks.item()) / CP_STEPS
    clock = max_sm_clock_hz()
    H = CP_SIZES[1]
    times = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    instructions, whole, opcodes = j5_step_instructions(H=H)
    print(f"{tag} J5 width-{H} instance: {instructions} instructions a step "
          f"({whole} in its step loop with the slow paths; cuobjdump -sass): "
          + ", ".join(f"{k} {v}" for k, v in opcodes.items()))
    for label, genomes, st, r in (
            ("gen0", pop0.genomes, starts, r0),
            ("evolved", pop.genomes, starts, rn),
            ("capped", capped_genomes, capped_starts, capped_r)):
        genomes = genomes.contiguous()
        ms = time_ms(lambda: cartpole.cartpole_rollout(genomes, st,
                                                       CP_STEPS), flush)
        plain_ms = time_ms(lambda: cartpole.cartpole_rollout_plain(
            genomes, st, CP_STEPS), flush, reps=1)
        floor_ms = float(r.max()) * step_clocks / clock * 1e3
        issue_ms = j5_issue_floor_ms(r, instructions, sms, clock)
        warp_steps = j5_warp_steps(r)
        at_cap = int((warp_steps == CP_STEPS).sum())
        # the clocks each scheduler spent a warp-step, had the launch been
        # set by issue alone
        per_warp_step = ms * 1e-3 * clock * 4 * sms / float(
            warp_steps.double().sum())
        times[label] = dict(ms=ms, plain_ms=plain_ms, floor_ms=floor_ms,
                            issue_floor_ms=issue_ms, warps_at_cap=at_cap,
                            clocks_per_warp_step=per_warp_step,
                            alive=int(r.sum()), longest=int(r.max()))
        print(f"{tag} J5 on the {label} population: {ms * 1e3:.2f} us a "
              f"launch; plain {plain_ms * 1e3:.2f} us; the longest episode "
              f"{int(r.max())} steps x {step_clocks:.1f} clocks a step (one "
              f"thread alone, max SM clock {clock / 1e6:.0f} MHz) = chain "
              f"floor {floor_ms * 1e3:.2f} us; issue floor "
              f"{issue_ms * 1e3:.2f} us ({int(warp_steps.sum())} warp-steps "
              f"x {instructions} instructions over {4 * sms} schedulers; "
              f"{at_cap} of {warp_steps.numel()} warps at the cap, "
              f"{at_cap / sms:.2f} an SM); {per_warp_step:.1f} scheduler "
              f"clocks a warp-step; {int(r.sum())} alive steps")
    # what J5 must move: the genomes and starts in once, the returns out
    nbytes = CP_POP * n * 4 + CP_EPISODES * 16 + CP_POP * CP_EPISODES * 4
    record("j5", "cartpole_rollout",
           "deap_tpu_torch/csrc/cartpole_rollout.cu",
           "deap_tpu/benchmarks/cartpole.py:82", 0.0, times["gen0"]["ms"],
           times["gen0"]["plain_ms"], nbytes,
           f32_ops=times["gen0"]["alive"] * j5_step_ops(H))
    ev = times["evolved"]
    report["j5"].update(
        launches=j5_launches, chain_floor_ms=times["gen0"]["floor_ms"],
        step_clocks=step_clocks, longest_steps=times["gen0"]["longest"],
        alive_steps=times["gen0"]["alive"], ms_per_gen=ms_gen,
        ms_evolved=ev["ms"], plain_ms_evolved=ev["plain_ms"],
        chain_floor_ms_evolved=ev["floor_ms"],
        longest_steps_evolved=ev["longest"], alive_steps_evolved=ev["alive"],
        policies_at_cap=[capped[0], capped[-1]], generation_parts_ms=parts,
        issue_floor_ms=times["gen0"]["issue_floor_ms"],
        issue_floor_ms_evolved=ev["issue_floor_ms"],
        step_instructions=instructions,
        ms_capped=times["capped"]["ms"],
        issue_floor_ms_capped=times["capped"]["issue_floor_ms"],
        chain_floor_ms_capped=times["capped"]["floor_ms"],
        bound_ms_evolved=max(
            nbytes / memory_rate(torch.cuda.get_device_name(0)),
            ev["alive"] * j5_step_ops(H) / compare_rate(dev)) * 1e3)
    print(f"  J5 evolved bound {report['j5']['bound_ms_evolved'] * 1e3:.2f} "
          f"us")
    del flush

    # ------------------------- K1's set kind: mut_uniform_int --
    tb = Toolbox()
    tb.register("mate", ops.cx_two_point)
    tb.register("mutate", ops.mut_uniform_int, low=0, up=9, indpb=INDPB)
    for n_, L_ in ((N, L), (1001, 33)):
        pop = init_population(make_generator(5, dev), n_,
                              ops.randint_genome(L_, 0, 9), FitnessSpec(
                                  (1.0,)), device=dev)
        pop = pop.replace(genomes=pop.genomes.to(torch.float32))
        pop = pop.with_fitness(torch.zeros((n_, 1), device=dev))
        sel = torch.randint(0, n_, (n_,), generator=make_generator(6, dev),
                            device=dev)
        before = kernels.fused_variation.launches
        got = algorithms.var_and(make_generator(7, dev), pop, tb, CXPB,
                                 MUTPB, fused="auto", sel_idx=sel)
        launched = kernels.fused_variation.launches - before
        want = algorithms.var_and(make_generator(7, dev), pop, tb, CXPB,
                                  MUTPB, fused=False, sel_idx=sel)
        torch.cuda.synchronize()
        if launched != 1 or not (bitwise_equal(got.genomes, want.genomes)
                                 and torch.equal(got.valid, want.valid)):
            fail(f"var_and with mut_uniform_int at n {n_}, L {L_}: K1 "
                 f"launched {launched} times or differs from the unfused "
                 f"composition")
    report["k1"]["set_kind_var_and"] = True
    print(f"{tag} var_and(fused='auto') with mut_uniform_int takes K1's set "
          f"kind (one launch) == the unfused composition bitwise at n {N}, "
          f"L {L} and n 1001, L 33 (float32 genomes)")


def cartpole_toolbox(starts):
    """bench_suite.py's cartpole_neuro_pop10k operators: the fitness is the
    mean return over the episode starts ``starts [E, 4]`` of
    ``mlp_policy((4, 16, 2))`` genomes (J5 on the card; the sum times
    float32(1/E), as jnp.mean rounds it), blend crossover (alpha 0.1),
    Gaussian mutation (sigma 0.3, indpb 0.1), tournaments of 3."""
    from deap_tpu_torch import Toolbox, ops
    from deap_tpu_torch.benchmarks import cartpole
    from deap_tpu_torch.support.stats import mean0
    policy, _ = cartpole.mlp_policy(CP_SIZES)
    tb = Toolbox()
    tb.register("evaluate", lambda g: mean0(cartpole.rollout_population(
        policy, g, starts, CP_STEPS).T))
    tb.register("mate", ops.cx_blend, alpha=CP_ALPHA)
    tb.register("mutate", ops.mut_gaussian, mu=0.0, sigma=CP_MUT_SIGMA,
                indpb=CP_INDPB)
    tb.register("select", ops.sel_tournament, tournsize=TOURNSIZE)
    return tb


def cartpole_start(dev, seed, pop_size=None):
    """bench_suite.py's start: a generator, the 3 episode starts fixed for
    the run, the toolbox, and ``pop_size`` (CP_POP) genomes N(0, 0.5²)
    evaluated and placed on the one-device mesh."""
    from deap_tpu_torch import FitnessSpec, algorithms, ops, parallel
    from deap_tpu_torch.benchmarks import cartpole
    from deap_tpu_torch.core.population import init_population
    from deap_tpu_torch.device import make_generator
    g = make_generator(seed, dev)
    starts = cartpole.initial_state(g, CP_EPISODES)
    tb = cartpole_toolbox(starts)
    _, n = cartpole.mlp_policy(CP_SIZES)
    pop = init_population(g, pop_size or CP_POP,
                          ops.normal_genome(n, sigma=CP_SIGMA),
                          FitnessSpec((1.0,)), device=dev)
    pop = algorithms.evaluate_invalid(pop, tb.evaluate)
    pop = parallel.shard_population(pop, parallel.population_mesh(
        device=dev))
    return g, starts, tb, pop


def cartpole_generation(g, pop, tb):
    """bench_suite.py's cart-pole step: tournament selection of the whole
    population, ``var_and`` (cxpb 0.5, mutpb 0.5: blend has no fused
    form, so the unfused composition), evaluation of the changed rows."""
    from deap_tpu_torch import algorithms
    from deap_tpu_torch.core.population import gather
    idx = tb.select(g, pop.wvalues, pop.size)
    off = algorithms.var_and(g, gather(pop, idx), tb, CP_CXPB, CP_MUTPB)
    return algorithms.evaluate_invalid(off, tb.evaluate)


def zdt1_toolbox():
    """bench_suite.py's ZDT1 operators: zdt1 at 30 genes, bounded SBX and
    polynomial mutation (eta 20, bounds 0 and 1, indpb 1/30)."""
    from deap_tpu_torch import Toolbox, ops
    from deap_tpu_torch import benchmarks as bm
    tb = Toolbox()
    tb.register("evaluate", bm.zdt1)
    tb.register("mate", ops.cx_simulated_binary_bounded, eta=ZDT1_ETA,
                low=0.0, up=1.0)
    tb.register("mutate", ops.mut_polynomial_bounded, eta=ZDT1_ETA, low=0.0,
                up=1.0, indpb=1.0 / ZDT1_DIM)
    return tb


def zdt1_start(dev, seed, mu, tb):
    """A generator and an evaluated population of ``mu`` uniform genomes of
    30 genes in [0, 1] (bench_suite.py's init)."""
    from deap_tpu_torch import FitnessSpec, algorithms, ops
    from deap_tpu_torch.core.population import init_population
    from deap_tpu_torch.device import make_generator
    g = make_generator(seed, dev)
    pop = init_population(g, mu, ops.uniform_genome(ZDT1_DIM, 0.0, 1.0),
                          FitnessSpec((-1.0, -1.0)), device=dev)
    return g, algorithms.evaluate_invalid(pop, tb.evaluate)


def nsga2_zdt1_generation(g, pop, tb, nd="standard", unions=None):
    """bench_suite.py's ZDT1 NSGA-II generation (bench_nsga2's and
    bench_nsga2_50k's step): DCD mating selection of mu parents,
    ``var_and`` (cxpb 0.9, mutpb 1.0), evaluation, ``sel_nsga2`` over the
    union of 2 mu rows. ``unions`` collects each union's weighted
    values. Returns the survivors."""
    from deap_tpu_torch import algorithms, mo
    from deap_tpu_torch.core.population import concat, gather
    mu = pop.size
    idx = mo.sel_tournament_dcd(g, pop.wvalues, mu)
    off = algorithms.var_and(g, gather(pop, idx), tb, ZDT1_CXPB, ZDT1_MUTPB)
    off = algorithms.evaluate_invalid(off, tb.evaluate)
    pool = concat([pop, off])
    if unions is not None:
        unions.append(pool.wvalues)
    return gather(pool, mo.sel_nsga2(None, pool.wvalues, mu, nd=nd))


def nd_scan_phases(torch, dev, tag, report, record):
    """Phase 11b: J3 and J4 (``csrc/nd_scan.cu``) against their plain
    versions and K7's ranks, timed beside their bounds and chain floors;
    bench_suite.py's two ZDT1 NSGA-II configurations; J4 through
    ``sel_nsga2(nd='sweep')`` on NSGA-II's DTLZ2 union; the native
    hypervolume."""
    from deap_tpu_torch import algorithms, mo, native
    from deap_tpu_torch import benchmarks as bm
    from deap_tpu_torch.core.population import concat, gather
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.mo import emo, ndsort
    from deap_tpu_torch.ops import kernels

    if not native.HAVE_NATIVE_HV:
        fail("the native hypervolume did not build (HAVE_NATIVE_HV False)")
    flush = torch.empty(2**27, dtype=torch.int32, device=dev)  # 512 MB
    seeds = iter(range(1000, 2000))

    # --------------------------------------------------- J3 checks --
    def j3_check(w, what, slots=emo.J3_SHARED_SLOTS):
        _, neg, head = emo.staircase_inputs(w)
        with j3_shared_slots(emo, slots):
            got = emo.staircase_rows(neg, head)
        want = emo.staircase_rows_plain(neg, head)
        torch.cuda.synchronize()
        if not bitwise_equal(got, want):
            fail(f"J3 differs from its plain version on {what}")
        return got

    cases = 0
    for n in ND_SIZES:
        for kind in ND_KINDS:
            j3_check(nd_scan_rows(torch, dev, kind, n, 2, next(seeds)),
                     f"{kind} rows, n={n}")
            cases += 1
    # the front maxima across the edge of shared memory: forced low on a
    # 2000-row chain, then at the card's capacity on chains around it
    for slots in (1, 31, 32, 33, 1000, 1999, 2000, emo.j3_slots(2000)):
        j3_check(nd_scan_rows(torch, dev, "chain", 2000, 2, 7),
                 f"a 2000-row chain, {slots} shared slots", slots)
        cases += 1
    for n in (emo.J3_SHARED_SLOTS, emo.J3_SHARED_SLOTS + 1, 2 * ZDT1_MU):
        ranks = j3_check(nd_scan_rows(torch, dev, "chain", n, 2, 8),
                         f"a {n}-row chain")
        if int(ranks.max()) != n - 1:
            fail(f"J3 found {int(ranks.max()) + 1} fronts in a {n}-chain")
        cases += 1
    print(f"{tag} J3 staircase_rows == plain bitwise at {cases} cases "
          f"(n {', '.join(map(str, ND_SIZES))} by {', '.join(ND_KINDS)}; "
          f"a 2000-row chain with 1-{emo.j3_slots(2000)} "
          f"shared slots; chains of {emo.J3_SHARED_SLOTS}, "
          f"{emo.J3_SHARED_SLOTS + 1} and {2 * ZDT1_MU} rows, their maxima "
          f"past shared memory)")
    print_ptxas("nd_scan", "staircase_kernel")

    # J3 at the 50k run's sizes on ZDT1 values of uniform genomes: time,
    # bound (bytes: neg_f2 and head read, ranks written), the chunk floor
    # (the same kernel on one front of as many rows: every chunk's search,
    # ranks and stores, its chain skipped, since no row's x is above an
    # earlier one's) and the same pass with every front maximum in device
    # memory (one shared slot, the same search), the yardstick of the split
    gen = make_generator(41, dev)
    j3 = {}
    for n in J3_SIZES:
        w = -bm.zdt1(torch.rand((n, ZDT1_DIM), generator=gen, device=dev))
        _, neg, head = emo.staircase_inputs(w)
        got = j3_check(w, f"ZDT1 values, n={n}")
        ms = time_ms(lambda: emo.staircase_rows(neg, head), flush)
        with j3_shared_slots(emo, 1):
            device_ms = time_ms(lambda: emo.staircase_rows(neg, head), flush)
        plain_ms = time_ms(lambda: emo.staircase_rows_plain(neg, head),
                           flush, reps=3)
        _, neg1, head1 = emo.staircase_inputs(nd_scan_rows(
            torch, dev, "one_front", n, 2, 9))
        floor_ms = time_ms(lambda: emo.staircase_rows(neg1, head1), flush)
        heads = int(head.sum())
        fronts = int(got.max()) + 1
        j3[n] = dict(ms=ms, plain_ms=plain_ms, chunk_floor_ms=floor_ms,
                     device_ms=device_ms, nbytes=9 * n)
        print(f"{tag} J3 at n={n} (ZDT1, {fronts} fronts, {heads} heads): "
              f"{ms * 1e3:.2f} us, {ms / n * 1e6:.1f} ns a row; every front "
              f"maximum in device memory {device_ms * 1e3:.2f} us "
              f"({device_ms / ms:.3f}x); plain {plain_ms * 1e3:.2f} us; on "
              f"one front of {n} rows (no chain) {floor_ms * 1e3:.2f} us")
    n = J3_SIZES[1]
    record("j3", "nd_rank_staircase (staircase_rows)",
           "deap_tpu_torch/csrc/nd_scan.cu", "deap_tpu/mo/emo.py:274", 0.0,
           j3[n]["ms"], j3[n]["plain_ms"], j3[n]["nbytes"])
    report["j3"].update(
        chunk_floor_ms=j3[n]["chunk_floor_ms"],
        all_device_ms=j3[n]["device_ms"],
        ms_50k=j3[J3_SIZES[0]]["ms"], plain_ms_50k=j3[J3_SIZES[0]]["plain_ms"],
        chunk_floor_ms_50k=j3[J3_SIZES[0]]["chunk_floor_ms"],
        all_device_ms_50k=j3[J3_SIZES[0]]["device_ms"])

    # --------------------------------------------------- J4 checks --
    def j4_check(w, what):
        _, Q, U, head, F = ndsort.sweep3_inputs(w)
        got = ndsort.sweep3_rows(Q, U, head, F)
        want = ndsort.sweep3_rows_plain(Q, U, head, F)
        torch.cuda.synchronize()
        if not bitwise_equal(got, want):
            fail(f"J4 differs from its plain version on {what}")
        return (Q, U, head, F), got

    cases = 0
    for n in ND_SIZES:
        for kind in ND_KINDS:
            j4_check(nd_scan_rows(torch, dev, kind, n, 3, next(seeds)),
                     f"{kind} rows, n={n}")
            cases += 1
    # tables wider than the sweep's own (chunks of 28 and 12 rows)
    for cols in (484, 1024):
        Q, U, head = nd_random_tables(torch, dev, 1000, cols, 3000, 0.1, cols)
        got = ndsort.sweep3_rows(Q, U, head, 3000)
        if not bitwise_equal(got, ndsort.sweep3_rows_plain(Q, U, head, 3000)):
            fail(f"J4 differs from its plain version on random tables of "
                 f"{cols} columns")
        cases += 1
    n = 2 * MO_POP
    _, ranks = j4_check(nd_scan_rows(torch, dev, "chain", n, 3, 8),
                        f"a {n}-row chain")
    if int(ranks.max()) != n - 1:
        fail(f"J4 found {int(ranks.max()) + 1} fronts in a {n}-chain")
    print(f"{tag} J4 sweep3_rows == plain bitwise at {cases + 1} cases (n "
          f"{', '.join(map(str, ND_SIZES))} by {', '.join(ND_KINDS)}; "
          f"random tables of 484 and 1024 columns; a {n}-row chain, {n} "
          f"fronts)")
    print_ptxas("nd_scan", "sweep_kernel")
    j4 = {}
    for n in J4_SIZES:
        w = -bm.dtlz2(torch.rand((n, MO_DIM), generator=gen, device=dev),
                      MO_NOBJ)
        args, _ = j4_check(w, f"a DTLZ2 union, n={n}")
        ranks = mo.nd_rank(w, impl="sweep")
        if not torch.equal(ranks, mo.nd_rank(w, impl="tiled")):
            fail(f"nd_rank sweep (J4) differs from tiled (K7) at n={n}")
        # rows beside NaN rows: the sweep's query bounds order NaN as the
        # largest value, so every NaN-free row ranks as K7's peel has it
        w_nan = nd_scan_rows(torch, dev, "nan", n, MO_NOBJ, next(seeds))
        clean = ~torch.isnan(w_nan).any(1)
        if not torch.equal(mo.nd_rank(w_nan, impl="sweep")[clean],
                           mo.nd_rank(w_nan, impl="tiled")[clean]):
            fail(f"nd_rank sweep (J4) differs from tiled (K7) on the "
                 f"NaN-free rows of the nan kind at n={n}")
        ms = time_ms(lambda: ndsort.sweep3_rows(*args), flush)
        plain_ms = time_ms(lambda: ndsort.sweep3_rows_plain(*args), flush,
                           reps=3)
        # the chunk floor: n copies of one row (one head, so every chunk
        # only its staging, owner pass and scatter: no gather, no chain)
        dup = ndsort.sweep3_inputs(w[:1].expand(n, MO_NOBJ).contiguous())
        floor_ms = time_ms(lambda: ndsort.sweep3_rows(*dup[1:]), flush)
        # the whole call a user makes, tables and sort included, through
        # J4 and through K7's peeling (host clock, median of 5)
        whole = {impl: whole_ms(torch, lambda impl=impl: mo.nd_rank(
            w, impl=impl)) for impl in ("sweep", "tiled")}
        Q = args[0]
        j4[n] = dict(ms=ms, plain_ms=plain_ms, chunk_floor_ms=floor_ms,
                     nbytes=2 * Q.numel() * Q.element_size() + n + 4 * n,
                     whole=whole)
        print(f"{tag} J4 at n={n} (DTLZ2, {int(ranks.max()) + 1} fronts, "
              f"{Q.shape[1]} table columns, pool {args[3]} slots): "
              f"{ms * 1e3:.2f} us, {ms / n * 1e6:.1f} ns a row; plain "
              f"{plain_ms * 1e3:.2f} us; on {n} copies of one row (no "
              f"gather, no chain) {floor_ms * 1e3:.2f} us; equal to "
              f"nd='tiled' on every row, and on the {int(clean.sum())} "
              f"NaN-free rows of the nan kind; whole nd_rank (host clock) "
              f"impl='sweep' {whole['sweep']:.3f} ms, impl='tiled' "
              f"{whole['tiled']:.3f} ms")
    n = J4_SIZES[1]
    record("j4", "nd_rank_sweep3 (sweep3_rows)",
           "deap_tpu_torch/csrc/nd_scan.cu", "deap_tpu/mo/ndsort.py:102",
           0.0, j4[n]["ms"], j4[n]["plain_ms"], j4[n]["nbytes"])
    report["j4"].update(
        chunk_floor_ms=j4[n]["chunk_floor_ms"],
        ms_16384=j4[J4_SIZES[0]]["ms"],
        plain_ms_16384=j4[J4_SIZES[0]]["plain_ms"],
        chunk_floor_ms_16384=j4[J4_SIZES[0]]["chunk_floor_ms"],
        nd_rank_sweep_ms=j4[n]["whole"]["sweep"],
        nd_rank_tiled_ms=j4[n]["whole"]["tiled"],
        nd_rank_sweep_ms_16384=j4[J4_SIZES[0]]["whole"]["sweep"],
        nd_rank_tiled_ms_16384=j4[J4_SIZES[0]]["whole"]["tiled"])
    del flush

    # J4 on a main path's selection: bench.py's NSGA-II DTLZ2 generation
    # at mu 50k with its union ranked by nd='sweep' (DCD through K7)
    g = make_generator(43, dev)
    x = torch.rand((MO_POP, MO_DIM), generator=g, device=dev)
    wm = -bm.dtlz2(x, MO_NOBJ)
    inputs = []
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x2, w2 = nsga2_generation(g, x, wm, "sweep", inputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    report["j4"]["launches"] = ndsort.nd_rank_sweep3.launches
    if ndsort.nd_rank_sweep3.launches != 1:
        fail(f"sel_nsga2(nd='sweep') launched J4 "
             f"{ndsort.nd_rank_sweep3.launches} times in one generation")
    union = inputs[1][1]
    if not torch.equal(mo.sel_nsga2(None, union, MO_POP, nd="sweep"),
                       mo.sel_nsga2(None, union, MO_POP, nd="tiled")):
        fail("sel_nsga2 through J4 (sweep) differs from it through K7")
    print(f"{tag} NSGA-II DTLZ2 mu={MO_POP} with nd='sweep': one generation "
          f"in {wall:.3f} s, J4 launches 1, K7 launches "
          f"{kernels.dominated_weight_sums.launches} (DCD); survivors equal "
          f"nd='tiled''s")

    # ------------------------------ bench_suite.py's ZDT1 NSGA-II --
    tb = zdt1_toolbox()
    ref = [11.0, 11.0]
    g, pop = zdt1_start(dev, 51, ZDT1_SMALL_MU, tb)
    hv0 = bm.tools.hypervolume(pop, ref)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ZDT1_SMALL_NGEN):
        pop = nsga2_zdt1_generation(g, pop, tb, "standard")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (emo.nd_rank_staircase.launches,
                ndsort.nd_rank_sweep3.launches)
    if launches != (0, 0):
        fail(f"nsga2_zdt1_pop2000 launched J3, J4 {launches} times: auto "
             f"should take the dominance matrix at 2000 and 4000 rows")
    hv = bm.tools.hypervolume(pop, ref)
    if not (bool(torch.isfinite(pop.fitness).all()) and hv > hv0
            and float(pop.genomes.min()) >= 0.0
            and float(pop.genomes.max()) <= 1.0):
        fail(f"nsga2_zdt1_pop2000's population is wrong (hypervolume "
             f"{hv0} -> {hv})")
    print(f"{tag} nsga2_zdt1_pop2000 (mu {ZDT1_SMALL_MU}, nd='standard'): "
          f"{ZDT1_SMALL_NGEN} generations in {wall:.3f} s = "
          f"{wall / ZDT1_SMALL_NGEN * 1e3:.3f} ms/gen; auto takes the "
          f"dominance matrix at {ZDT1_SMALL_MU} and {2 * ZDT1_SMALL_MU} rows, "
          f"so J3 and J4 launch 0 times; hypervolume of {ref} "
          f"{hv0:.4f} -> {hv:.4f} (native)")

    g, pop = zdt1_start(dev, 52, ZDT1_MU, tb)
    hv0 = bm.tools.hypervolume(pop, ref)
    pop = nsga2_zdt1_generation(g, pop, tb, "staircase")      # warm-up
    unions = []
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ZDT1_NGEN):
        pop = nsga2_zdt1_generation(g, pop, tb, "staircase", unions)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    j3_launches = emo.nd_rank_staircase.launches
    report["j3"]["launches"] = j3_launches
    if j3_launches != 2 * ZDT1_NGEN:
        fail(f"nsga2_zdt1_pop50k launched J3 {j3_launches} times in "
             f"{ZDT1_NGEN} generations (DCD's {ZDT1_MU} rows and the "
             f"union's {2 * ZDT1_MU}: 2 a generation)")
    hv = bm.tools.hypervolume(pop, ref)
    if not (bool(torch.isfinite(pop.fitness).all()) and hv > hv0
            and pop.genomes.shape == (ZDT1_MU, ZDT1_DIM)
            and float(pop.genomes.min()) >= 0.0
            and float(pop.genomes.max()) <= 1.0):
        fail(f"nsga2_zdt1_pop50k's population is wrong (hypervolume "
             f"{hv0} -> {hv})")
    last = unions[-1]
    ranks = mo.nd_rank(last, impl="staircase")
    order, neg, head = emo.staircase_inputs(last)
    plain = torch.empty_like(ranks)
    plain[order] = emo.staircase_rows_plain(neg, head)
    if not bitwise_equal(ranks, plain):
        fail("J3's ranks of the last union differ from the plain version's")
    if not torch.equal(ranks, mo.nd_rank(last, impl="tiled")):
        fail("J3's ranks of the last union differ from nd='tiled''s (K7)")
    print(f"{tag} nsga2_zdt1_pop50k (mu {ZDT1_MU}, union {2 * ZDT1_MU}, "
          f"nd='staircase'): {ZDT1_NGEN} generations in {wall:.3f} s = "
          f"{wall / ZDT1_NGEN * 1e3:.3f} ms/gen; J3 launches {j3_launches} = "
          f"{j3_launches / ZDT1_NGEN:.0f} a generation; the last union's "
          f"ranks ({int(ranks.max()) + 1} fronts) equal the plain "
          f"version's bitwise and nd='tiled''s; hypervolume of {ref} "
          f"{hv0:.4f} -> {hv:.4f} (native)")

    # one more generation in its parts, each alone after a synchronise
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    w = pop.wvalues
    split = {}
    _, split["dcd nd_rank (sort, J3)"] = timed(lambda: mo.nd_rank(w))
    r = mo.nd_rank(w)
    _, split["dcd crowding"] = timed(lambda: mo.crowding_distances(w, r))
    idx, split["dcd whole"] = timed(lambda: mo.sel_tournament_dcd(g, w,
                                                                  ZDT1_MU))
    off, split["variation"] = timed(lambda: algorithms.var_and(
        g, gather(pop, idx), tb, ZDT1_CXPB, ZDT1_MUTPB))
    off, split["evaluation"] = timed(lambda: algorithms.evaluate_invalid(
        off, tb.evaluate))
    pool = concat([pop, off])
    wu = pool.wvalues
    _, split["union nd_rank (sort, J3)"] = timed(lambda: mo.nd_rank(
        wu, impl="staircase", cover_k=ZDT1_MU))
    ru = mo.nd_rank(wu, impl="staircase", cover_k=ZDT1_MU)
    _, split["union crowding"] = timed(lambda: mo.crowding_distances(wu, ru))
    _, split["sel_nsga2 whole"] = timed(lambda: mo.sel_nsga2(
        None, wu, ZDT1_MU, nd="staircase"))
    flush = torch.empty(2**27, dtype=torch.int32, device=dev)
    for what, v in (("J3 device, DCD", w), ("J3 device, union", wu)):
        _, neg, head = emo.staircase_inputs(v)
        split[what] = time_ms(lambda: emo.staircase_rows(neg, head), flush,
                              reps=5)
    del flush
    ms_gen = wall / ZDT1_NGEN * 1e3
    j3_gen = split["J3 device, DCD"] + split["J3 device, union"]
    report["j3"].update(zdt1_50k_ms_per_gen=ms_gen, zdt1_50k_j3_ms=j3_gen)
    print(f"{tag} nsga2_zdt1_pop50k, one generation in parts (ms, host "
          f"clock around each part alone; J3 device by CUDA events): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f"; J3 {j3_gen:.3f} ms of the loop's {ms_gen:.3f} ms/gen = "
          f"{j3_gen / ms_gen:.1%}")

def gp_phases(torch, dev, tag, report, record):
    """Phase 12: K9 at the GP path's shapes, and bench_gp.py's symbolic
    regression through it."""
    from deap_tpu_torch import gp
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.ops import kernels

    flush = torch.empty(2**27, dtype=torch.int32, device=dev)  # 512 MB
    rate = memory_rate(torch.cuda.get_device_name(0))
    pset = gp.math_set(1)
    X, y = symbreg_data(dev)

    # ----------------------------------- K9 gp_grouped_dispatch check --
    def k9_check(what, genomes, Xk, chunk=128):
        """K9 and its plain version on the grouped schedule of
        ``genomes`` (deduped, as the loop's evaluator builds it), over the
        whole value buffer; returns the schedule, the error and both
        timing closures."""
        interp = gp.make_batch_interpreter(pset, genomes["nodes"].shape[1],
                                           mode="grouped", chunk=chunk)
        sched, _ = interp.schedule(genomes)
        args = [torch.from_numpy(sched[k]).to(dev) for k in
                ("chunk_ops", "src_idx", "src_const", "src_isc")]
        buf = torch.zeros((pset.n_args + sched["nchunks"] * chunk,
                           Xk.shape[0]), device=dev)
        buf[:pset.n_args] = Xk.T
        # the kernel's instruction rows start as NaN: a row read before
        # its level wrote it would show in the result
        bufs = [buf.clone(), buf.clone()]
        bufs[0][pset.n_args:] = float("nan")
        kw = dict(chunk=chunk, n_args=pset.n_args)

        def kernel():
            return kernels.gp_grouped_dispatch(
                bufs[0], *args, interp.branches,
                levels=sched["level_starts"], **kw)

        def plain():
            return kernels.gp_grouped_dispatch_plain(bufs[1], *args,
                                                     interp.branches, **kw)

        k9 = kernels.gp_grouped_dispatch
        before = (k9.launches, k9.levels)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        nlevels = len(sched["level_starts"]) - 1
        if (k9.launches, k9.levels) != (before[0] + 1, before[1] + nlevels):
            fail(f"gp_grouped_dispatch on {what}: {k9.launches - before[0]} "
                 f"launches over {k9.levels - before[1]} levels, not one "
                 f"over {nlevels}")
        if not bitwise_equal(got, want):
            fail(f"gp_grouped_dispatch differs from the plain version on "
                 f"{what}")
        err = max_abs_err(got.nan_to_num(), want.nan_to_num())
        print(f"{tag} gp_grouped_dispatch == plain bitwise over the whole "
              f"value buffer on {what}, in one launch: "
              f"{sched['n_instructions']} "
              f"instructions of {len(sched['root_idx'])} distinct trees "
              f"in {sched['nchunks']} chunks of {chunk}, "
              f"{len(sched['level_starts']) - 1} levels, P {Xk.shape[0]} "
              f"(cos/sin: cosf/sinf on both sides)")
        return sched, interp.branches, err, kernel, plain

    g = make_generator(47, dev)
    small = gp.gen_half_and_half(pset, 24, 1, 4)(g, 37)
    _, _, err_small, _, _ = k9_check(
        "a small odd case (pop 37, width 24, P 7)", small,
        torch.rand((7, 1), generator=g, device=dev) * 4 - 2)
    genomes = gp.gen_half_and_half(pset, GP_ML, 1, 2)(g, GP_POP)
    sched, branches, err, kernel, plain = k9_check(
        f"gen_half_and_half(1, 2) at pop {GP_POP}, width {GP_ML}", genomes, X)
    record("k9", "gp_grouped_dispatch", "deap_tpu_torch/csrc/gp_grouped.cu",
           "deap_tpu/ops/kernels.py:306", max(err, err_small),
           time_ms(kernel, flush), time_ms(plain, flush, reps=5),
           k9_bytes(sched, branches, GP_P))
    table, _, _ = kernels.k9_work_items(sched["level_starts"], 128, GP_P)
    print(f"  K9: one launch of {len(table)} work items "
          f"({table[0, 1] - table[0, 0]} rows x {GP_P} points each)")
    print_ptxas("gp_grouped", "gp_items_kernel")

    # ------------------- a small symbreg run: kernel == plain, bitwise --
    runs = []
    for use_plain in (False, True):
        g, start, run = symbreg_start(dev, 43, GP_SMALL_POP)
        interp = run.interpreter
        if use_plain:
            interp.grouped_dispatch = (
                lambda *a, levels, **k: kernels.gp_grouped_dispatch_plain(
                    *a, **k))
        heights = []
        unique = interp.unique

        def counted(trees, Xe, unique=unique, heights=heights):
            # the schedule's levels are the distinct depths of operator
            # nodes: the tallest tree's height (one level when no tree
            # has an operator)
            heights.append(max(1, int(gp.tree_height(trees, pset).max())))
            return unique(trees, Xe)

        interp.unique = counted
        k9 = kernels.gp_grouped_dispatch
        before = (k9.launches, k9.levels)
        runs.append(run(g, start, GP_SMALL_NGEN))
        launched = (k9.launches - before[0], k9.levels - before[1])
        # one launch per evaluation, its levels the evaluated heights
        want = (0, 0) if use_plain else (len(heights), sum(heights))
        if launched != want or interp.levels_run != sum(heights):
            fail(f"symbreg small run (plain={use_plain}): K9 launched "
                 f"{launched[0]} times over {launched[1]} levels, "
                 f"interp.levels_run {interp.levels_run}, for "
                 f"{len(heights)} evaluations whose trees' heights sum to "
                 f"{sum(heights)}")
    same = all(bitwise_equal(runs[0]["genomes"][k], runs[1]["genomes"][k])
               for k in ("nodes", "consts", "length"))
    if not (same and bitwise_equal(runs[0]["fitness"], runs[1]["fitness"])
            and runs[0]["nevals"] == runs[1]["nevals"]):
        fail("symbreg through K9 differs from it through the plain version")
    print(f"{tag} symbreg pop={GP_SMALL_POP}, {GP_SMALL_NGEN} generations: "
          f"through K9 == through the plain version bitwise (genomes, "
          f"fitness, nevals); K9 launches {len(heights)} = the "
          f"evaluations, its levels {sum(heights)} = the evaluated trees' "
          f"heights")

    # ------------------------------- bench_gp.py's symbreg at full width --
    g, start, run = symbreg_start(dev, 1, GP_POP)
    scan = gp.make_batch_interpreter(pset, GP_ML, mode="scan")

    def mse(trees):
        return ((scan(trees, X) - y) ** 2).mean(1)

    start_best = float(mse(start).nan_to_num(float("inf")).min())
    reset_counts()
    run.interpreter.levels_run = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run(g, start, GP_NGEN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k9 = kernels.gp_grouped_dispatch.launches
    k9_levels = kernels.gp_grouped_dispatch.levels
    evaluations = 1 + sum(1 for ne in res["nevals"][1:] if ne)
    report["k9"]["launches"] = k9
    if (k9 != evaluations or k9_levels != run.interpreter.levels_run
            or k9 < GP_NGEN + 1):
        fail(f"K9 launched {k9} times over {k9_levels} levels for "
             f"{evaluations} evaluations of {run.interpreter.levels_run} "
             f"levels in {GP_NGEN} generations")
    best = -res["best_fitness"]
    fit = res["fitness"]
    # the scan mode, the JAX package's oracle, recomputes every row: NaN in
    # the same rows, the rest equal up to the MSE's summation order
    want = -mse(res["genomes"])
    nan = torch.isnan(fit)
    if not (fit.shape == (GP_POP,) and torch.equal(nan, torch.isnan(want))
            and torch.allclose(fit[~nan], want[~nan], rtol=1e-5, atol=0.0)):
        fail("the symbreg run's fitness disagrees with the scan "
             "interpreter's")
    if not best <= GP_MSE_GATE:
        fail(f"symbreg best MSE {best} is above the gate {GP_MSE_GATE}")
    nevals = res["nevals"]
    print(f"{tag} symbreg (bench_gp.py) pop={GP_POP} width={GP_ML} "
          f"P={GP_P}: {GP_NGEN} generations in {wall:.3f} s incl. gen-0 "
          f"evaluation = {GP_NGEN / wall:.3f} gens/s; best MSE "
          f"{start_best:.6f} -> {best:.6f} (gate {GP_MSE_GATE}); nevals "
          f"gen 0 {nevals[0]}, then mean "
          f"{statistics.mean(nevals[1:]):.1f} per generation "
          f"(min {min(nevals[1:])}, max {max(nevals[1:])}); {int(nan.sum())} "
          f"NaN rows; K9 launches {k9} = the evaluations, over {k9_levels} "
          f"levels = interp.levels_run ({k9_levels / k9:.2f} a launch)")
    print(f"  best tree: {gp.to_string(res['best_genome'], pset)}")
    print(f"  nevals per generation: {nevals}")

    # K9 on the evolved population, the shape most generations give it
    sched, branches, err_evolved, kernel, plain = k9_check(
        f"the evolved population after {GP_NGEN} generations",
        res["genomes"], X)
    report["k9"]["max_abs_err"] = max(report["k9"]["max_abs_err"],
                                      err_evolved)
    nbytes = k9_bytes(sched, branches, GP_P)
    ms, plain_ms = time_ms(kernel, flush), time_ms(plain, flush, reps=3)
    print(f"{tag} gp_grouped_dispatch on the evolved population: "
          f"{ms * 1e3:.2f} us (bound {nbytes / rate * 1e6:.2f} us by bytes: {nbytes / 1e6:.2f} MB; plain {plain_ms * 1e3:.2f} "
          f"us)")
    del flush


def ant_trees(g):
    """The J2 checks' trees: ``ANT_POP`` of ``examples/gp/ant.py``'s
    ``gen_half_and_half(1, 4)`` at width ``ANT_ML``, the second half
    replaced by one-point crossover children of the two halves (their
    padding holds copies of other nodes)."""
    import torch
    from deap_tpu_torch import gp
    from deap_tpu_torch.gp import ant
    apset = ant.ant_pset()
    trees = gp.gen_half_and_half(apset, ANT_ML, 1, 4)(g, ANT_POP)
    half = ANT_POP // 2
    kids, _ = gp.make_cx_one_point(apset)(
        g, {k: v[:half] for k, v in trees.items()},
        {k: v[half:] for k, v in trees.items()})
    return {k: torch.cat([trees[k][:half], kids[k]]) for k in trees}


def ant_evolved(g, trail, start_cell):
    """``examples/gp/ant.py``'s program at full width through J2 (pop
    ``ANT_POP``, width ``ANT_ML``, ``ANT_MOVES`` moves; one-point crossover
    and ``mut_uniform`` under ``static_limit(17)``, tournament 7, cxpb 0.5,
    mutpb 0.2) for ``ANT_NGEN`` generations, every launch count set to 0
    just before ``ea_simple``: ``(population, hall of fame, seconds)``."""
    import torch
    from deap_tpu_torch import FitnessSpec, Toolbox, algorithms, gp, ops
    from deap_tpu_torch.core.population import init_population
    from deap_tpu_torch.gp import ant
    dev = g.device
    apset = ant.ant_pset()
    limit = gp.static_limit(lambda gg: gp.tree_height(gg, apset), 17)
    tb = Toolbox()
    tb.register("evaluate", ant.make_ant_evaluator(
        apset, ANT_ML, trail, start_cell, max_moves=ANT_MOVES))
    tb.register("mate", limit(gp.make_cx_one_point(apset)))
    tb.register("mutate", limit(gp.make_mut_uniform(
        apset, gp.make_generator(apset, 24, 0, 2, "full"))))
    tb.register("select", ops.sel_tournament, tournsize=7)
    pop = init_population(g, ANT_POP, gp.gen_half_and_half(apset, ANT_ML, 1,
                                                           4),
                          FitnessSpec((1.0,)), device=dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pop, _, hof = algorithms.ea_simple(g, pop, tb, 0.5, 0.2, ANT_NGEN,
                                       halloffame_size=1, device=dev)
    torch.cuda.synchronize()
    return pop, hof, time.perf_counter() - t0


#: the ids of ``gp.ant.ant_pset``: 3 operators, 3 actions (``kIds`` in
#: csrc/ant_rollout.cu)
J2_IDS = 6


def _j2_arity(node):
    """csrc/ant_rollout.cu::arity_of: prog3 3, the other operators (every
    id below 3) 2, the rest 0."""
    return 3 if node == 2 else (2 if node < 3 else 0)


def walk_ends(row):
    """The subtree ends of one tree as J2's right-to-left pass makes them,
    the JAX evaluator's rule (``deap_tpu/gp/tree.py::subtree_end`` at
    every slot): ``(ends, complete)``. ``ends[i]`` is the exclusive end of
    slot ``i``'s subtree over the whole width, 1 where it does not close;
    the length plays no part, as in the JAX evaluator. ``complete`` says
    that the root's subtree closes and holds only the set's ids: J2 walks
    its table, which never leaves the ``ends[0]`` slots."""
    row = [int(v) for v in row]
    ends = [1] * len(row)
    stack = []
    for i in range(len(row) - 1, -1, -1):
        a = _j2_arity(row[i])
        if a == 0:
            e = i + 1
        elif len(stack) >= a:   # an unclosed child's end is 1: so is e
            e = stack[-a]
            del stack[-a:]
        else:                   # a child is missing: it never closes
            e = 1
            stack.clear()
        stack.append(e)
        ends[i] = e
    closed = ends[0] > 1 or _j2_arity(row[0]) == 0
    return ends, closed and all(0 <= v < J2_IDS for v in row[:ends[0]])


def ant_walk_table(nodes):
    """J2's successor table of each tree, ``int32[pop, L + 1, 2]``, in
    ``gp.ant.ant_rollout_traced``'s layout, built in Python.

    The stack walk of a complete tree (:func:`walk_ends`) is a program
    counter moving from one ``if_food_ahead`` or action to the next, each
    run of ``prog`` nodes on the way folded in with its steps: an action
    goes on at the next slot, where the start of an ``if``'s second child
    jumps to that ``if``'s end, again and again, and the root's end
    restarts at the root."""
    import numpy as np
    from deap_tpu_torch.gp.ant import IF_FOOD_AHEAD, PROG2, PROG3
    nodes = np.asarray(nodes)
    pop, L = nodes.shape
    table = np.zeros((pop, L + 1, 2), np.int64)
    for t in range(pop):
        row = [int(v) for v in nodes[t]]
        ends, complete = walk_ends(row)
        if not complete:
            continue
        n = ends[0]               # the root's slots
        first = [0] * (n + 1)     # the first slot from p on not a prog
        f = n
        for p in range(n - 1, -1, -1):
            f = f if row[p] in (PROG2, PROG3) else p
            first[p] = f

        def fold(p):
            return first[p] | (first[p] - p) << 8

        jump = [0] * (n + 1)      # an if's second child -> the if's end
        for i in range(n):
            if row[i] == IF_FOOD_AHEAD:
                jump[ends[i + 1]] = ends[i]
        after = [0] * (n + 1)     # where the walk goes once slot p - 1 ends
        after[n] = fold(0)
        for p in range(n - 1, 0, -1):
            after[p] = after[jump[p]] if jump[p] else fold(p)
        for s in range(n):
            if row[s] == IF_FOOD_AHEAD:
                table[t, s] = fold(s + 1), fold(ends[s + 1])
            elif row[s] >= 3:
                table[t, s] = after[s + 1] | (row[s] - 2) << 16, after[s + 1]
        table[t, L] = fold(0), 1
    return table.astype(np.int32)


def ant_walk_replay(row, trail, start, max_moves, max_steps, start_dir=1):
    """One ant's rollout in J2's order: ``(eaten, steps, iterations)``. A
    complete tree walks :func:`ant_walk_table`'s entries (each prog run's
    fold added with a clip at ``max_steps``, then one ``if`` or action),
    any other tree the stack over :func:`walk_ends`' ends, a step an
    iteration."""
    import numpy as np
    from deap_tpu_torch.gp.ant import (IF_FOOD_AHEAD, MOVE_FORWARD, PROG3,
                                       TURN_LEFT, TURN_RIGHT)
    dir_row, dir_col = (1, 0, -1, 0), (0, 1, 0, -1)
    row = [int(v) for v in row]
    L = len(row)
    R, C = trail.shape
    grid = np.array(trail, bool)
    r, c = start
    d = start_dir
    moves = eaten = steps = iters = 0

    def ahead():
        return (r + dir_row[d]) % R, (c + dir_col[d]) % C

    table = ant_walk_table(np.asarray(row, np.int64)[None])[0]
    if table[L, 1]:
        pair = int(table[L, 0])
        while moves < max_moves:
            steps += pair >> 8
            if steps >= max_steps:     # max_steps falls inside a prog run
                steps = max_steps
                break
            x, y = (int(v) for v in table[pair & 0xFF])
            kind = x >> 16
            ar, ac = ahead()
            food = bool(grid[ar, ac])
            pair = (x if food else y) & 0xFFFF
            moves += kind != 0
            d = (d + (0, 0, 3, 1)[kind]) % 4
            if kind == 1:
                r, c = ar, ac
                if food:
                    eaten += 1
                    grid[r, c] = False
            steps += 1
            iters += 1
        return eaten, steps, iters
    ends, _ = walk_ends(row)
    W = L + 3
    stack = [0] * W
    sp = 0
    while moves < max_moves and steps < max_steps:
        if sp == 0:
            stack[0] = 0
            sp = 1
        idx = stack[min(sp - 1, W - 1)]
        node = row[min(max(idx, 0), L - 1)]
        sp -= 1
        if node < 3:
            c1 = idx + 1
            c2 = ends[min(c1, L - 1)]
            if node == IF_FOOD_AHEAD:
                ar, ac = ahead()
                pushed = [c1 if grid[ar, ac] else c2]
            elif node == PROG3:
                pushed = [ends[min(c2, L - 1)], c2, c1]
            else:
                pushed = [c2, c1]
            for v in pushed:
                if sp < W:
                    stack[sp] = v
                sp += 1
        else:
            moves += 1
            action = node - 3
            if action == TURN_LEFT:
                d = (d + 3) % 4
            elif action == TURN_RIGHT:
                d = (d + 1) % 4
            elif action == MOVE_FORWARD:
                r, c = ahead()
                if grid[r, c]:
                    eaten += 1
                    grid[r, c] = False
        steps += 1
        iters += 1
    return eaten, steps, iters


def j2_check(torch, dev, trees, grid, words, start, max_steps, what,
             native_too=True):
    """J2 on ``trees`` at ``ANT_MOVES`` moves, in one launch, against its
    plain version on the card and a CPU run of it (eaten and steps) and,
    where ``native_too``, the native simulator's food; then its traced
    launch: its table against ``ant_walk_table``'s build and the
    iterations of the ``J2_REPLAY`` longest walks and first ants against
    ``ant_walk_replay``. Returns the counts the timing prints."""
    import numpy as np
    from deap_tpu_torch.gp import ant
    from deap_tpu_torch.native import ant_binding
    nodes = trees["nodes"].to(torch.int32).contiguous()
    length = trees["length"].to(torch.int32).contiguous()
    args = (nodes, length, grid, start, ANT_MOVES, max_steps, 1, words)
    before = ant.ant_rollout.launches
    eaten, steps = ant.ant_rollout(*args)
    if ant.ant_rollout.launches != before + 1:
        fail("ant_rollout did not launch once")
    traced = ant.ant_rollout_traced(*args)
    plain = ant.ant_rollout_plain(*args[:-1])
    torch.cuda.synchronize()
    host_nodes, host_length = nodes.cpu().numpy(), length.cpu().numpy()
    cpu = ant.ant_rollout_plain(nodes.cpu(), length.cpu(), grid.cpu(), start,
                                ANT_MOVES, max_steps)
    same = all(torch.equal(a, b) for a, b in (
        (eaten, plain[0]), (steps, plain[1]), (eaten, traced[0]),
        (steps, traced[1]), (eaten.cpu(), cpu[0]), (steps.cpu(), cpu[1])))
    native_ms = math.nan
    if native_too:
        t0 = time.perf_counter()
        native = ant_binding.ant_eval(host_nodes, host_length,
                                      grid.cpu().numpy(), start,
                                      max_moves=ANT_MOVES)
        native_ms = (time.perf_counter() - t0) * 1e3
        same &= np.array_equal(eaten.cpu().numpy(), native)
    if not same:
        fail(f"J2 differs from its plain version, a CPU run of it or the "
             f"native simulator on {what}")
    iters, table = traced[2].cpu(), traced[3].cpu()
    if not np.array_equal(table.numpy(), ant_walk_table(host_nodes)):
        fail(f"J2's table differs from ant_walk_table's on {what}")
    eaten, steps = eaten.cpu(), steps.cpu()
    if not bool((iters <= steps).all()):
        fail(f"J2 ran more iterations than steps on {what}")
    pick = set(torch.topk(iters, J2_REPLAY).indices.tolist())
    trail = grid.cpu().numpy()
    for i in sorted(pick | set(range(J2_REPLAY))):
        got = (int(eaten[i]), int(steps[i]), int(iters[i]))
        if ant_walk_replay(host_nodes[i], trail, start, ANT_MOVES,
                               max_steps) != got:
            fail(f"J2's iterations differ from the replay's on ant {i} of "
                 f"{what}")
    print(f"  J2 == plain on the card == a CPU run of it"
          f"{' == the native simulator' if native_too else ''} (eaten and "
          f"steps) on {what}: {nodes.shape[0]} trees of width "
          f"{nodes.shape[1]}, {ANT_MOVES} moves, eaten {int(eaten.min())}-"
          f"{int(eaten.max())}; table == ant_walk_table's "
          f"({int(table[:, -1, 1].sum())} complete trees); iterations == "
          f"the replay's on {len(pick | set(range(J2_REPLAY)))} ants")
    return dict(what=what, iters_max=int(iters.max()),
                iters_sum=int(iters.sum()), steps_min=int(steps.min()),
                steps_max=int(steps.max()), steps_sum=int(steps.sum()),
                native_ms=native_ms, complete=int(table[:, -1, 1].sum()))


def shared_load_clocks(torch, dev, loads=1 << 20, reps=5):
    """Clocks of one dependent shared-memory load: the fewest over ``reps``
    pointer chases of ``loads`` loads by one thread
    (``csrc/shared_chase.cu``)."""
    from deap_tpu_torch import _build
    clocks = torch.zeros(1, dtype=torch.int64, device=dev)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    fn = _build.function("shared_chase", "shared_chase",
                         [_build.INT] + [_build.PTR] * 3)
    stream = torch.cuda.current_stream(dev).cuda_stream
    best = math.inf
    for _ in range(reps):
        _build.check("shared_chase", fn(loads, clocks.data_ptr(),
                                        sink.data_ptr(), stream),
                     "shared_chase")
        best = min(best, int(clocks.item()) / loads)
    return best


def no_local_memory(src, kernel):
    """Fail unless ``ptxas`` gives ``kernel`` of ``csrc/<src>.cu`` a 0-byte
    stack frame and no spills."""
    import re
    from deap_tpu_torch import _build
    for name, line in ptxas_report(_build.build_log(src)):
        if name == kernel:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m is None or any(int(v) for v in m.groups()):
                fail(f"{kernel} keeps local memory: {line}")
            return
    fail(f"no ptxas report for {kernel}")


def ant_phase(torch, dev, tag, report, record, g, flush):
    """Phase 12b's ant: J2 against its plain version on the card, a CPU
    run of it and the native simulator on the smoke's trees, on trees it
    walks on the stack, at step bounds inside its folded prog runs and on
    Koza's solution; ``examples/gp/ant.py``'s program at full width (the
    main path, every count set to 0 just before it); J2 on the evolved
    population; J2 timed on both tree sets beside its chain floor."""
    import numpy as np
    from deap_tpu_torch import gp
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.gp import ant
    from deap_tpu_torch.native import ant_binding

    # ------------------------------------------------------- J2 checks --
    trail, start_cell = ant.parse_trail()
    grid = torch.as_tensor(trail, device=dev)
    words = ant.pack_trail(grid)
    apset = ant.ant_pset()
    max_steps = ANT_MOVES * ANT_ML + ANT_ML
    koza = gp.from_string(KOZA_SOLUTION, apset, ANT_ML, device=dev)
    trees = ant_trees(g)
    ant_binding.library()  # g++ builds it at first use: not timed
    smoke = j2_check(torch, dev, trees, grid, words, start_cell, max_steps,
                     "the smoke's trees (half crossover children)")
    # trees J2 walks on the stack: random ids, and the smoke's trees with
    # a prog3 at every slot from their last node on (a root that never
    # closes), at a step bound that such trees reach
    gen = make_generator(77, dev)
    half = ANT_POP // 2
    tail = (torch.arange(ANT_ML, device=dev)
            >= trees["length"][:, None] - 1)[:half]
    broken = {"nodes": torch.randint(0, 6, (ANT_POP, ANT_ML), generator=gen,
                                     device=dev, dtype=torch.int32),
              "length": trees["length"]}
    broken["nodes"][:half] = torch.where(tail, ant.PROG3,
                                         trees["nodes"][:half])
    incomplete = j2_check(torch, dev, broken, grid, words, start_cell,
                          J2_STACK_STEPS, "broken and random trees",
                          native_too=False)
    # the step bound inside the prog runs the walk folds
    for bound in J2_CUT_STEPS:
        e, s_ = ant.ant_rollout(trees["nodes"], trees["length"], grid,
                                start_cell, ANT_MOVES, bound, 1, words)
        pe, ps = ant.ant_rollout_plain(trees["nodes"], trees["length"], grid,
                                       start_cell, ANT_MOVES, bound)
        if not (torch.equal(e, pe) and torch.equal(s_, ps)):
            fail(f"J2 differs from its plain version at max_steps {bound}")
    ke, _ = ant.ant_rollout(koza["nodes"], koza["length"], grid, start_cell,
                            ANT_MOVES, max_steps, 1, words)
    kp, _ = ant.ant_rollout_plain(koza["nodes"], koza["length"], grid,
                                  start_cell, ANT_MOVES, max_steps)
    kn = ant_binding.ant_eval(koza["nodes"], koza["length"], trail,
                              start_cell, max_moves=ANT_MOVES)
    if not (ke.tolist() == kp.tolist() == kn.tolist() == [89]):
        fail(f"Koza's solution eats {ke.tolist()} (J2), {kp.tolist()} "
             f"(plain), {kn.tolist()} (native), not 89")
    stacked = ANT_POP - incomplete["complete"]
    print(f"{tag} J2 == plain on the card on the smoke's trees at max_steps "
          f"{', '.join(map(str, J2_CUT_STEPS))} (inside the folded prog "
          f"runs); on {ANT_POP} broken and random trees ({stacked} of them "
          f"on the stack walk, max_steps "
          f"{J2_STACK_STEPS}): == plain on the card == a CPU run, steps "
          f"{incomplete['steps_min']}-{incomplete['steps_max']}; Koza's "
          f"solution eats 89 on all three")
    print_ptxas("ant_rollout", "ant_rollout_kernel")
    no_local_memory("ant_rollout", "ant_rollout_kernel")
    load_clocks = shared_load_clocks(torch, dev)
    clock = max_sm_clock_hz()
    print(f"  J2: one dependent shared-memory load {load_clocks:.2f} clocks "
          f"(a pointer chase of one thread; max SM clock "
          f"{clock / 1e6:.0f} MHz)")

    # ----------------------------------- the ant program at full width --
    pop, hof, wall = ant_evolved(g, trail, start_cell)
    launches = ant.ant_rollout.launches
    native = ant_binding.ant_eval(pop.genomes["nodes"],
                                  pop.genomes["length"], trail, start_cell,
                                  max_moves=ANT_MOVES)
    if launches != ANT_NGEN + 1:
        fail(f"ant: J2 launched {launches} times for {ANT_NGEN + 1} "
             f"evaluations")
    if not (bool(pop.valid.all()) and np.array_equal(
            pop.fitness[:, 0].cpu().numpy(), native.astype(np.float32))):
        fail("ant: the population's fitness differs from the native "
             "simulator's")
    print(f"{tag} ant (examples/gp/ant.py) pop={ANT_POP} width={ANT_ML} "
          f"{ANT_MOVES} moves: {ANT_NGEN} generations in {wall:.3f} s incl. "
          f"gen-0 evaluation = {wall / ANT_NGEN * 1e3:.3f} ms/gen; most "
          f"food {float(pop.fitness.max())} (hall of fame "
          f"{float(hof.fitness[0, 0])}); J2 launches {launches} = the "
          f"evaluations; fitness == the native simulator's")
    evolved = j2_check(torch, dev, pop.genomes, grid, words, start_cell,
                       max_steps, f"the population after {ANT_NGEN} "
                       f"generations")

    # J2 timed on both sets, beside its plain version, its bound (the
    # steps' integer operations) and its chain floor (the longest ant's
    # iterations, each one dependent shared-memory load)
    times = {}
    for name, t in (("smoke", trees), ("evolved", pop.genomes)):
        args = (t["nodes"].to(torch.int32).contiguous(),
                t["length"].to(torch.int32).contiguous(), grid, start_cell,
                ANT_MOVES, max_steps, 1, words)
        ms = time_ms(lambda: ant.ant_rollout(*args), flush)
        plain_ms = time_ms(lambda: ant.ant_rollout_plain(*args[:-1]), flush,
                           reps=1)
        run = smoke if name == "smoke" else evolved
        floor_ms = run["iters_max"] * load_clocks / clock * 1e3
        times[name] = dict(ms=ms, plain_ms=plain_ms, floor_ms=floor_ms)
        print(f"{tag} J2 on {run['what']}: {ms * 1e3:.2f} us a launch; "
              f"plain {plain_ms * 1e3:.2f} us; the longest ant "
              f"{run['iters_max']} iterations ({run['steps_max']} steps), "
              f"chain floor {floor_ms * 1e3:.2f} us; iterations "
              f"{run['iters_sum']} = {run['iters_sum'] / run['steps_sum']:.3f}"
              f" of the steps; the native simulator {run['native_ms']:.2f} "
              f"ms on the host")
    # what J2 must move: the trees and lengths in, the trail's words in,
    # eaten and steps out
    nbytes = (trees["nodes"].numel() * 4 + ANT_POP * 4 + words.numel() * 4
              + 2 * ANT_POP * 4)
    record("j2", "ant_rollout", "deap_tpu_torch/csrc/ant_rollout.cu",
           "deap_tpu/gp/ant.py:117", 0.0, times["smoke"]["ms"],
           times["smoke"]["plain_ms"], nbytes,
           int_ops=smoke["steps_sum"] * J2_STEP_OPS)
    report["j2"].update(
        launches=launches, native_host_ms=smoke["native_ms"],
        chain_floor_ms=times["smoke"]["floor_ms"],
        shared_load_clocks=load_clocks,
        iterations_max=smoke["iters_max"], iterations_sum=smoke["iters_sum"],
        steps_max=smoke["steps_max"], steps_sum=smoke["steps_sum"],
        ms_evolved=times["evolved"]["ms"],
        plain_ms_evolved=times["evolved"]["plain_ms"],
        chain_floor_ms_evolved=times["evolved"]["floor_ms"],
        iterations_max_evolved=evolved["iters_max"],
        iterations_sum_evolved=evolved["iters_sum"],
        steps_max_evolved=evolved["steps_max"],
        steps_sum_evolved=evolved["steps_sum"],
        native_host_ms_evolved=evolved["native_ms"])
    del pop, hof, trees, broken


def gp_rest_phases(torch, dev, tag, report, record):
    """Phase 12b: the rest of GP. K9 with ``lt``/``eq`` (typed spambase) and
    ``lf`` (semantic offspring) live against its plain version; the typed
    spambase program at full width through K9; J2 against its plain
    version on the card, the native simulator and a CPU run of the plain
    version on generated, incomplete and evolved trees, and timed; the
    ant program at full width through J2; then ADF, HARM and semantic GP
    at the examples' sizes."""
    from deap_tpu_torch import FitnessSpec, Toolbox, algorithms, gp, ops
    from deap_tpu_torch.core.population import init_population
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.ops import kernels

    flush = torch.empty(2**27, dtype=torch.int32, device=dev)  # 512 MB
    k9 = kernels.gp_grouped_dispatch
    spec = FitnessSpec((1.0,))

    # ------------------------------------- K9 with lt, eq and lf live --
    def k9_vs_plain(what, pset, trees, X, need, timed=False):
        """K9 and its plain version, both on the card, over the whole value
        buffer of the deduped grouped schedule of ``trees`` (``timed``:
        both timed, into K9's line as ``typed``)."""
        n_args = pset.n_args
        interp = gp.make_batch_interpreter(pset, trees["nodes"].shape[1],
                                           mode="grouped")
        sched, _ = interp.schedule(trees)
        live = {pset.primitives[b].name for b in interp.mask}
        if not need <= live:
            fail(f"K9 on {what}: {sorted(need - live)} not live")
        args = [torch.from_numpy(sched[k]).to(dev) for k in
                ("chunk_ops", "src_idx", "src_const", "src_isc")]
        buf = torch.zeros((n_args + sched["nchunks"] * 128, X.shape[0]),
                          device=dev)
        buf[:n_args] = X.T
        bufs = [buf.clone(), buf]
        bufs[0][n_args:] = float("nan")
        del buf
        before = k9.launches
        got = k9(bufs[0], *args, interp.branches, chunk=128, n_args=n_args,
                 levels=sched["level_starts"])
        want = kernels.gp_grouped_dispatch_plain(
            bufs[1], *args, interp.branches, chunk=128, n_args=n_args)
        torch.cuda.synchronize()
        if k9.launches != before + 1 or not bitwise_equal(got, want):
            fail(f"gp_grouped_dispatch differs from its plain version on "
                 f"{what} (or launched {k9.launches - before} times)")
        err = max_abs_err(got.nan_to_num(), want.nan_to_num())
        print(f"{tag} gp_grouped_dispatch == plain bitwise on {what}, one "
              f"launch: {sched['n_instructions']} instructions of "
              f"{len(sched['root_idx'])} distinct trees, "
              f"{len(sched['level_starts']) - 1} levels, P {X.shape[0]}, "
              f"live {sorted(live)}")
        if timed:
            kw = dict(chunk=128, n_args=n_args)
            ms = time_ms(lambda: k9(bufs[0], *args, interp.branches,
                                    levels=sched["level_starts"], **kw),
                         flush)
            plain_ms = time_ms(lambda: kernels.gp_grouped_dispatch_plain(
                bufs[1], *args, interp.branches, **kw), flush, reps=3)
            nbytes = k9_bytes(sched, interp.branches, X.shape[0])
            bound_ms = nbytes / memory_rate(torch.cuda.get_device_name(0)) \
                * 1e3
            report["k9"]["typed"] = {"ms": ms, "plain_ms": plain_ms,
                                     "bound_ms": bound_ms}
            print(f"{tag} gp_grouped_dispatch on {what}: {ms * 1e3:.2f} us "
                  f"(bound {bound_ms * 1e3:.2f} us by bytes: "
                  f"{nbytes / 1e6:.2f} MB; plain {plain_ms * 1e3:.2f} us)")
        del bufs, got, want
        return err

    g = make_generator(51, dev)
    X = torch.rand((SPAM_ROWS, SPAM_FEATURES), generator=g, device=dev) * 100
    y = ((X[:, 0] > 40.0) | ((X[:, 1] > 60.0) & (X[:, 2] < 20.0))).to(
        torch.float32)
    spam = gp.spam_set(SPAM_FEATURES)
    pop = init_population(g, SPAM_POP,
                          gp.make_generator_typed(spam, SPAM_ML, 1, 4), spec,
                          device=dev)
    start = pop.genomes
    err = k9_vs_plain(f"typed spambase gen 0 (pop {SPAM_POP}, width "
                      f"{SPAM_ML})", spam, start, X, {"lt", "eq"},
                      timed=True)
    # ties for eq, and NaN and infinity among the operands
    Xi = torch.floor(X[:97, :] / 25)
    Xi[0, 0], Xi[1, 1], Xi[2, 2] = float("nan"), float("inf"), -0.0
    err = max(err, k9_vs_plain("typed spambase gen 0 on integer data with "
                               "NaN and inf (P 97)", spam, start, Xi,
                               {"lt", "eq"}))
    sem = gp.add_semantic_primitives(gp.math_set(1))
    parents = gp.gen_half_and_half(sem, SEM_ML, 1, 3)(g, 512)
    sem_expr = gp.make_generator(sem, 8, 0, 2, "full")
    kids = gp.make_mut_semantic(sem, sem_expr, SEM_ML)(g, parents)
    err = max(err, k9_vs_plain(
        "semantic mutants (pop 512, width 128, P 256)", sem, kids,
        (torch.rand((256, 1), generator=g, device=dev) - 0.5) * 80,
        {"lf"}))
    report["k9"]["max_abs_err"] = max(report["k9"]["max_abs_err"], err)

    # --------------------------------- typed spambase at full width --
    interp = gp.make_batch_interpreter(spam, SPAM_ML, mode="grouped")
    tb = Toolbox()
    tb.register("evaluate",
                lambda gs: (interp(gs, X) == y).to(torch.float32).mean(-1))
    tb.register("mate", gp.make_cx_one_point_typed(spam))
    tb.register("mutate", gp.make_mut_node_replacement_typed(spam))
    tb.register("select", ops.sel_tournament, tournsize=3)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pop, logbook, hof = algorithms.ea_simple(g, pop, tb, 0.5, 0.2,
                                             SPAM_NGEN, halloffame_size=1,
                                             device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k9.launches
    report["k9"]["typed_launches"] = launches
    if launches != SPAM_NGEN + 1:
        fail(f"typed spambase: K9 launched {launches} times for "
             f"{SPAM_NGEN + 1} evaluations")
    scan = gp.make_batch_interpreter(spam, SPAM_ML, mode="scan")
    want = (scan(pop.genomes, X) == y).to(torch.float32).mean(-1)
    if not (bool(pop.valid.all()) and torch.equal(pop.fitness[:, 0], want)):
        fail("typed spambase: the population's accuracy differs from the "
             "scan interpreter's")
    best = float(hof.fitness[0, 0])
    print(f"{tag} typed spambase (spam_set({SPAM_FEATURES}), {SPAM_ROWS} "
          f"rows) pop={SPAM_POP} width={SPAM_ML}: {SPAM_NGEN} generations "
          f"in {wall:.3f} s incl. gen-0 evaluation = "
          f"{wall / SPAM_NGEN * 1e3:.3f} ms/gen; best accuracy "
          f"{float(pop.fitness.max()):.4f} (hall of fame {best:.4f}); K9 "
          f"launches {launches} = the evaluations; accuracy == the scan "
          f"interpreter's")
    best_tree = {k: v[0] for k, v in hof.genomes.items()}
    print(f"  best tree: {gp.to_string(best_tree, spam)}")
    del start, pop, hof, interp, scan, X, Xi, y

    ant_phase(torch, dev, tag, report, record, g, flush)

    # --------------------------------------- the examples' small runs --
    adf_phase(torch, dev, tag, g)
    harm_phase(torch, dev, tag, g)
    semantic_phase(torch, dev, tag, g)
    del flush


def same_values(a, b):
    """Bitwise equal where finite or infinite, NaN in the same places."""
    import torch
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) and bitwise_equal(
        torch.where(nan, 0.0, a), torch.where(nan, 0.0, b))


def adf_phase(torch, dev, tag, g):
    """examples/gp/adf_symbreg.py at its size (pop 200) for ADF_NGEN
    generations: rows of the batch interpreter equal the one-individual
    interpreter's, the best MSE finite."""
    from deap_tpu_torch import FitnessSpec, Toolbox, algorithms, gp, ops
    from deap_tpu_torch.core.population import init_population
    branches = adf_branches(gp)
    X = (torch.arange(20, dtype=torch.float32, device=dev) * 0.1 - 1.0)[:,
                                                                       None]
    y = X[:, 0] ** 4 + X[:, 0] ** 3 + X[:, 0] ** 2 + X[:, 0]
    interp = gp.make_adf_batch_interpreter(branches)
    tb = Toolbox()
    tb.register("evaluate",
                lambda gs: -((interp(gs, X) - y) ** 2).mean(-1))
    tb.register("mate", gp.branch_wise_cx(
        [gp.make_cx_one_point(ps) for ps, _ in branches]))
    tb.register("mutate", gp.branch_wise_mut(
        [gp.make_mut_uniform(ps, gp.make_generator(ps, 16, 0, 2, "full"))
         for ps, _ in branches]))
    tb.register("select", ops.sel_tournament, tournsize=3)
    pop = init_population(g, ADF_POP, gp.make_adf_generator(branches, 1, 2),
                          FitnessSpec((1.0,)), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pop, logbook, _ = algorithms.ea_simple(g, pop, tb, 0.5, 0.2, ADF_NGEN,
                                           device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    one = gp.make_adf_interpreter(branches)
    preds = interp(pop.genomes, X)
    for r in (0, ADF_POP // 2, ADF_POP - 1):
        ind = tuple({k: v[r] for k, v in b.items()} for b in pop.genomes)
        if not same_values(one(ind, X), preds[r]):
            fail("ADF: a row's values differ from the one-individual "
                 "interpreter's")
    best = -float(pop.fitness.max())
    if not math.isfinite(best) or len(logbook) != ADF_NGEN + 1:
        fail(f"ADF run: best MSE {best}, {len(logbook)} records")
    print(f"{tag} ADF symbolic regression (adf_symbreg.py) pop={ADF_POP}: "
          f"{ADF_NGEN} generations in {wall:.3f} s = "
          f"{wall / ADF_NGEN * 1e3:.3f} ms/gen; best MSE {best:.6f}; rows "
          f"== the one-individual interpreter")


def adf_branches(gp):
    """examples/gp/adf_symbreg.py's branches: MAIN calls ADF0-ADF2, ADF0
    calls ADF1 and ADF2, ADF1 calls ADF2."""
    adf2 = gp.math_set(n_args=2, trig=False, erc=False, name="ADF2")
    adf1 = gp.math_set(n_args=2, trig=False, erc=False, name="ADF1")
    adf1.add_adf("ADF2", 2, branch=3)
    adf0 = gp.math_set(n_args=2, trig=False, erc=False, name="ADF0")
    adf0.add_adf("ADF1", 2, branch=2)
    adf0.add_adf("ADF2", 2, branch=3)
    main = gp.math_set(n_args=1, trig=True, erc=True, name="MAIN")
    main.add_adf("ADF0", 2, branch=1)
    main.add_adf("ADF1", 2, branch=2)
    main.add_adf("ADF2", 2, branch=3)
    return [(main, 48), (adf0, 24), (adf1, 24), (adf2, 24)]


def harm_phase(torch, dev, tag, g):
    """examples/gp/symbreg_harm.py at its size (pop 300, 600 trial
    children) for HARM_NGEN generations, evaluated through K9: one launch
    an evaluation, the sizes within the width."""
    from deap_tpu_torch import FitnessSpec, Toolbox, gp, ops
    from deap_tpu_torch.core.population import init_population
    from deap_tpu_torch.ops import kernels
    from deap_tpu_torch.support.stats import Statistics
    pset = gp.math_set(1)
    X = (torch.arange(20, dtype=torch.float32, device=dev) * 0.1 - 1.0)[:,
                                                                       None]
    y = X[:, 0] ** 4 + X[:, 0] ** 3 + X[:, 0] ** 2 + X[:, 0]
    interp = gp.make_batch_interpreter(pset, 64, mode="grouped")
    tb = Toolbox()
    tb.register("evaluate", lambda gs: -((interp(gs, X) - y) ** 2).mean(-1))
    tb.register("mate", gp.make_cx_one_point(pset))
    tb.register("mutate", gp.make_mut_uniform(
        pset, gp.make_generator(pset, 32, 0, 2, "full")))
    tb.register("select", ops.sel_tournament, tournsize=3)
    sizes = Statistics(lambda p: p.genomes["length"].to(torch.float32))
    sizes.register("avg", torch.mean)
    sizes.register("max", torch.max)
    pop = init_population(g, HARM_POP, gp.gen_half_and_half(pset, 64, 1, 2),
                          FitnessSpec((1.0,)), device=dev)
    before = kernels.gp_grouped_dispatch.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pop, logbook, _ = gp.harm(g, pop, tb, 0.5, 0.1, HARM_NGEN,
                              nbrindsmodel=HARM_NBR, stats=sizes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.gp_grouped_dispatch.launches - before
    avg = [float(r["avg"]) for r in logbook]
    if launches != HARM_NGEN + 1 or not bool(pop.valid.all()) or \
            max(avg) >= 64:
        fail(f"HARM: K9 launched {launches} times for {HARM_NGEN + 1} "
             f"evaluations, mean sizes {avg}")
    print(f"{tag} HARM symbolic regression (symbreg_harm.py) pop={HARM_POP}, "
          f"{HARM_NBR} trial children: {HARM_NGEN} generations in "
          f"{wall:.3f} s = {wall / HARM_NGEN * 1e3:.3f} ms/gen; best MSE "
          f"{-float(pop.fitness.max()):.6f}; mean size "
          f"{' -> '.join(f'{a:.1f}' for a in avg)}; K9 launches {launches}")


def semantic_phase(torch, dev, tag, g):
    """The semantic operators on math_set(1) plus lf (pop 256, programs up
    to 128 nodes) for SEM_NGEN generations of ea_simple, evaluated
    through K9 (lf live): one launch an evaluation, the fitness equal to
    the scan interpreter's."""
    from deap_tpu_torch import FitnessSpec, Toolbox, algorithms, gp, ops
    from deap_tpu_torch.core.population import init_population
    from deap_tpu_torch.ops import kernels
    pset = gp.add_semantic_primitives(gp.math_set(1))
    X = (torch.arange(20, dtype=torch.float32, device=dev) * 0.1 - 1.0)[:,
                                                                       None]
    y = X[:, 0] ** 4 + X[:, 0] ** 3 + X[:, 0] ** 2 + X[:, 0]
    interp = gp.make_batch_interpreter(pset, SEM_ML, mode="grouped")
    expr = gp.make_generator(pset, 8, 0, 2, "full")
    tb = Toolbox()
    tb.register("evaluate", lambda gs: -((interp(gs, X) - y) ** 2).mean(-1))
    tb.register("mate", gp.make_cx_semantic(pset, expr, SEM_ML))
    tb.register("mutate", gp.make_mut_semantic(pset, expr, SEM_ML))
    tb.register("select", ops.sel_tournament, tournsize=3)
    pop = init_population(g, SEM_POP, gp.gen_half_and_half(pset, SEM_ML, 1,
                                                           2),
                          FitnessSpec((1.0,)), device=dev)
    before = kernels.gp_grouped_dispatch.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pop, logbook, _ = algorithms.ea_simple(g, pop, tb, 0.5, 0.2, SEM_NGEN,
                                           device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.gp_grouped_dispatch.launches - before
    scan = gp.make_batch_interpreter(pset, SEM_ML, mode="scan")
    want = -((scan(pop.genomes, X) - y) ** 2).mean(-1)
    live = {pset.primitives[b].name for b in interp.mask}
    if launches != SEM_NGEN + 1 or "lf" not in live or not same_values(
            pop.fitness[:, 0], want):
        fail(f"semantic GP: K9 launched {launches} times for "
             f"{SEM_NGEN + 1} evaluations, live {sorted(live)}, or the "
             f"fitness differs from the scan interpreter's")
    print(f"{tag} semantic GP (math_set(1) + lf) pop={SEM_POP} width "
          f"{SEM_ML}: {SEM_NGEN} generations in {wall:.3f} s = "
          f"{wall / SEM_NGEN * 1e3:.3f} ms/gen; best MSE "
          f"{-float(pop.fitness.max()):.6f}; mean size "
          f"{float(pop.genomes['length'].float().mean()):.1f}; K9 launches "
          f"{launches}; fitness == the scan interpreter's (bitwise, NaN "
          f"where it is NaN)")


def symbreg_data(dev):
    """bench_gp.py's data: the quartic x^4 + x^3 + x^2 + x at the 256
    points of ``linspace(-1, 1, 256, endpoint=False)`` (exact in
    float32)."""
    import torch
    x = (torch.arange(GP_P, dtype=torch.float32, device=dev) * (2.0 / GP_P)
         - 1.0)
    return x[:, None], x ** 4 + x ** 3 + x ** 2 + x


def symbreg_start(dev, seed, pop):
    """A generator, ``gen_half_and_half(1, 2)`` trees of width 64 under
    ``math_set(1)`` and ``bench_gp.py``'s symbreg loop (grouped mode with
    dedup, K9 on the card)."""
    from deap_tpu_torch import gp
    from deap_tpu_torch.device import make_generator
    pset = gp.math_set(1)
    X, y = symbreg_data(dev)
    g = make_generator(seed, dev)
    start = gp.gen_half_and_half(pset, GP_ML, 1, 2)(g, pop)
    run = gp.make_symbreg_loop(pset, GP_ML, X, y, cxpb=GP_CXPB,
                               mutpb=GP_MUTPB, device=dev)
    return g, start, run


def nsga2_generation(g, x, w, nd="standard", inputs=None):
    """bench.py's NSGA-II generation (make_run_nsga2_3obj) on DTLZ2: DCD
    mating selection, Gaussian variation clipped to [0, 1], evaluation,
    ``sel_nsga2`` over the union. ``inputs`` collects each selection's
    weighted values. Returns the survivors' genomes and weighted values."""
    import torch
    from deap_tpu_torch import benchmarks as bm
    from deap_tpu_torch import mo
    if inputs is not None:
        inputs.append(("dcd", w))
    parents = x[mo.sel_tournament_dcd(g, w, x.shape[0])]
    noise = torch.randn(parents.shape, generator=g, device=x.device)
    off = torch.clamp(parents + 0.02 * noise, 0.0, 1.0)
    xall = torch.cat([x, off])
    wall = torch.cat([w, -bm.dtlz2(off, w.shape[1])])
    if inputs is not None:
        inputs.append(("nsga2", wall))
    keep = mo.sel_nsga2(None, wall, x.shape[0], nd=nd)
    return xall[keep], wall[keep]


def nsga3_generation(g, x, w, ref_points, inputs=None, fills=None):
    """:func:`nsga2_generation` with ``sel_nsga3`` as the environmental
    selection (its plan, draws and niching, so ``fills`` can collect each
    selection's ``(n_fill, partial front)``). Returns the survivors'
    genomes and weighted values."""
    import torch
    from deap_tpu_torch import benchmarks as bm
    from deap_tpu_torch import mo
    from deap_tpu_torch.mo import emo
    if inputs is not None:
        inputs.append(("dcd", w))
    parents = x[mo.sel_tournament_dcd(g, w, x.shape[0])]
    noise = torch.randn(parents.shape, generator=g, device=x.device)
    off = torch.clamp(parents + 0.02 * noise, 0.0, 1.0)
    xall = torch.cat([x, off])
    wall = torch.cat([w, -bm.dtlz2(off, w.shape[1])])
    if inputs is not None:
        inputs.append(("nsga3", wall))
    plan = emo.nsga3_plan(wall, x.shape[0], ref_points)
    if fills is not None:
        fills.append((plan.n_fill, int(plan.partial_idx.shape[0])))
    keep = emo.nsga3_select_scaled(plan, x.shape[0],
                                   emo.nsga3_draws(g, plan))
    return xall[keep], wall[keep]


def two_peaks(x):
    """The JAX package's static two-peak landscape (its multi-swarm
    tests): maxima 10 at -3·1 and 8 at +3·1."""
    import torch
    from deap_tpu_torch.ops.linalg import norm_rn
    return torch.maximum(10.0 - norm_rn(x + 3.0), 8.0 - norm_rn(x - 3.0))


def nsga3_zdt1_run(g, dev, ngen=None):
    """The JAX package's NSGA-III ZDT1 gate (tests/test_mo.py): µ 16, 5
    genes, DCD mating selection, bounded SBX (η 20, cxpb 0.9) and
    polynomial mutation (η 20, indpb 1/5, mutpb 1), ``sel_nsga3`` over the
    union with ``uniform_reference_points(2, 12)``. Returns the final
    population."""
    from deap_tpu_torch import Toolbox, algorithms, benchmarks, mo, ops
    from deap_tpu_torch.core.fitness import FitnessSpec
    from deap_tpu_torch.core.population import (concat, gather,
                                                init_population)
    tb = Toolbox()
    tb.register("evaluate", benchmarks.zdt1)
    tb.register("mate", ops.cx_simulated_binary_bounded, eta=20.0, low=0.0,
                up=1.0)
    tb.register("mutate", ops.mut_polynomial_bounded, eta=20.0, low=0.0,
                up=1.0, indpb=1.0 / N3_DIM)
    ref = mo.uniform_reference_points(2, N3_P).to(dev)
    pop = init_population(g, N3_MU, ops.uniform_genome(N3_DIM),
                          FitnessSpec((-1.0, -1.0)), device=dev)
    pop = algorithms.evaluate_invalid(pop, tb.evaluate)
    for _ in range(N3_NGEN if ngen is None else ngen):
        idx = mo.sel_tournament_dcd(g, pop.wvalues, N3_MU)
        off = algorithms.var_and(g, gather(pop, idx), tb, cxpb=0.9,
                                 mutpb=1.0)
        off = algorithms.evaluate_invalid(off, tb.evaluate)
        pool = concat([pop, off])
        pop = gather(pool, mo.sel_nsga3(g, pool.wvalues, N3_MU, ref))
    return pop


def _mp_config(scenario, dim):
    """A moving-peaks configuration as the examples build it: the
    scenario without its peak and basis functions (``function1``, no
    basis)."""
    from deap_tpu_torch.benchmarks import movingpeaks as mp
    return mp.MovingPeaksConfig(dim=dim, **{
        k: v for k, v in getattr(mp, scenario).items()
        if k not in ("pfunc", "bfunc")})


def multiswarm_example(dev, epochs=4, gens=30):
    """``examples/pso/multiswarm.py``: SCENARIO_2 at dim 5, 4 swarms of 5
    in 12 slots, rcloud 0.5 · move severity, ``epochs`` of ``gens`` steps
    with a change of the landscape after each. Returns ``(best,
    steps, detail)``."""
    from deap_tpu_torch.benchmarks import movingpeaks as mp
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.strategies import MultiSwarmPSO
    cfg = _mp_config("SCENARIO_2", 5)
    land = {"s": mp.mp_init(make_generator(68, dev), cfg)}
    ms = MultiSwarmPSO(lambda x: mp.mp_evaluate(cfg, land["s"], x)[1][:, 0],
                       pmin=cfg.min_coord, pmax=cfg.max_coord,
                       rcloud=0.5 * cfg.move_severity, device=dev)
    g = make_generator(69, dev)
    s = ms.init(g, nswarms=4, nparticles=5, dim=5, capacity=12)
    bests = []
    for _ in range(epochs):
        for _ in range(gens):
            s = ms.step(g, s)
        bests.append((float(ms.best(s)[1]),
                      float(mp.global_maximum(cfg, land["s"]))))
        land["s"] = mp.change_peaks(cfg, land["s"])
    return bests[-1][0], epochs * gens, (
        "best / optimum per epoch " + ", ".join(
            f"{b:.2f}/{o:.2f}" for b, o in bests)
        + f"; {int(s.active.sum())} swarms")


def speciation_example(dev, steps=60):
    """``examples/pso/speciation.py``: SCENARIO_1 at dim 5, n 100, rs =
    100 / 50^(1/5), species capped at 10, ``steps`` steps."""
    from deap_tpu_torch.benchmarks import movingpeaks as mp
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.strategies import SpeciationPSO, species_seeds
    cfg = _mp_config("SCENARIO_1", 5)
    state = mp.mp_init(make_generator(71, dev), cfg)
    rs = (cfg.max_coord - cfg.min_coord) / (50 ** (1.0 / 5))
    sp = SpeciationPSO(lambda x: mp.mp_evaluate(cfg, state, x)[1][:, 0],
                       pmin=cfg.min_coord, pmax=cfg.max_coord, rs=rs,
                       pmax_size=10, rcloud=1.0, device=dev)
    g = make_generator(72, dev)
    s = sp.init(g, n=100, dim=5)
    for _ in range(steps):
        s = sp.step(g, s)
    best = float(sp.best(s)[1])
    seeds, _ = species_seeds(s.pbest_x, s.pbest_f, rs)
    return best, steps, (f"best {best:.2f} (optimum "
                         f"{float(mp.global_maximum(cfg, state)):.2f}); "
                         f"{int(seeds.sum())} species")


def de_dynamic_example(dev, epochs=6, gens=20):
    """``examples/de/dynamic.py``: DE (F 0.5, CR 0.9, maximising) on
    SCENARIO_1 at dim 2, n 100, ``epochs`` of ``gens`` generations, the
    population re-evaluated after each change."""
    from deap_tpu_torch import ops
    from deap_tpu_torch.benchmarks import movingpeaks as mp
    from deap_tpu_torch.core.fitness import FitnessSpec
    from deap_tpu_torch.core.population import init_population
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.strategies import DifferentialEvolution
    cfg = _mp_config("SCENARIO_1", 2)
    state = mp.mp_init(make_generator(61, dev), cfg)
    pop = init_population(make_generator(62, dev), 100, ops.uniform_genome(
        2, cfg.min_coord, cfg.max_coord), FitnessSpec((1.0,)), device=dev)
    g = make_generator(63, dev)
    bests = []
    for _ in range(epochs):
        de = DifferentialEvolution(
            lambda x, st=state: mp.mp_evaluate(cfg, st, x)[1][:, 0], F=0.5,
            CR=0.9, spec=FitnessSpec((1.0,)))
        pop, _ = de.run(g, pop, gens)
        bests.append((float(pop.wvalues.max()),
                      float(mp.global_maximum(cfg, state))))
        state = mp.change_peaks(cfg, state)
        pop = pop.invalidate(pop.valid)
    return bests[-1][0], epochs * gens, "best / optimum per epoch " + \
        ", ".join(f"{b:.2f}/{o:.2f}" for b, o in bests)


def nsga3_example(dev, ngen=100):
    """``examples/ga/nsga3.py``: DTLZ2, 3 objectives, p 12 (91 reference
    points), µ 92, 7 genes, tournament 2, bounded SBX (η 30) and
    polynomial mutation (η 20, indpb 1/7), cxpb = mutpb = 1, ``sel_nsga3``
    over the union, ``ngen`` generations."""
    from deap_tpu_torch import Toolbox, algorithms, benchmarks, mo, ops
    from deap_tpu_torch.core.fitness import FitnessSpec
    from deap_tpu_torch.core.population import (concat, gather,
                                                init_population)
    from deap_tpu_torch.device import make_generator
    nobj, p, ndim = 3, 12, 7
    ref = mo.uniform_reference_points(nobj, p).to(dev)
    mu = int(ref.shape[0] + (4 - ref.shape[0] % 4) % 4)
    tb = Toolbox()
    tb.register("evaluate", lambda x: benchmarks.dtlz2(x, nobj))
    tb.register("mate", ops.cx_simulated_binary_bounded, eta=30.0, low=0.0,
                up=1.0)
    tb.register("mutate", ops.mut_polynomial_bounded, eta=20.0, low=0.0,
                up=1.0, indpb=1.0 / ndim)
    tb.register("select", ops.sel_tournament, tournsize=2)
    pop = init_population(make_generator(21, dev), mu, ops.uniform_genome(
        ndim, 0.0, 1.0), FitnessSpec((-1.0,) * nobj), device=dev)
    pop = algorithms.evaluate_invalid(pop, tb.evaluate)
    g = make_generator(22, dev)
    for _ in range(ngen):
        idx = tb.select(g, pop.wvalues, pop.size)
        off = algorithms.var_and(g, gather(pop, idx), tb, cxpb=1.0,
                                 mutpb=1.0)
        off = algorithms.evaluate_invalid(off, tb.evaluate)
        pool = concat([pop, off])
        pop = gather(pool, mo.sel_nsga3(g, pool.wvalues, mu, ref))
    spread = float(pop.fitness.max(0).values.min())
    dist = float((pop.fitness.norm(dim=1) - 1.0).mean())
    return spread, ngen, (f"population {pop.size}, objective spread "
                          f"{spread:.3f}, mean ||f|| - 1 {dist:.4f}")


def fused_onemax_generation(g, genomes, fit, variation=None, prng="input"):
    """``bench.py``'s ``make_run_fused`` step: tournament 3 on the fitness,
    the gather of the parents' rows, then K2 (or ``variation``, its plain
    version) with bits drawn from ``g`` (``prng='input'``) or made in the
    kernel from a key drawn from ``g`` (``'hw'``, and ``'auto'`` on the
    card; ``bench.py`` passes ``prng="hw"``). Returns the children and
    their fitness."""
    from deap_tpu_torch.ops import kernels
    from deap_tpu_torch.ops.selection import sel_tournament
    variation = variation or kernels.fused_variation_eval
    n, length = genomes.shape
    idx = sel_tournament(g, fit[:, None], n, TOURNSIZE)
    probs = dict(cxpb=CXPB, mutpb=MUTPB, indpb=INDPB)
    if prng == "input":
        return variation(genomes[idx], *kernels.fused_bits(g, n, length),
                         **probs)
    return variation(genomes[idx], prng=prng, generator=g, **probs)


def rastrigin_fused_generation(g, genomes, fit, variation=None,
                               prng="input"):
    """``bench_suite.py``'s fused Rastrigin step: the rank-based tournament
    3 on the (minimised) fitness, the gather of the parents' rows, then K6
    (or ``variation``, its plain version) with blend and Gaussian
    variation and Rastrigin evaluated in the kernel, its bits drawn from
    ``g`` (``prng='input'``) or made in the kernel from a key drawn from
    ``g`` (``'hw'``, and ``'auto'`` on the card; ``bench_suite.py`` passes
    ``prng="hw"``). Returns the children and their fitness."""
    from deap_tpu_torch.ops import kernels_real
    from deap_tpu_torch.ops.selection import sel_tournament_sorted
    variation = variation or kernels_real.fused_variation_eval_real
    n, length = genomes.shape
    idx = sel_tournament_sorted(g, -fit[:, None], n, TOURNSIZE)
    kw = dict(cxpb=RA_CXPB, mutpb=RA_MUTPB, indpb=RA_INDPB, alpha=RA_ALPHA,
              sigma=RA_SIGMA, evaluate="rastrigin")
    if prng == "input":
        return variation(genomes[idx], *kernels_real.real_bits(g, n, length),
                         **kw)
    return variation(genomes[idx], prng=prng, generator=g, **kw)


def rastrigin_toolbox():
    """``bench_suite.py``'s unfused Rastrigin toolbox: ``cx_blend``,
    ``mut_gaussian``, ``sel_tournament`` and Rastrigin (minimised). The
    blend has no segment draw, so ``var_and`` takes its unfused path."""
    from deap_tpu_torch import Toolbox, benchmarks, ops
    tb = Toolbox()
    tb.register("evaluate", benchmarks.rastrigin)
    tb.register("mate", ops.cx_blend, alpha=RA_ALPHA)
    tb.register("mutate", ops.mut_gaussian, mu=0.0, sigma=RA_SIGMA,
                indpb=RA_INDPB)
    tb.register("select", ops.sel_tournament, tournsize=TOURNSIZE)
    return tb


def fctmin_init(generator, n):
    """``examples/es/fctmin.py``'s individuals: values uniform in [-3, 3]
    and strategies uniform in [0.5, 3], ``FCT_DIM`` genes each."""
    from deap_tpu_torch import ops
    return {"x": ops.uniform_genome(FCT_DIM, -3.0, 3.0)(generator, n),
            "strategy": ops.uniform_genome(FCT_DIM, 0.5, 3.0)(generator, n)}


def fctmin_toolbox():
    """``examples/es/fctmin.py``'s (μ, λ) ES toolbox: ``cx_es_blend``
    (α 0.1), ``mut_es_log_normal`` (c 1, indpb 0.03) with the strategies
    floored at 0.5, tournament 3, sphere (minimised)."""
    from deap_tpu_torch import Toolbox, benchmarks, ops
    mut = ops.strategy_floor(FCT_MIN_STRATEGY)(ops.mut_es_log_normal)

    def mate(g, a, b):
        (c1x, c1s), (c2x, c2s) = ops.cx_es_blend(
            g, a["x"], a["strategy"], b["x"], b["strategy"], alpha=0.1)
        return {"x": c1x, "strategy": c1s}, {"x": c2x, "strategy": c2s}

    def mutate(g, a):
        x, s = mut(g, a["x"], a["strategy"], c=1.0, indpb=0.03)
        return {"x": x, "strategy": s}

    tb = Toolbox()
    tb.register("evaluate", lambda g: benchmarks.sphere(g["x"])[:, 0])
    tb.register("mate", mate)
    tb.register("mutate", mutate)
    tb.register("select", ops.sel_tournament, tournsize=3)
    return tb


def kursawe_toolbox():
    """``examples/ga/kursawefct.py``'s (μ + λ) NSGA-II toolbox:
    ``cx_blend`` (α 1.5), ``mut_gaussian`` (σ 3, indpb 0.3), ``sel_nsga2``
    on Kursawe (both objectives minimised)."""
    from deap_tpu_torch import Toolbox, benchmarks, mo, ops
    tb = Toolbox()
    tb.register("evaluate", benchmarks.kursawe)
    tb.register("mate", ops.cx_blend, alpha=1.5)
    tb.register("mutate", ops.mut_gaussian, mu=0.0, sigma=3.0, indpb=0.3)
    tb.register("select", mo.sel_nsga2)
    return tb


def same_tree(torch, a, b):
    """Bitwise equality of two result trees: tensors by their bytes,
    generators by their states, a logbook by its rows, anything else by
    ``==``."""
    from deap_tpu_torch.support.checkpoint import tree_flatten
    la, sa = tree_flatten(a)
    lb, sb = tree_flatten(b)
    if sa != sb or len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and x.shape == y.shape):
                return False
            bx = x.contiguous().reshape(-1).view(torch.uint8)
            by = y.to(x.device).contiguous().reshape(-1).view(torch.uint8)
            if not torch.equal(bx, by):
                return False
        elif isinstance(x, torch.Generator):
            if not torch.equal(x.get_state(), y.get_state()):
                return False
        elif isinstance(x, list):  # a Logbook: rows of host scalars
            if list(x) != list(y):
                return False
        elif x != y:
            return False
    return True


def onemax_resilient(dev, seed, n, ngen, res):
    """Phase 3's ``onemax_run`` (``fused='auto'``) through the
    ResilientRun ``res``: ``((pop, logbook, hof), generator)``."""
    from deap_tpu_torch import FitnessSpec, Toolbox, ops
    from deap_tpu_torch.core.population import init_population
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.support.stats import fitness_stats
    g = make_generator(seed, dev)
    pop = init_population(g, n, ops.bernoulli_genome(L), FitnessSpec((1.0,)),
                          device=dev)
    out = res.ea_simple(g, pop, _onemax_toolbox(Toolbox, ops), CXPB, MUTPB,
                        ngen, stats=fitness_stats(), halloffame_size=1,
                        device=dev)
    return out, g


def resilience_child(argv):
    """``chip_smoke.py --resilience-child DIR MODE SPAWN_WALL``: phase 19's
    child process. It journals to ``DIR/MODE.jsonl`` (every row fsync'd)
    and runs ``onemax_resilient`` at pop 100k in segments of 5 over
    ``DIR/ck``. ``kill``: synchronous saves, and the process waits at the
    ``saved`` event of generation 10 for the parent's SIGKILL. ``resume``:
    the default double-buffered run, which resumes from the newest valid
    file; its result, its K1 launches and the seconds from ``SPAWN_WALL``
    (the parent's clock when it started this process) to its first
    resumed segment go to ``DIR/result.pkl``."""
    import torch
    sys.path.insert(0, ROOT)
    from deap_tpu_torch.ops import kernels
    from deap_tpu_torch.resilience import Fault, FaultPlan, ResilientRun
    from deap_tpu_torch.support import save_state
    from deap_tpu_torch.telemetry import RunJournal, read_journal
    d, mode, spawn = argv[0], argv[1], float(argv[2])
    journal = RunJournal(os.path.join(d, f"{mode}.jsonl"), fsync_every=1)
    journal.header(init_backend=False, mode=mode)

    class HoldForKill(Fault):
        def fire(self, event, **ctx):
            if event == "saved" and ctx["hi"] >= RS_KILL_AT:
                time.sleep(600)

    plan = FaultPlan([HoldForKill()]) if mode == "kill" else None
    res = ResilientRun(os.path.join(d, "ck"), segment_len=RS_SEG,
                       fault_plan=plan)
    reset_counts()
    (pop, logbook, hof), g = onemax_resilient(torch.device("cuda"), 0, N,
                                              RS_NGEN, res)
    torch.cuda.synchronize()
    launches = kernels.fused_variation.launches
    journal.close()
    rows = read_journal(journal.path)
    at = {r["kind"]: r["t"] for r in reversed(rows)}
    save_state(os.path.join(d, "result.pkl"), {
        "pop": pop, "logbook": list(logbook), "hof": hof, "generator": g,
        "launches": launches,
        "to_resumed_s": journal.wall_start + at["resumed"] - spawn,
        "to_first_segment_s": journal.wall_start + at["segment"] - spawn})
    return 0


def resilience_phases(torch, dev, tag, onemax_run):
    """Phase 19: segmented, killed, corrupted and preempted runs through
    ``ResilientRun``, each bitwise against the uninterrupted run, with the
    card's first resilience figures. ``onemax_run(seed, n, ngen, fused)``
    is phase 3's."""
    import shutil
    import signal
    import subprocess
    from deap_tpu_torch import Toolbox, algorithms, benchmarks
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.ops import kernels, linalg
    from deap_tpu_torch.resilience import (FaultPlan, PreemptAt, Preempted,
                                           ResilientRun, corrupt_file)
    from deap_tpu_torch.strategies import cma
    from deap_tpu_torch.support import (AsyncCheckpointWriter, Checkpointer,
                                        restore_state)
    from deap_tpu_torch.support.stats import fitness_stats
    from deap_tpu_torch.telemetry import read_journal

    root = os.path.join(ROOT, "build", "resilience_phase")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t_phase = time.perf_counter()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (1)-(2) the uninterrupted run, then in segments of 5, synchronous
    # and double-buffered
    reset_counts()
    ref, ref_s = timed(lambda: onemax_run(0, N, RS_NGEN, "auto"))
    if kernels.fused_variation.launches != RS_NGEN:
        fail(f"uninterrupted ea_simple launched K1 "
             f"{kernels.fused_variation.launches} times in {RS_NGEN} gens")
    walls, gens = {}, {}
    for db in (False, True):
        res = ResilientRun(os.path.join(root, "db" if db else "sync"),
                           segment_len=RS_SEG, double_buffer=db)
        reset_counts()
        (got, g), walls[db] = timed(
            lambda: onemax_resilient(dev, 0, N, RS_NGEN, res))
        gens[db] = g.get_state()
        k1 = kernels.fused_variation.launches
        if not (same_tree(torch, ref, got) and k1 == RS_NGEN):
            fail(f"ResilientRun(double_buffer={db}) ea_simple differs from "
                 f"the uninterrupted run or launched K1 {k1} times")
    if not torch.equal(gens[False], gens[True]):
        fail("the two segmented runs left their generators in other states")
    print(f"{tag} ResilientRun ea_simple n={N} L={L}, {RS_NGEN} gens in "
          f"segments of {RS_SEG}, synchronous and double-buffered == "
          f"uninterrupted bitwise (population, fitness, logbook, hall of "
          f"fame); K1 launches {RS_NGEN} each")

    ck = Checkpointer(os.path.join(root, "sync"))
    nbytes = os.path.getsize(ck.path_for(RS_NGEN))
    (step, state), restore_s = timed(lambda: ck.restore_latest(device=dev))
    if not (step == RS_NGEN and same_tree(torch, state["carry"],
                                          (got[0], got[2]))):
        fail("the restored boundary state differs from the run's")
    timing = Checkpointer(os.path.join(root, "timing"), keep=1)
    sync_s, submit_s, write_s = [], [], []
    for i in range(3):
        sync_s.append(timed(lambda: timing.save(2 * i, state))[1])
        writer = AsyncCheckpointWriter()
        submit_s.append(timed(
            lambda: writer.submit(timing, 2 * i + 1, state))[1])
        write_s.append(timed(writer.wait)[1] + submit_s[-1])
    ms = {k: v / RS_NGEN * 1e3 for k, v in
          (("plain", ref_s), ("sync", walls[False]), ("db", walls[True]))}
    print(f"{tag} resilience figures at n={N}, L={L}: checkpoint {nbytes} "
          f"bytes; save synchronous {', '.join(f'{x:.4f}' for x in sync_s)} "
          f"s; double-buffered submit "
          f"{', '.join(f'{x:.4f}' for x in submit_s)} s (written by "
          f"{', '.join(f'{x:.4f}' for x in write_s)} s); restore "
          f"{restore_s:.4f} s; ms/gen uninterrupted {ms['plain']:.3f}, "
          f"segments of {RS_SEG} synchronous {ms['sync']:.3f} (tax "
          f"{ms['sync'] / ms['plain'] - 1:+.1%}), double-buffered "
          f"{ms['db']:.3f} (tax {ms['db'] / ms['plain'] - 1:+.1%})")

    long_ms = {}
    for mode in ("plain", "sync", "db"):
        if mode == "plain":
            run = lambda: onemax_run(0, N, RS_LONG_NGEN, "auto")
        else:
            res = ResilientRun(os.path.join(root, "long_" + mode),
                               segment_len=RS_LONG_SEG,
                               double_buffer=mode == "db")
            run = lambda: onemax_resilient(dev, 0, N, RS_LONG_NGEN, res)[0]
        out_, wall = timed(run)
        long_ms[mode] = wall / RS_LONG_NGEN * 1e3
        if mode == "plain":
            long_ref = out_
        elif not same_tree(torch, long_ref, out_):
            fail(f"ResilientRun ({mode}) over {RS_LONG_NGEN} gens differs")
    print(f"{tag} ms/gen over {RS_LONG_NGEN} gens, uninterrupted "
          f"{long_ms['plain']:.3f}, segments of {RS_LONG_SEG} synchronous "
          f"{long_ms['sync']:.3f} (tax "
          f"{long_ms['sync'] / long_ms['plain'] - 1:+.1%}), double-buffered "
          f"{long_ms['db']:.3f} (tax "
          f"{long_ms['db'] / long_ms['plain'] - 1:+.1%})")

    # (3) a child SIGKILLed at generation 10, its newest file corrupted, a
    # second child resuming from the file before it
    d = os.path.join(root, "kill")
    os.makedirs(d)
    me = os.path.abspath(__file__)
    with open(os.path.join(d, "kill.out"), "w") as out:
        child = subprocess.Popen(
            [sys.executable, me, "--resilience-child", d, "kill",
             repr(time.time())], stdout=out, stderr=subprocess.STDOUT,
            cwd=ROOT)
    jpath = os.path.join(d, "kill.jsonl")
    deadline = time.time() + 300
    while True:
        if child.poll() is not None:
            with open(os.path.join(d, "kill.out")) as f:
                fail(f"the first child exited ({child.returncode}) before "
                     f"generation {RS_KILL_AT}: {f.read()[-3000:]}")
        rows = read_journal(jpath) if os.path.exists(jpath) else []
        if any(r["kind"] == "segment" and r["hi"] == RS_KILL_AT
               for r in rows):
            break
        if time.time() > deadline:
            child.kill()
            child.wait()
            fail(f"the first child did not reach generation {RS_KILL_AT}")
        time.sleep(0.05)
    child.send_signal(signal.SIGKILL)
    child.wait()
    kill_ck = Checkpointer(os.path.join(d, "ck"))
    if child.returncode != -signal.SIGKILL or \
            kill_ck.steps() != [RS_SEG, RS_KILL_AT]:
        fail(f"the first child ended {child.returncode} with checkpoints "
             f"{kill_ck.steps()}")
    corrupt_file(kill_ck.path_for(RS_KILL_AT))
    spawn = time.time()
    out = subprocess.run([sys.executable, me, "--resilience-child", d,
                          "resume", repr(spawn)], capture_output=True,
                         text=True, cwd=ROOT, timeout=600)
    child_s = time.time() - spawn
    if out.returncode != 0:
        fail(f"the resuming child failed ({out.returncode}): "
             f"{out.stdout[-2000:]} {out.stderr[-3000:]}")
    result = restore_state(os.path.join(d, "result.pkl"), device=dev)
    walk = [(r["kind"], r.get("step")) for r in read_journal(
        os.path.join(d, "resume.jsonl")) if r["kind"] in (
        "checkpoint_corrupt", "checkpoint_fallback", "resumed")]
    if walk != [("checkpoint_corrupt", None), ("checkpoint_fallback", RS_SEG),
                ("resumed", RS_SEG)]:
        fail(f"the resuming child's restore walk: {walk}")
    if not (result["launches"] == RS_NGEN - RS_SEG
            and same_tree(torch, (ref[0], ref[2]),
                          (result["pop"], result["hof"]))
            and list(ref[1]) == result["logbook"]
            and torch.equal(result["generator"].get_state(), gens[False])):
        fail(f"the resumed child's result differs from the uninterrupted "
             f"run (K1 launches {result['launches']})")
    print(f"{tag} SIGKILL at generation {RS_KILL_AT} (a child process), "
          f"its newest file corrupted: a fresh process fell back to "
          f"generation {RS_SEG}, launched K1 {result['launches']} times and "
          f"equals the uninterrupted run bitwise (generator state too); "
          f"from its start to its restore {result['to_resumed_s']:.3f} s, "
          f"to its first resumed segment {result['to_first_segment_s']:.3f} "
          f"s, the whole process {child_s:.3f} s")

    # (4) GP symbreg preempted by a real SIGTERM at generation 10 of 20
    g, start, run = symbreg_start(dev, 5, GP_POP)
    reset_counts()
    want, _ = timed(lambda: run(g, start, RS_GP_NGEN))
    k9_want = kernels.gp_grouped_dispatch.launches
    d = os.path.join(root, "gp")
    g2, start2, run2 = symbreg_start(dev, 5, GP_POP)
    try:
        ResilientRun(d, segment_len=RS_SEG,
                     fault_plan=FaultPlan([PreemptAt(RS_GP_PREEMPT)])
                     ).gp_loop(run2, g2, start2, RS_GP_NGEN, device=dev)
        fail("the GP run was not preempted")
    except Preempted as e:
        if e.step != RS_GP_PREEMPT:
            fail(f"the GP run was preempted at {e.step}")
    g3, start3, run3 = symbreg_start(dev, 5, GP_POP)
    reset_counts()
    got_gp, _ = timed(lambda: ResilientRun(d, segment_len=RS_SEG).gp_loop(
        run3, g3, start3, RS_GP_NGEN, device=dev))
    k9 = kernels.gp_grouped_dispatch.launches
    evals = sum(1 for ne in got_gp["nevals"][RS_GP_PREEMPT + 1:] if ne)
    if not (same_tree(torch, want, got_gp) and k9 == evals
            and k9_want == 1 + sum(1 for ne in want["nevals"][1:] if ne)
            and torch.equal(g.get_state(), g3.get_state())):
        fail(f"the resumed GP run differs from the uninterrupted one (K9 "
             f"launches {k9}, evaluations left {evals})")
    print(f"{tag} GP symbreg pop={GP_POP}: SIGTERM at generation "
          f"{RS_GP_PREEMPT} of {RS_GP_NGEN}, resumed == uninterrupted "
          f"bitwise; K9 launches {k9} = evaluations of the generations "
          f"left ({k9_want} uninterrupted)")

    # (5) CMA-ES with J1, 12 generations in segments of 4
    strat = cma.Strategy(torch.full((CMA_DIM,), CMA_START), sigma=CMA_SIGMA,
                         lambda_=CMA_LAMBDA, eigh_impl="jacobi", device=dev)
    tb = Toolbox()
    tb.register("evaluate", benchmarks.sphere)
    tb.register("generate", strat.generate)
    tb.register("update", strat.update)
    kw = dict(stats=fitness_stats(), halloffame_size=1, device=dev)
    st0 = strat.initial_state()
    reset_counts()
    want = algorithms.ea_generate_update(make_generator(29, dev), st0, tb,
                                         RS_CMA_NGEN, strat.spec, **kw)
    torch.cuda.synchronize()
    j1_want = linalg.eigh_jacobi.launches
    st1 = strat.initial_state()
    reset_counts()
    g = make_generator(29, dev)
    got_cma = ResilientRun(os.path.join(root, "cma"),
                           segment_len=RS_CMA_SEG).ea_generate_update(
        g, st1, tb, RS_CMA_NGEN, strat.spec, **kw)
    torch.cuda.synchronize()
    j1 = linalg.eigh_jacobi.launches
    if not (same_tree(torch, (want[0], want[2]), (got_cma[0], got_cma[2]))
            and list(want[1]) == list(got_cma[1])
            and j1 == j1_want == RS_CMA_NGEN):
        fail(f"segmented CMA-ES differs from the uninterrupted run (J1 "
             f"launches {j1}, {j1_want} uninterrupted)")
    print(f"{tag} CMA-ES dim={CMA_DIM} lambda={CMA_LAMBDA} 'jacobi', "
          f"{RS_CMA_NGEN} gens in segments of {RS_CMA_SEG} == uninterrupted "
          f"bitwise; J1 launches {j1}")
    print(f"{tag} phase 19 (resilience): {time.perf_counter() - t_phase:.1f} "
          f"s wall")
    shutil.rmtree(root, ignore_errors=True)


def dtlz2_mu_plus_lambda_toolbox():
    """A (mu + lambda) NSGA-II toolbox on 3-objective DTLZ2 (MO_DIM genes
    in [0, 1]): bounded SBX and polynomial mutation (eta 20), and
    ``sel_nsga2`` through K7 (``nd='tiled'``)."""
    from deap_tpu_torch import Toolbox, mo, ops
    from deap_tpu_torch import benchmarks as bm
    tb = Toolbox()
    tb.register("evaluate", lambda g: bm.dtlz2(g, MO_NOBJ))
    tb.register("mate", ops.cx_simulated_binary_bounded, eta=ZDT1_ETA,
                low=0.0, up=1.0)
    tb.register("mutate", ops.mut_polynomial_bounded, eta=ZDT1_ETA, low=0.0,
                up=1.0, indpb=1.0 / MO_DIM)
    tb.register("select", mo.sel_nsga2, nd="tiled")
    return tb


def sync_debug_error(torch, fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("error")``; None
    when nothing synchronised, else the error and the innermost frame of
    this repository that called the synchronising operation."""
    import traceback
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if f.filename.startswith(ROOT)]
        where = (f"{os.path.relpath(frames[-1].filename, ROOT)}:"
                 f"{frames[-1].lineno} ({frames[-1].line})" if frames
                 else "?")
        return f"{str(e).splitlines()[0]} at {where}"
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return None


def telemetry_phases(torch, dev, tag, onemax_run):
    """Phase 20: every ported loop bare and with telemetry, bitwise equal,
    on the card; the sync check, the tax, the flight recorder and the
    program observatory. ``onemax_run(seed, n, ngen, fused)`` is phase
    3's."""
    import shutil
    from deap_tpu_torch import FitnessSpec, Toolbox, algorithms, benchmarks
    from deap_tpu_torch import gp, ops
    from deap_tpu_torch.core.population import init_population
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.ops import kernels, linalg
    from deap_tpu_torch.resilience import ResilientRun
    from deap_tpu_torch.strategies import cma
    from deap_tpu_torch.support.stats import fitness_stats
    from deap_tpu_torch.telemetry import (
        DiversityProbe, FitnessProbe, FrontProbe, HealthMonitor,
        MetricsRegistry, ProgramObservatory, RunTelemetry, SelectionProbe,
        TreeDiversityProbe, metrics_text, read_journal, strategy_probe)

    root = os.path.join(ROOT, "build", "telemetry_phase")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t_phase = time.perf_counter()
    tb = _onemax_toolbox(Toolbox, ops)
    spec = FitnessSpec((1.0,))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def journal_kinds(path):
        rows = read_journal(path, strict=True)
        return rows, [r["kind"] for r in rows]

    def alternate(bare_fn, tel_fn, reps, check):
        """An untimed telemetered warm-up, then ``reps`` bare runs and
        ``reps`` telemetered runs in turns (counts set to 0 just before
        each telemetered run), each pair checked by ``check(bare, tel)``;
        returns the last pair and each kind's walls."""
        tel_fn("warm")
        walls = {"bare": [], "tel": []}
        for i in range(reps):
            want, s = timed(bare_fn)
            walls["bare"].append(s)
            reset_counts()
            got, s = timed(lambda: tel_fn(i))
            walls["tel"].append(s)
            check(want, got)
        return want, got, walls

    def ms_gen(walls, ngen):
        return {k: min(v) / ngen * 1e3 for k, v in walls.items()}

    def spread(walls):
        return "; walls " + ", ".join(
            f"{k} {' '.join(f'{x:.4f}' for x in v)} s"
            for k, v in walls.items())

    # (1) OneMax: bare, then with telemetry, probes and a HealthMonitor
    def onemax_tel(path):
        g = make_generator(0, dev)
        pop = init_population(g, N, ops.bernoulli_genome(L), spec,
                              device=dev)
        with RunTelemetry(path, health=HealthMonitor()) as tel:
            out = algorithms.ea_simple(
                g, pop, tb, CXPB, MUTPB, TL_NGEN, stats=fitness_stats(),
                halloffame_size=1, telemetry=tel,
                probes=(DiversityProbe(), FitnessProbe(),
                        SelectionProbe(n=N)), device=dev)
        return out, g, tel

    def onemax_bare():
        g = make_generator(0, dev)
        pop = init_population(g, N, ops.bernoulli_genome(L), spec,
                              device=dev)
        return algorithms.ea_simple(g, pop, tb, CXPB, MUTPB, TL_NGEN,
                                    stats=fitness_stats(), halloffame_size=1,
                                    device=dev), g

    def onemax_check(want, got):
        (bare, g_bare), (res, g_tel, _) = want, got
        k1 = kernels.fused_variation.launches
        if not (same_tree(torch, bare, res) and k1 == TL_NGEN and
                torch.equal(g_bare.get_state(), g_tel.get_state())):
            fail(f"telemetered ea_simple differs from the bare run (K1 "
                 f"launches {k1})")

    (bare, g_bare), (_, _, tel), walls = alternate(
        onemax_bare, lambda i: onemax_tel(os.path.join(
            root, f"onemax{i}.jsonl")), TL_REPS, onemax_check)
    k1 = kernels.fused_variation.launches
    rows, kinds = journal_kinds(os.path.join(root,
                                             f"onemax{TL_REPS - 1}.jsonl"))
    gens = [r["gen"] for r in rows if r["kind"] == "meter"]
    if gens != list(range(TL_NGEN + 1)) or tel.meter.host_copies != 1:
        fail(f"telemetered ea_simple journaled meter rows {gens} in "
             f"{tel.meter.host_copies} host copies")
    last = [r for r in rows if r["kind"] == "meter"][-1]
    ms = ms_gen(walls, TL_NGEN)
    print(f"{tag} ea_simple n={N} L={L}, {TL_NGEN} gens with RunTelemetry, "
          f"DiversityProbe, FitnessProbe, SelectionProbe and a HealthMonitor "
          f"== bare bitwise (population, logbook, hall of fame, generator); "
          f"K1 launches {k1}; {len(gens)} meter rows in 1 host copy; "
          f"ms/gen bare {ms['bare']:.3f}, telemetered {ms['tel']:.3f} (tax "
          f"{ms['tel'] / ms['bare'] - 1:+.1%}{spread(walls)}); last row "
          f"best {last['best']}, div_unique_frac "
          f"{last['div_unique_frac']:.4f}, sel_eff_parents "
          f"{last['sel_eff_parents']:.1f}")

    # the generation steps under the sync check
    def steps(with_tel):
        from deap_tpu_torch.algorithms import (_pop_loop_init, _tel_declare,
                                               _tel_measure)
        g = make_generator(3, dev)
        pop = init_population(g, N, ops.bernoulli_genome(L), spec,
                              device=dev)
        pop, hof, _ = _pop_loop_init(pop, tb, 1, fitness_stats())
        tel = mstate = None
        if with_tel:
            tel = RunTelemetry(os.path.join(root, "sync.jsonl"),
                               health=HealthMonitor())
            tel.begin_run("ea_simple", tb, declare=_tel_declare,
                          probes=(DiversityProbe(), FitnessProbe(),
                                  SelectionProbe(n=N)))
            mstate = _tel_measure(tel, tel.meter.init(device=dev),
                                  pop.size, pop, 0)
        step = algorithms.make_ea_simple_step(tb, CXPB, MUTPB,
                                              fitness_stats(), tel)
        torch.cuda.synchronize()

        def run():
            nonlocal pop, hof, mstate
            for gen in range(1, TL_SYNC_GENS + 1):
                if tel is None:
                    pop, hof, _ = step(g, pop, hof)
                else:
                    pop, hof, _, mstate = step(g, pop, hof, mstate, gen)
        err = sync_debug_error(torch, run)
        if tel is not None:
            tel.journal.close()
        return err

    bare_err = steps(False)
    if bare_err is None:
        tel_err = steps(True)
        if tel_err is not None:
            fail(f"the bare generation step runs without a synchronise, the "
                 f"telemetered one synchronises: {tel_err}")
        print(f"{tag} sync check: {TL_SYNC_GENS} bare and {TL_SYNC_GENS} "
              f"telemetered ea_simple generation steps ran under "
              f"set_sync_debug_mode('error') without a synchronise")
    else:
        print(f"{tag} sync check: the bare ea_simple generation step "
              f"synchronises ({bare_err}); the telemetered run's meter made "
              f"{tel.meter.host_copies} host copy for {len(gens)} rows")

    # (2) GP symbreg under TreeDiversityProbe
    pset = gp.math_set(1)
    X, y = symbreg_data(dev)

    def gp_run(path):
        g = make_generator(5, dev)
        start = gp.gen_half_and_half(pset, GP_ML, 1, 2)(g, GP_POP)
        if path is None:
            run = gp.make_symbreg_loop(pset, GP_ML, X, y, cxpb=GP_CXPB,
                                       mutpb=GP_MUTPB, device=dev)
            return run(g, start, TL_GP_NGEN), g
        with RunTelemetry(path, health=HealthMonitor()) as tel:
            run = gp.make_symbreg_loop(
                pset, GP_ML, X, y, cxpb=GP_CXPB, mutpb=GP_MUTPB, device=dev,
                telemetry=tel, probes=(TreeDiversityProbe(pset),))
            return run(g, start, TL_GP_NGEN), g

    gp_path = os.path.join(root, "gp.jsonl")

    def gp_check(want, got):
        (want, g_want), (got, g_got) = want, got
        k9 = kernels.gp_grouped_dispatch.launches
        evals = 1 + sum(1 for ne in got["nevals"][1:] if ne)
        kinds = journal_kinds(gp_path)[1]
        if not (same_tree(torch, want, got) and torch.equal(
                g_want.get_state(), g_got.get_state()) and k9 == evals
                and kinds.count("meter") == TL_GP_NGEN + 1
                and "gp_dispatch" in kinds):
            fail(f"telemetered GP symbreg differs from the bare run (K9 "
                 f"launches {k9}, evaluations {evals}, meter rows "
                 f"{kinds.count('meter')})")

    _, _, walls = alternate(lambda: gp_run(None), lambda i: gp_run(gp_path),
                            TL_OTHER_REPS, gp_check)
    k9 = kernels.gp_grouped_dispatch.launches
    rows, kinds = journal_kinds(gp_path)
    last = [r for r in rows if r["kind"] == "meter"][-1]
    ms = ms_gen(walls, TL_GP_NGEN)
    print(f"{tag} GP symbreg pop={GP_POP}, {TL_GP_NGEN} gens with "
          f"TreeDiversityProbe == bare bitwise; K9 launches {k9} = "
          f"evaluations; {kinds.count('meter')} meter rows, "
          f"{kinds.count('gp_dispatch')} gp_dispatch rows; ms/gen bare "
          f"{ms['bare']:.3f}, telemetered {ms['tel']:.3f} (tax "
          f"{ms['tel'] / ms['bare'] - 1:+.1%}{spread(walls)}); last row "
          f"gp_clone_rate {last['gp_clone_rate']:.4f}, gp_opcode_entropy "
          f"{last['gp_opcode_entropy']:.4f}")

    # (3) 'jacobi' CMA-ES under strategy_probe (the initial state's
    # eigendecomposition made before the counts are set to 0)
    strat = cma.Strategy(torch.full((CMA_DIM,), CMA_START), sigma=CMA_SIGMA,
                         lambda_=CMA_LAMBDA, eigh_impl="jacobi", device=dev)
    ctb = Toolbox()
    ctb.register("evaluate", benchmarks.sphere)
    ctb.register("generate", strat.generate)
    ctb.register("update", strat.update)
    kw = dict(stats=fitness_stats(), halloffame_size=1, device=dev)

    def cma_run(state0, path):
        g = make_generator(29, dev)
        if path is None:
            return algorithms.ea_generate_update(
                g, state0, ctb, TL_CMA_NGEN, strat.spec, **kw), g
        with RunTelemetry(path, probe=strategy_probe(strat),
                          health=HealthMonitor()) as tel:
            return algorithms.ea_generate_update(
                g, state0, ctb, TL_CMA_NGEN, strat.spec, telemetry=tel,
                **kw), g

    cma_path = os.path.join(root, "cma.jsonl")
    # the initial states (one eigendecomposition each) are made before
    # the counts are set to 0
    states = {i: strat.initial_state() for i in ("warm", *range(TL_OTHER_REPS))}

    def cma_check(want, got):
        (want, g_want), (got, g_got) = want, got
        j1 = linalg.eigh_jacobi.launches
        meters = [r for r in journal_kinds(cma_path)[0]
                  if r["kind"] == "meter"]
        if not (same_tree(torch, want, got) and torch.equal(
                g_want.get_state(), g_got.get_state()) and j1 == TL_CMA_NGEN
                and [r["gen"] for r in meters] == list(range(TL_CMA_NGEN))
                and all(math.isfinite(r["sigma"]) for r in meters)):
            fail(f"telemetered CMA-ES differs from the bare run (J1 "
                 f"launches {j1}, meter rows {len(meters)})")

    _, _, walls = alternate(lambda: cma_run(strat.initial_state(), None),
                            lambda i: cma_run(states[i], cma_path),
                            TL_OTHER_REPS, cma_check)
    j1 = linalg.eigh_jacobi.launches
    meters = [r for r in journal_kinds(cma_path)[0] if r["kind"] == "meter"]
    ms = ms_gen(walls, TL_CMA_NGEN)
    print(f"{tag} CMA-ES dim={CMA_DIM} lambda={CMA_LAMBDA} 'jacobi', "
          f"{TL_CMA_NGEN} gens under strategy_probe == bare bitwise; J1 "
          f"launches {j1}; ms/gen bare {ms['bare']:.3f}, telemetered "
          f"{ms['tel']:.3f} (tax {ms['tel'] / ms['bare'] - 1:+.1%}"
          f"{spread(walls)}); sigma {meters[0]['sigma']:.4f} -> "
          f"{meters[-1]['sigma']:.4f}, cond {meters[-1]['cond']:.4f}")

    # (4) (mu + lambda) NSGA-II on DTLZ2 under FrontProbe
    mtb = dtlz2_mu_plus_lambda_toolbox()
    mspec = FitnessSpec((-1.0,) * MO_NOBJ)

    def mo_run(path):
        g = make_generator(31, dev)
        pop = init_population(g, MO_POP, ops.uniform_genome(MO_DIM, 0.0,
                                                             1.0),
                              mspec, device=dev)
        args = (g, pop, mtb, MO_POP, MO_POP, 0.9, 0.1, TL_MO_NGEN)
        if path is None:
            return algorithms.ea_mu_plus_lambda(*args, device=dev), g
        with RunTelemetry(path, health=HealthMonitor()) as tel:
            return algorithms.ea_mu_plus_lambda(
                *args, telemetry=tel, probes=(FrontProbe(TL_MO_REF),),
                device=dev), g

    mo_path = os.path.join(root, "nsga2.jsonl")

    def mo_check(want, got):
        (want, g_want), (got, g_got) = want, got
        k7 = kernels.dominated_weight_sums.launches
        meters = [r for r in journal_kinds(mo_path)[0]
                  if r["kind"] == "meter"]
        if not (same_tree(torch, want, got) and torch.equal(
                g_want.get_state(), g_got.get_state()) and k7 > 0
                and len(meters) == TL_MO_NGEN + 1
                and all(r["hv_proxy"] > 0 for r in meters)):
            fail(f"telemetered NSGA-II differs from the bare run (K7 "
                 f"launches {k7}, meter rows {len(meters)})")

    _, _, walls = alternate(lambda: mo_run(None), lambda i: mo_run(mo_path),
                            TL_OTHER_REPS, mo_check)
    k7 = kernels.dominated_weight_sums.launches
    meters = [r for r in journal_kinds(mo_path)[0] if r["kind"] == "meter"]
    ms = ms_gen(walls, TL_MO_NGEN)
    print(f"{tag} (mu + lambda) sel_nsga2 on DTLZ2 mu={MO_POP} m={MO_NOBJ}, "
          f"{TL_MO_NGEN} gens under FrontProbe == bare bitwise; K7 launches "
          f"{k7}; ms/gen bare {ms['bare']:.3f}, telemetered {ms['tel']:.3f} "
          f"(tax {ms['tel'] / ms['bare'] - 1:+.1%}{spread(walls)}); hv_proxy "
          f"{meters[0]['hv_proxy']:.4f} -> {meters[-1]['hv_proxy']:.4f}, "
          f"front_frac {meters[-1]['front_frac']:.4f}")

    # (5)-(6) ResilientRun with telemetry, metrics and the flight recorder,
    # inside a ProgramObservatory
    reg = MetricsRegistry()
    rs_path = os.path.join(root, "resilient.jsonl")
    with RunTelemetry(rs_path, health=HealthMonitor()) as tel, \
            ProgramObservatory(journal=tel.journal,
                               health=tel.health) as obs:
        res = ResilientRun(os.path.join(root, "ck"), segment_len=TL_SEG,
                           telemetry=tel, metrics=reg,
                           trace_every=TL_TRACE_EVERY)
        reset_counts()
        (got, g_got), rs_s = timed(
            lambda: onemax_resilient(dev, 0, N, TL_NGEN, res))
        k1 = kernels.fused_variation.launches
        n_profiles = len(obs.profiles)
        res2 = ResilientRun(os.path.join(root, "ck2"), segment_len=TL_SEG2,
                            telemetry=tel)
        (got2, _), _ = timed(
            lambda: onemax_resilient(dev, 0, N, TL_NGEN, res2))
    if not (same_tree(torch, bare, got) and same_tree(torch, bare, got2)
            and torch.equal(g_bare.get_state(), g_got.get_state())
            and k1 == TL_NGEN):
        fail(f"the telemetered ResilientRun differs from the bare run (K1 "
             f"launches {k1})")
    rows, kinds = journal_kinds(rs_path)
    traces = [r for r in rows if r["kind"] == "flight_trace"]
    want_traces = len(range(0, TL_NGEN // TL_SEG, TL_TRACE_EVERY))
    if len(traces) != want_traces or not all(os.path.exists(os.path.join(
            r["dir"], "trace.json")) for r in traces):
        fail(f"flight recorder: {len(traces)} flight_trace rows, "
             f"{want_traces} wanted, or their trace files are missing")
    profiles = [r for r in rows if r["kind"] == "program_profile"]
    k1_us = [p["kernel_us"].get(k) for p in profiles
             for k in p["kernel_us"] if K1_KERNEL in k]
    if not (n_profiles == 1 and len(profiles) == 2 and k1_us
            and all(u and u > 0 for u in k1_us) and not obs.drifts
            and len({p["label"] for p in profiles}) == 1):
        fail(f"observatory: {n_profiles} profiles of the first run, "
             f"{len(profiles)} journaled, K1 us {k1_us}, drifts "
             f"{obs.drifts}")
    # each segment's seconds from the journal: boundary to boundary
    marks = [r for r in rows if r["kind"] in ("segments_begin", "segment")]
    seg_s = {}
    for prev, row in zip(marks, marks[1:]):
        if row["kind"] == "segment" and prev.get("algorithm") and \
                row.get("path", "").startswith(os.path.join(root, "ck" + os.sep)):
            seg_s[row["lo"]] = row["t"] - prev["t"]
    traced = [seg_s[r["lo"]] for r in traces if r["lo"] in seg_s]
    plain = [v for lo, v in seg_s.items()
             if lo not in {r["lo"] for r in traces}]
    p0 = profiles[0]
    print(f"{tag} ResilientRun ea_simple n={N}, {TL_NGEN} gens in segments "
          f"of {TL_SEG} with telemetry=, metrics= and trace_every="
          f"{TL_TRACE_EVERY}, and in segments of {TL_SEG2} == bare bitwise; "
          f"K1 launches {k1}; {len(traces)} flight traces; seconds a "
          f"segment traced {', '.join(f'{x:.3f}' for x in traced)}, "
          f"untraced {', '.join(f'{x:.3f}' for x in plain)}; wall "
          f"{rs_s:.3f} s; observatory: {len(profiles)} program_profile rows "
          f"for {p0['label']} (two signatures, no drift alarm), the first "
          f"{p0['n_launches']} launches of {len(p0['kernels'])} kernels, "
          f"{p0['device_us']:.1f} us on the card, K1 "
          f"{', '.join(f'{u:.1f}' for u in k1_us)} us; "
          f"{metrics_text(reg).count('deap_resilience_segment_seconds_count')}"
          f" segment-seconds series in the metrics registry")
    print(f"{tag} phase 20 (telemetry): {time.perf_counter() - t_phase:.1f} "
          f"s wall")
    shutil.rmtree(root, ignore_errors=True)


def _onemax_toolbox(Toolbox, ops):
    import torch
    tb = Toolbox()
    tb.register("evaluate", lambda g: g.sum(-1).to(torch.float32))
    tb.register("mate", ops.cx_two_point)
    tb.register("mutate", ops.mut_flip_bit, indpb=INDPB)
    tb.register("select", ops.sel_tournament, tournsize=TOURNSIZE)
    return tb


if __name__ == "__main__":
    if sys.argv[1:2] == ["--resilience-child"]:
        sys.exit(resilience_child(sys.argv[2:]))
    sys.exit(main())
