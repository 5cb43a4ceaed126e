#!/usr/bin/env python3
"""GPU smoke check of the PyTorch port (``sph_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--profile-steps N] [--only PHASE,...]

Phases (any failure raises and exits nonzero, printing no result). Every
fast-engine run on the card replays each resort period from a CUDA graph
(``core/graphed.py``, the engines' default there): the card runs that
phases 4, 8 and 12 hold to the CPU are graphed, and the launch counts
checked below are the counts a replay adds (its capture's; phase 20 holds
them to the kernels the card ran, as the profiler records them):

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the Hopper pair-pass kernels from ``sph_tpu_torch/ops/
   csrc`` (nvcc, sm_90a) and prints the build seconds and each kernel's
   registers, shared memory, stack and spills from ``-Xptxas -v``;
2b. the native scene builder: ``sph_tpu_torch/scene/csrc/scene_builder.cpp``
   compiled with g++ on this host (``scene.native``; its build seconds
   printed), then sph_tpu's five default scenes generated on it, each
   checked against sph_tpu's particle counts (``NATIVE_SCENES``: the full
   worm's 231,811, the liquid box, the dam-break, the 2-worm scene, the
   reduced worm) with its generation seconds. Every later phase builds its
   scenes on this path, sph_tpu's default;
3. kernel vs plain (small): a small box (8h, fill 0.5) is stepped until its
   pool rests on the floor; the packs and tables that one more sort + step
   hand to each pair pass, from that state with a seeded downward velocity
   kick (so the pool hits the walls), are recorded, and each kernel's
   outputs are held against its plain PyTorch version on the same inputs on
   the card: |diff| <= 1e-5 * the pass's own rounding scale per output
   (``PairPass.rounding_scale``: the largest row sum of the absolute pair
   terms, a factor that vanishes at its cutoff counted at the cutoff's
   magnitude), the max taken over the components of the output's vector
   (both are f32 sums; only the summation order and FMA contraction differ,
   and one component of a vector sum may cancel to far below its terms).
   Every output vector of every pass must reach 100 times its tolerance, or
   the check is vacuous and fails;
4. engine vs plain: from phase 3's settled state with a gentler kick
   (0.3 m/s: the pool reaches the walls' r0 band and builds pressure at
   step 2, while 1-ulp differences stay below 1e-4 over 10 steps; phase
   3's 1 m/s kick amplifies them past it), the small box stepped 10 steps
   at resort_every 1 and 3 on cuda (kernels) and on cpu (plain versions),
   max |dpos| <= 1e-4, with the liquid's largest displacement printed
   beside it (the bound must be far below the motion);
5. liquid-box path: ``Simulator(generate_liquid_box_scene(SimParams()),
   engine="auto", device="cuda")`` (the 30h x 20h x 250h box), 210 steps of
   warm-up (the pool settles on the floor, which phase 6 needs), then 120
   timed steps (whole resort periods, 330 steps in all); checks finite
   state, walls bitwise still, liquid inside the box, no shell or tile overflow, the
   window drift within the shell's capture bound (displacement per resort
   period < dilate - 1 cells), and the per-step kernel launch counts
   (launches are counted over these 120 steps only);
6. kernel vs plain (full box): phase 3's check on the inputs of one more
   step from the box path's final state with phase 3's kick, then both
   versions timed with CUDA events at those shapes;
7. kernel vs plain (reduced worm): the worm at full length in a narrower
   pool (10h x 20h x 108h: every spring anchor stays elastic, which the
   engine requires) is stepped 60 steps on the card, so the muscles are
   active and liquid touches the membrane; all ten pass instances are held
   against their plain versions as in phase 3 (the spring and membrane
   inputs from the state as it is, the liquid passes from the kicked
   state). The spring inputs must hold nonzero activation terms and the
   membrane inputs a liquid-elastic pair within r0 whose column counts two
   or more triangles (both counts are printed), or the check is vacuous;
8. engine vs plain (reduced worm): 10 steps from that state at
   resort_every 1 and 3 on cuda and on cpu, max |dpos| <= 1e-4, the
   largest elastic displacement printed beside it;
9. main path: ``Simulator(generate_worm_scene(SimParams()), engine="auto",
   device="cuda")``, the full worm in the 30h x 20h x 250h pool, one resort
   period of warm-up re-sorted at every step (the start-up transient moves
   particles more than a cell in 30 steps) and held to the shell's capture
   bound like the rest, one whole period (the capture of its graph, set-up
   left out of the timing), then 500 timed steps. Checks: finite state, walls
   bitwise still, no shell or tile overflow, drift within the shell's
   capture bound, exactly 12 rho*, 6 paccel, 2 viscsurf, 1 boundary,
   1 spring and 1 membrane launch a step, and the worm integrity gate of
   ``bench.py``: max spring strain < 0.5 over every spring, mean liquid
   rho/rho0 in [0.5, 2] from the engine's own time-t density sums, muscle
   activation equal to the wave model's at the last step and not all zero.
   With ``--profile-steps N``, N more steps of this path run under
   torch.profiler after the last phase, and the device-time breakdown is
   printed (after it, later profiler sessions in the process were seen to
   drop kernel records, so no phase measures device time after it);
10. kernel vs plain (full worm): phase 7's check and counts on the main
   path's final state, the spring list's entries (kept of the slots the
   slab lists), then all six kernels and their plain versions timed with
   CUDA events at those shapes, beside each kernel's bound: the candidate
   pairs its tables list (tiles x tile width x real own rows) x the
   functor's operations a pair (for the early exits what this run's data
   needs, see ``EXIT_FLOPS``) over the card's f32 rate, against its input
   and output bytes over the card's memory rate; the spring list what its
   entries need (``list_bound``).

11. kernel vs plain (fast engine, small box): phase 3's settled box with
   ``compute_fast_config`` at block 128, ccol 128, every pass of one fast
   step (density, rho*, viscsurf, paccel, boundary) ungated and at sub
   8/16/32, held as in phase 3 (the force passes on the rows the engine
   uses: not walls); the gated kernels of the sort-time passes against the
   ungated ones on the same inputs (max |diff|, rows that differ);
12. engine vs plain (fast engine, small box): phase 4 at resort_every 1 and
   3, sub None and 32;
13. the wall-anchored worm (14h x 12h x 108h: springs anchored to walls):
   ``Simulator(engine="auto")`` must pick the fast engine, whose springs
   take the gather fallback; 60 steps (the first period re-sorted every
   step), 10 launches a step, max strain < 0.5 on the worm's own springs
   and < 1 on its wall anchors (the scene starts stretched), the fallback's
   accelerations on the card against the cpu, then 10 steps cuda vs cpu;
14. the dam-break (``generate_liquid_box_scene(SimParams(),
   fill_fraction=0.8)``, 918,082 particles): auto must pick the fast engine;
   one period of warm-up, 120 timed steps (finite, walls still, liquid in
   the box, 9 launches a step), then every kernel against its plain version
   and timed beside its bound on the final state;
15. the full worm on the fast engine with the TPU-tuned tile widths (block
   256, ccol 512, ccol_c 256): 530 steps through the integrity gate, 120
   timed steps ungated and, after one untimed period (its graph's
   capture), 120 at sub 32 (11 launches a step each), the
   density pass's computed columns a particle and kernel time ungated and
   gated at ccol 128 and 512, every kernel (spring and membrane fed by the
   fast engine's packs) against its plain version and timed, ungated and
   gated;
16. the exact engine (plain PyTorch gathers, no kernel of its own): the
   bench's gate box (2,744 particles) 10 steps on cuda vs cpu, max |dpos|
   <= 1e-4; ``bench.gate_box_equivalence`` on cuda for fastw and fast
   (against the exact engine: <= 1e-4 at resort_every 1, <= 5e-3 at 3);
   the full worm through ``Simulator(engine="exact", device="cuda")``, one
   untimed and 5 timed steps (finite, walls bitwise still, no pair-kernel
   launch; ms/step, peak memory, cell overflow printed); ``diagnostics`` on
   the full worm (time, peak memory, neighbour and cell overflow);
17. the port's bench, ``python -m sph_tpu_torch.bench`` in a subprocess
   (watchdog 600 s, timeout 660 s): exactly one JSON line with value > 0,
   engine fastw and no reason, both gates PASS in its stderr, and its
   timed steps at exactly the fastw worm's launches a step; the line is
   printed on an earlier line of this script's output;
18. the glue path: the ``Pack`` kernel held bitwise to ``pack_plain``
   (``torch.stack``) at n = 232,192 and 232,205, then
   ``sph_tpu_torch.scripts.r4_glue_micro.run()`` with its launches and
   ``pack`` calls counted (one launch a call), its table of times, and the
   kernel, plain and ``torch.stack`` times beside the kernel's bound (8
   rows read and written once over the card's memory rate); the device
   times with the inputs warm in L2 and with L2 flushed before every call
   (a 256 MB buffer written), which the bound holds;
19. the redesigned kernels against their first designs: the density,
   rho*, viscsurf, paccel, boundary and membrane kernels (``pair_ring``)
   and the spring list kernel against ``pair_pass`` for the same functors
   (entry points ``sph_pair_<kind>_prev``, which only this phase calls) on
   every recorded launch of the fastw worm and box (phases 10 and 6:
   raw_mm, raw_ms, raw_sm, visc_mm, visc_ms, pacc_mm, pacc_ms, bnd_ms,
   spring_ms, mem_ms) and of the fast engine's density (the time-t density
   and rho* on the iteration pack), viscsurf and paccel on the dam-break
   and the fast worm, ungated and at sub 8/16/32, its boundary on both and
   its spring and membrane on the fast worm (phases 14 and 15; with
   ``--only ab`` the inputs come from one resort period of each path):
   bitwise where the shipped configuration keeps one thread a row (the
   list kernel does), else held as phase 3 holds a kernel to its plain
   version; for the kernels with an exit the pairs under its reach (the
   membrane's: within r0) beside the candidate pairs and the blocks with
   tiles; the two timed in turns (previous, new, new, previous; CUDA
   events around 20 launches) and by torch.profiler device time, beside
   the bound (the exits charged for what runs, ``EXIT_FLOPS``, with the
   all-pairs charge beside it; the spring list for its entries, with the
   pair form's charge beside it) and the device time of an empty launch;
   the host microseconds of one pair launch; the first spring design's
   launch takes the shared-memory opt-in branch (above 48 KB). Checks no
   spill in the shipped ring and list kernels. Then the box cull on the
   same launches: every ring kernel's outputs bitwise (their bits) those
   of its unculled form (``sph_pair_<kind>_nocull``, which only this phase
   calls), the boxes its box kernel wrote equal to ``chunk_boxes``, its
   device counters of one traced launch (chunks tested and culled)
   against the plain model ``pair_kernels.cull_counts``, and the two timed
   in turns (unculled, culled, culled, unculled; CUDA events, the box
   kernel included) and by profiler device time (the ring and box kernels
   apart; the box kernel's plain version by CUDA events), per launch and
   per step; the dam-break's launches at ccol 1024 (tiles of 64 chunks,
   which take the unculled kernel) bitwise the same; the box kernel's
   ``kernels`` entry (launches on
   the worm's main path, held to one a ring launch in every timed run);
20. the compiled resort period: the full worm through
   ``Simulator(engine="auto", device="cuda")`` graphed (the default) and
   with ``cuda_graph=False``, 60 steps from the same state (the first
   period a step at a time, then one whole period: both of the
   Simulator's graphs), positions, velocities and activation held equal
   bitwise (were they not, two eager runs are compared: the graphed one is
   then held to 1e-4 only if the eager loop does not repeat itself); then
   the fastw worm, the liquid box, the fast worm ungated and at sub 32 and
   the dam-break, each eager and graphed in turns E G G E (120 steps a
   run, every run at its path's launches a step), with each graph's
   capture plus instantiate seconds, pool bytes and launches a replay;
   and 60 profiled steps of the graphed and the eager worm: the
   ``cudaLaunchKernel`` and ``cudaGraphLaunch`` calls a step and their
   host time, the device busy time and idle share (at most
   ``GRAPH_MAX_LAUNCHES`` kernel launch calls a graphed step), and each
   pair kernel's records on the device held to its launches a step (so
   the card, not the replay's bookkeeping, shows each graph runs every
   pair kernel as often as the eager loop);
21. the simulator facade on the full worm, graphed, through
   ``Simulator(engine="auto", device="cuda")``: (a) 45 steps (the first
   period a step at a time), ``save``, 45 more; a new Simulator
   ``restore``s and steps 45, and a second ``restore`` into it steps 45
   again, both bitwise equal to the uninterrupted run, the second capturing
   no graph; save and restore seconds, the archive's bytes, its keys
   sph_tpu's; (d) ``make_fastw_multi_step`` with the walls sorted in the
   graph (``wall_static=None``) against the hoisted path: one sort of
   that state on both (shell rows bitwise, the in-graph f32 wall sums
   within 1e-5 of the host's f64 sums' scale), ``WALL_STEPS`` steps from
   the state and from the hoisted path's state a period on (a resort
   each) within 1e-4, and two periods from the state within 1e-4 or, where
   it grows past that, within the hoisted path's own divergence when every
   wall sum is one ulp up; exactly one more rho* launch a period, ms/step
   in turns; the ``raw_sw`` launch (shell rows x wall
   columns) on one resort's inputs against its plain version as phase 3
   holds a kernel, timed by CUDA events and profiler device time beside its
   bound; (c) 60 steps from the checkpoint with a frame every 10 steps,
   async and sync writes: byte-identical files of 7 frames, ms/step beside
   the same steps without dumps; (b) 150 steps of the adaptive ladder
   (threshold 0.25 h) from step 0, each chunk's period, drift bound and
   overflow, whether the first period outruns the shell, at most 4 graphs,
   ms/step against the fixed period in turns A F F A, and a profile of each
   (graph launches, busy, idle); (e) ``python -m sph_tpu_torch run``
   with a dump and a checkpoint, ``run --restore`` (it must print step 90)
   and ``info`` in subprocesses. It prints its seconds;
22. the at-scale legs: ``sph_tpu_torch.scripts.bench_scale.measure`` on the
   2-worm scene (``generate_multi_worm_scene(2)`` in
   ``generate_multi_worm_params(2)``'s widened pool, 436,750 particles)
   and on the dam-break (fill 0.8), each on fastw (block 256, ccol 512,
   ccol_c 256, walls hoisted) and on fast (``compute_fast_config``'s
   defaults): one untimed chunk of 30 steps (the graph's capture), then 4
   timed chunks; ms/step, particle-steps/s, the first chunk's seconds,
   each capture's seconds and pool bytes, launches a step; checks finite
   state, walls bitwise still, liquid inside the box, no shell overflow
   (dropped moving-wall pairs; the tile overflow, the tiles sph_tpu's
   Pallas caps would drop where the port's kernels have no caps, is
   printed), the timed chunks' window drift within the shell's capture
   bound (the first chunk's printed beside it, and whether it outruns the
   shell), the engine that ran is the one asked for, and each path's
   launches a step; one more chunk of each under torch.profiler: device
   busy ms a step, idle share and the top kernels;
23. the locomotion acceptance run: ``sph_tpu_torch.scripts.locomotion``'s
   ``main`` in this process on the full worm, ``--steps 20000
   --assert-propels --frames ""`` (20,160 steps: the reference loop's 42
   reports of 16 chunks of 30), on fastw (the main path) and on fast (the
   reference's engine); each must pass the reference's gate (PROPELS:
   |dz| > 3 noise and > 0.05; final max strain < 0.5), move the worm's
   centre of mass the way sph_tpu's did (dz > 0) and count no shell
   overflow; prints dz, noise, strains and bounding boxes beside
   sph_tpu's record on the same 231,811-particle scene (+1.7496, 0.0468,
   0.215), the loop's ms/step, the
   first chunk's window drift (fastw: whether it outruns the shell), and
   the idle share: 1 - the device busy ms a step (torch.profiler over 2
   more chunks of the same runner) / the loop's ms a step;
24. the multi-GPU halo engine (``sph_tpu_torch/parallel``) on 2 gloo ranks
   that share the card (``parallel.launch.run_ranks``; the kernels are
   built before the ranks start): (a) ``dryrun_multichip(2, device=
   "cuda")``'s three checks (one all-gather step against the exact engine
   within 2e-5; 3 halo steps and 5 distributed-resort steps of the
   14h x 12h x 108h worm against the fast engine within 5e-5, no
   overflow); (b) the full worm padded to 2 x block, resort_every 5, two
   periods of each resort against the fast engine on the card: every
   overflow 0, positions within 1e-4 beyond 3 h of the generated worm's
   near-coincident pairs and within 1e-2 everywhere (the reduced worm's
   rule), the pair-kernel launches summed over the ranks equal to 2 ranks
   x the fast worm's launches a step, and ms/step of each resort (a rank's
   second run, gloo staging every exchange through host memory; the host
   time inside the collectives by rank) beside the fast engine's eager and
   graphed ms/step and the halo engine's in a world of one on the card;
   (c) each pair kernel once on one rank's recorded slab inputs (one step
   from the replicated run's end state: the liquid passes kicked, see
   ``kicked``, on the rank with the most liquid rows; spring and membrane
   as they are, on the rank with the most elastic rows) against its plain
   version as phase 3 holds a kernel; (d) where the machine has 2 cards
   or more, the engine on nccl ranks, a card each (4 ranks on 4 cards or
   more, 2 on 2 or 3; on one card it prints ``nccl: not run (1 card)``):
   (d0) the four collectives on rank-stamped tensors, each result and
   each rank's card checked; (d1) ``dryrun_multichip(world, "nccl")``;
   the full worm, the 2-worm scene and the fill-0.8 dam-break padded to
   world x block, resort_every 5, a discarded warm-up run, then each
   resort traced (compared with the fast engine on one card by (b)'s
   rule, the dam-break within 1e-4 on every row, bitwise or not printed,
   overflow 0, launches world x the fast engine's a step; the
   collectives' host ms, each from a drained card to its end, and bytes
   sent and received, a step, a resort and a call) and timed twice bare
   (ms/step of the slowest rank) beside the fast engine's eager and
   graphed ms/step; (c) on the worm's world-rank slabs; (d2)
   ``multihost_halo --backend nccl`` (4 cards); (d3) a world-rank
   torchrun of the CLI on the full worm (rank 0 prints, naming every
   rank's card, and writes the checkpoint, held to the fast engine by
   the worm's rule). The halo paths' launches a step (summed over the
   ranks) join the kernels' ``launches_per_step``;
25. ``runtime.timing.profile_trace`` on the main path: the full worm
   through ``Simulator(engine="auto", device="cuda")``, the first period a
   step at a time, one whole period (its graph's capture) and one under
   the tracer (its marked graph's capture), then one period replayed
   inside ``profile_trace`` (closed by ``session_tail``); the
   Chrome trace it writes is read back and must hold a kernel record of
   each of the six pair kernels the path launches (records a kernel
   printed beside its launches) and the ranges of the program's spans
   (the tracer is on within ``profile_trace``).

Each phase prints its seconds. ``--only`` runs the named phases alone
(native: 2b, small: 3-4, box: 5-6, rworm: 7, rworm_engine: 8, worm: 9-10,
small_fast: 11-12, tiny_worm: 13, dam: 14, fast_worm: 15, exact: 16, bench:
17, pack: 18, ab: 19, graph: 20, runtime: 21, scale: 22, locomotion: 23,
halo: 24, trace: 25) while iterating; the run then prints no result lines
and exits 2.

Ends with a JSON line of per-kernel results (each kernel's numbers from the
path that runs it at its main shapes, with its launches a step on every
path, its registers, and for the redesigned kernels the in-call A/B's
per-step times, ``prev_ms`` beside ``ab_ms`` and their profiler device
times: a dam-break step's for density, a fastw worm step's for the others,
a fast worm step's at sub 32 for the gated kernels) and, last, the one-line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from sph_tpu_torch import SimParams, bench, trace
from scipy.spatial import cKDTree

from sph_tpu_torch.constants import (BOUNDARY_PARTICLE, ELASTIC_PARTICLE,
                                     LIQUID_PARTICLE)
from sph_tpu_torch.core import fast as F
from sph_tpu_torch.core import fastw as W
from sph_tpu_torch.core import graphed
from sph_tpu_torch.core import step as S
from sph_tpu_torch.core.elastic import elastic_accel
from sph_tpu_torch.models import muscle
from sph_tpu_torch.ops import _build
from sph_tpu_torch.ops import pair_kernels as pk
from sph_tpu_torch.runtime import Simulator
from sph_tpu_torch.runtime import checkpoint as CK
from sph_tpu_torch.scene import (generate_liquid_box_scene,
                                 generate_multi_worm_params,
                                 generate_multi_worm_scene,
                                 generate_worm_scene)
from sph_tpu_torch.scripts import bench_scale, locomotion

H = 3.34
BOX_STEPS = 120
BOX_WARMUP = 210  # untimed box steps: by step 330 the pool is on the floor
WORM_STEPS = 500
WORM_SETTLE = 60  # reduced-worm steps before its checks
KERNEL_TOL = 1e-5
# an output vector must reach this many times its tolerance in its own pass
MIN_SIGNAL = 100.0
ENGINE_TOL = 1e-4
REST_GAP = 0.93  # a settled pool's lowest liquid above the floor, in h
SETTLE = 300  # small-box steps before its kernel check: the pool is on the floor
# per-step launches of each kernel: rho* = 3 column sets x (time-t density
# + 3 PCISPH iterations); paccel = 2 x 3 iterations; the liquid box has no
# elastic matter and runs no spring or membrane pass
PER_STEP_BOX = {"rho_star": 12, "paccel": 6, "viscsurf": 2, "boundary": 1,
                "spring": 0, "membrane": 0}
PER_STEP = dict(PER_STEP_BOX, spring=1, membrane=1)
# pass name -> kernel kind, per-step launches of that pass
PASSES = {
    "raw_mm": ("rho_star", 4), "raw_ms": ("rho_star", 4),
    "raw_sm": ("rho_star", 4), "visc_mm": ("viscsurf", 1),
    "visc_ms": ("viscsurf", 1), "pacc_mm": ("paccel", 3),
    "pacc_ms": ("paccel", 3), "bnd_ms": ("boundary", 1),
    "spring_ms": ("spring", 1), "mem_ms": ("membrane", 1),
}
ELASTIC_PASSES = ("spring_ms", "mem_ms")
BOX_PASSES = set(PASSES) - set(ELASTIC_PASSES)
REPLACES = {
    "density": "sph_tpu/ops/pair_kernels.py:756",
    "rho_star": "sph_tpu/ops/pair_kernels.py:878",
    "viscsurf": "sph_tpu/ops/pair_kernels.py:799",
    "paccel": "sph_tpu/ops/pair_kernels.py:926",
    "boundary": "sph_tpu/ops/pair_kernels.py:1075",
    "spring": "sph_tpu/ops/pair_kernels.py:1020",
    "membrane": "sph_tpu/ops/pair_kernels.py:1118",
}
SOURCE = "sph_tpu_torch/ops/csrc/pair_pass.cu"
# The card's published peaks (H100 SXM data sheet): f32 outside the tensor
# cores, device memory rate.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# f32 operations of one candidate pair in each functor of pair_pass.cu,
# counted by hand from its pair_at() (a compare, min/max, sqrt, rsqrt and a
# division count one each). The kernels without an early exit charge every
# candidate pair the whole functor; PAIR_FLOPS is the all-pairs charge of
# the others, printed beside what they are charged (EXIT_FLOPS). Membrane's
# is its first design's for every pair: the distance test with its sqrtf
# (12) and the 7-triangle side test and sums (7 x 24 + 12).
PAIR_FLOPS = {"density": 13, "rho_star": 13, "viscsurf": 25, "paccel": 29,
              "boundary": 22, "membrane": 12 + 7 * 24 + 12}
# membrane: the distance and its exit test (9) for every candidate pair;
# for the pairs within r0 the sqrtf, d and its test (3), the 7-triangle
# side test (7 x 24) and the sums (12)
MEMBRANE_TEST_FLOPS, MEMBRANE_NEAR_FLOPS = 9, 3 + 7 * 24 + 12
# The ring kernels with an early exit are charged what runs: paccel the
# distance and radius test (17, the exit's two compares included) for every
# candidate pair, the force body (12) for the pairs that run it; viscsurf
# and boundary the distance and the exit test (9) for every candidate pair,
# the rest for the pairs under their reach (``near_pairs``): viscsurf 17
# (sqrtf, the weight, the three velocity terms and the surface test and
# sums), boundary 14 (sqrtf, d, the weight, the five sums); membrane above.
EXIT_FLOPS = {"paccel": (17, 12), "viscsurf": (9, 17), "boundary": (9, 14),
              "membrane": (MEMBRANE_TEST_FLOPS, MEMBRANE_NEAR_FLOPS)}
# spring on its list: 3 a kept entry (msum, rest, actf), 28 a merged
# column's term; the first design (a pair pass) one id compare a slot for
# every candidate pair and the same sums
SPRING_ENTRY_FLOPS, SPRING_TERM_FLOPS = 3, 28
# the reduced worm: full length in a narrower pool, every spring anchor
# elastic (a lower or tighter box anchors the worm's springs to the walls)
REDUCED_WORM = dict(x_max=10 * H, y_max=20 * H, z_max=108 * H)

# ---- the fast engine (phases 11-15) ----
# the subgroup gate's kernels replace the TPU's gated pass
for _k in pk.GATED:
    REPLACES[_k + "_sub"] = "sph_tpu/ops/pair_kernels.py:492"
# fast-engine pass name -> launches a step (the density kind runs the
# time-t density and, on the iteration pack, the 3 rho* launches)
FAST_PASSES = {"density": 1, "rho_star": 3, "viscsurf": 1, "paccel": 3,
               "boundary": 1, "spring": 1, "membrane": 1}
# launch keys a step: 9 pair launches on the liquid box, 11 on the worm
PER_STEP_DAM = {"density": 4, "viscsurf": 1, "paccel": 3, "boundary": 1}
PER_STEP_FAST_WORM = dict(PER_STEP_DAM, spring=1, membrane=1)
SUBS = (None, 8, 16, 32)
# the worm of ``__graft_entry__._tiny_worm``: its springs anchor to walls
TINY_WORM = dict(x_max=14 * H, y_max=12 * H, z_max=108 * H)
TINY_SETTLE = 60
DAM_WARMUP = 30   # one resort period before the timed steps
DAM_STEPS = 120
# the TPU-tuned fast-engine worm config (results/r4/best_config.json)
R4 = dict(block=256, ccol=512, ccol_c=256)
FAST_WORM_STEPS = 530
FAST_WORM_TIMED = 120

# ---- the exact engine, the bench and the glue path (phases 16-18) ----
REPO = os.path.dirname(os.path.abspath(__file__))
EXACT_BOX_STEPS = 10
EXACT_WORM_STEPS = 5
BENCH_WATCHDOG_S = 600

# ---- the compiled resort period (phase 20) ----
GRAPH_STEPS = 60      # graphed vs eager from one state: both period graphs
GRAPH_TIMED = 120     # steps a run of the E G G E turns: 4 periods
GRAPH_PROFILE = 60    # profiled steps, graphed and eager
# kernel launch calls a graphed step may make: the copies into and out of
# the graph's static buffers and the diagnostics fold, a period's, spread
# over its 30 steps (the eager worm step makes ~444)
GRAPH_MAX_LAUNCHES = 5
LAUNCH_APIS = ("cudaLaunchKernel", "cudaGraphLaunch")
TAIL_KERNELS = 4096   # spin kernels closing a profiler session (``profile``)
TAIL_CYCLES = 5000    # each ~2.5 us at the card's clock: ~10 ms in all
SESSION_TAIL = []     # its graph, captured at the first session

# ---- the simulator facade (phase 21) ----
RUNTIME_STEPS = 45    # steps before the checkpoint, and after it
WALL_PERIODS = 2      # periods of the in-graph wall path
DUMP_STEPS = 60
DUMP_INTERVAL = 10    # 7 frames: step 0's and six
LADDER_STEPS = 150
LADDER_THRESHOLD_H = 0.25
CLI_TIMEOUT_S = 300
CLI_SCENE = ["--scene", "worm"]
CLI_RUN = []                   # more flags of the run commands
CLI_STEPS, CLI_MORE = 60, 30   # a frame and a period every 30 steps
# ---- the at-scale legs and the locomotion run (phases 22-23) ----
N_WORMS = 2
SCALE_ROUNDS = 4               # timed chunks of 30 steps a leg
LOCO_STEPS, LOCO_CHUNK, LOCO_REPORT = 20000, 30, 500   # the reference's
# sph_tpu's locomotion record on the fast engine (BASELINE.md:106-109):
# 20,000 steps of its default full worm, the scene the port now builds
REF_LOCO = dict(dz=1.7496, noise=0.0468, strain=0.215)
LOCO_PROFILE_CHUNKS = 2        # profiled chunks for the device busy time
# ---- the native scene builder and the trace (phases 2b, 25) ----
# sph_tpu's default scenes (its native builder): particles, and the type
# counts that set them apart from the NumPy path's (1,076 more walls on the
# full box's 30h x 20h x 250h; the reduced worm's pool 840 fewer liquid)
NATIVE_SCENES = {
    "worm": dict(n=231_811, liquid=120_336, elastic=10_143,
                 boundary=101_332, springs=137_804, membranes=11_386),
    "box": dict(n=210_232, boundary=101_332),
    "dam": dict(n=918_082, liquid=816_750),
    "worm2": dict(n=436_750, boundary=165_892),
    "rworm": dict(n=60_603, liquid=24_036),
}
# sph_tpu's checkpoint keys (``runtime.checkpoint.KEYS``; a CPU test holds
# the list to sph_tpu's archive)
CKPT_KEYS = CK.KEYS
# the functor of a pair kernel's device name -> its kind in pk.LAUNCHES
FUNCTOR_KIND = {"Density": "density", "RhoStar": "rho_star",
                "ViscSurf": "viscsurf", "PAccel": "paccel",
                "Boundary": "boundary", "Spring": "spring",
                "Membrane": "membrane"}


def check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def box_edge(params) -> float:
    """The longest box edge: real particles lie below it, pad rows and pad
    columns of the packs beyond."""
    return max(params.x_max, params.y_max, params.z_max)


def card_lines() -> list[str]:
    """``nvidia-smi``'s name and power limit of every card, a line each."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [line.strip() for line in res.stdout.strip().splitlines()]


def card_line() -> str:
    return card_lines()[0]


def scene_setup(scene, params, device, **cfg_kw):
    layout = scene.layout()
    cfg = W.compute_fastw_config(scene.pos, params, layout,
                                 ptype=scene.ptype, device=device, **cfg_kw)
    ws = W.precompute_wall_static(scene.pos, scene.normal, params, layout,
                                  cfg)
    return scene, layout, cfg, ws


def kicked(state, speed=1.0, noise=0.3, seed=0, rest_gap=None):
    """``state`` with a seeded velocity kick of the moving particles: down at
    ``speed`` m/s (1 m/s is 2.5 sim units a step) with Gaussian ``noise``.
    At the defaults one step drives the pool's bottom layer into the walls'
    r0 band (the resting pool sits ~h above them and the boundary pass
    would sum zeros) and compresses it (nonzero pressure). A pool that has
    not settled yet (it takes ~300 steps) is first lowered as a whole, with
    everything else that moves, until its lowest liquid particle sits
    ``rest_gap`` above the floor walls, where a settled pool rests."""
    rng = np.random.default_rng(seed)
    ptype = state.ptype.cpu().numpy()
    moving = ptype != BOUNDARY_PARTICLE
    kick = (rng.normal(0.0, noise, (int(moving.sum()), 3))
            + (0.0, -speed, 0.0))
    vel = state.vel.cpu().numpy().copy()
    vel[moving] += kick.astype(np.float32)
    pos = state.pos.cpu().numpy().copy()
    if rest_gap is not None:
        gap = (pos[ptype == LIQUID_PARTICLE, 1].min()
               - pos[~moving, 1].min())
        pos[moving, 1] -= np.float32(max(0.0, gap - rest_gap))
    dev = state.vel.device
    return dataclasses.replace(state, vel=torch.as_tensor(vel, device=dev),
                               pos=torch.as_tensor(pos, device=dev))


def to_device(obj, device):
    """A state dataclass with every tensor moved to ``device``."""
    return type(obj)(**{f.name: getattr(obj, f.name).to(device)
                        for f in dataclasses.fields(obj)})


def record_step_inputs(params, layout, cfg, ws, state, springs, membranes):
    """(pass, tables, own, slab) of the last call of each pair pass in one
    sort + one step of the fastw engine from ``state``; a fifth entry, where
    present, flags the own rows whose outputs the engine uses. On a scene with
    elastic matter the spring and membrane inputs come from ``state`` as it
    is and the liquid passes' from the kicked state (see ``kicked``)."""
    parts = W._make_step_parts_w(params, layout, cfg, wall_static=ws)
    calls = W.record_step_inputs(
        parts, kicked(state, rest_gap=REST_GAP * params.h), springs,
        membranes)
    expect = BOX_PASSES
    if layout.n_elastic > 0:
        expect = set(PASSES)
        ctx = {}
        still = W.record_step_inputs(parts, state, springs, membranes,
                                     ctx_out=ctx)
        calls.update({k: still[k] for k in ELASTIC_PASSES})
        # the engine applies the membrane sums to liquid rows only. On an
        # elastic row that is a vertex of the column's triangle the side
        # s = n . (x - a) is rounding noise around 0 and its sign, hence the
        # sum, is undefined: such rows are not compared
        p = calls["mem_ms"][0]
        calls["mem_ms"] += (ctx["liq_s"][:p.n_pad] > 0,)
    check(set(calls) == expect, f"passes called: {sorted(calls)}")
    return calls


def elastic_input_counts(params, calls, label,
                         names=("spring_ms", "mem_ms")):
    """The counts that make the spring and membrane checks non-vacuous:
    nonzero activation terms in the spring slab, and pairs of a liquid own
    row and an elastic column within r0 (new positions) whose column counts
    >= 1 and >= 2 triangles.
    The pairs come from a k-d tree on the host: within r0 is within the
    block's window, so the tables list them. Returns the springs the slab
    lists (the first spring design's charge in ``pass_bound``) and the
    pairs of any real own row and an elastic column within r0."""
    p, _, _, slab = calls[names[0]][:4]
    n_act = int((slab[3 + 2 * p.n_slots:3 + 3 * p.n_slots] != 0).sum())
    n_springs = int((slab[3:3 + p.n_slots] >= 0).sum())
    p, tables, own, slab, liquid = calls[names[1]]
    far = box_edge(params)
    own_all = own[3:6, :p.n_pad].T.cpu().numpy().astype(np.float64)
    own_n = own_all[liquid.cpu().numpy()]
    m = slab.cpu().numpy().astype(np.float64)
    cols = np.nonzero(m[pk.PMM_XN] < far)[0]
    col_tree = cKDTree(m[pk.PMM_XN:pk.PMM_ZN + 1, cols].T)
    n_near = int(cKDTree(own_all[own_all[:, 0] < far]).count_neighbors(
        col_tree, float(params.r0)))
    pairs = cKDTree(own_n).query_ball_tree(col_tree, float(params.r0))
    ii = np.repeat(np.arange(len(pairs)), [len(q) for q in pairs])
    jj = cols[np.concatenate([np.asarray(q, np.int64) for q in pairs])]
    cnt = np.zeros(len(ii))
    for t in range(pk.MEM_TRIS):
        nt, at = m[6 * t:6 * t + 3, jj], m[6 * t + 3:6 * t + 6, jj]
        side = ((own_n[ii].T - at) * nt).sum(0)
        cnt += ((nt * nt).sum(0) > 0) & (side != 0)
    n1, n2 = int((cnt >= 1).sum()), int((cnt >= 2).sum())
    print(f"  {label:5s} spring slab: {n_act} nonzero activation terms; "
          f"membrane: {len(ii)} liquid-elastic pairs within r0, {n1} with "
          f"cnt >= 1, {n2} with cnt >= 2; membrane blocks with tiles "
          f"{int((tables[4] > 0).sum())} of {p.n_blocks}", flush=True)
    check(n_act > 0, f"{label}: no nonzero activation term in the spring "
          "inputs")
    check(n2 > 0, f"{label}: no membrane pair with cnt >= 2")
    return dict(spring=n_springs, membrane=n_near)


def computed_pairs(p, tables, own, far):
    """(candidate pairs the launch computes, real own rows): per block its
    tiles x tile width x its real own rows (pad rows sit beyond ``far``);
    for a gated pass per subgroup the tiles its gate admits x tile width x
    the group's real rows. pairs / rows = computed columns per particle."""
    ob = int(tables[5][0])
    real = (own[0, ob:ob + p.n_pad] < far).reshape(p.n_blocks, p.block)
    if not p.gated:
        return (int((tables[4].long() * real.sum(1)).sum()) * p.ccol,
                int(real.sum()))
    aln, _, _, s0, cnt, _ = (t.long() for t in tables[:6])
    ng = p.block // p.sub
    t = torch.arange(int(cnt.max()), device=cnt.device)[None, :]
    b3 = torch.arange(p.n_blocks, device=cnt.device)[:, None] * 3
    c = b3 + (t >= s0[b3 + 1]).long() + (t >= s0[b3 + 2]).long()
    off = (aln[c] + (t - s0[c]) * p.ccol)[:, None, None, :]
    glo, ghi = (g.long().reshape(p.n_blocks, 3, ng)[..., None]
                for g in tables[6:8])
    act = ((ghi > off) & (glo < off + p.ccol)).any(1)   # [nb, ng, T]
    act &= (t < cnt[:, None])[:, None, :]
    rows = real.reshape(p.n_blocks, ng, p.sub).sum(2)
    return (int((act.sum(2) * rows).sum()) * p.ccol, int(real.sum()))


# kind -> (own rows, slab rows) of the positions a kernel's distance test
# reads (the boundary and membrane passes: the own rows' new positions)
TEST_ROWS = {"paccel": (0, 0), "viscsurf": (0, 0), "boundary": (3, pk.PB_X),
             "membrane": (3, pk.PMM_XN)}


def near_pairs(p, tables, own, slab) -> int:
    """The (own row, listed column) pairs whose body runs after a ring
    kernel's early exit, as the kernel tests them in f32: paccel 0 < r and
    (r < h or r < h/4), viscsurf, boundary and membrane r2 < their reach
    (the pass's last constant); every other pair is an exact zero of the
    sums. The data-dependent part of their work (``pass_bound``)."""
    n = 0
    i0, j0 = TEST_ROWS[p.kind]
    for _, live, o, s, valid, _ in pk.pair_chunks(p, tables, own, slab):
        dx, dy, dz = (o[i0 + k] - s[j0 + k] for k in range(3))
        r2 = dx * dx + dy * dy + dz * dz
        if p.kind != "paccel":
            body = valid & (r2 < p.consts[-1])
        else:
            h, h4 = p.consts[:2]
            r = r2 * torch.rsqrt(torch.clamp(r2, min=1e-30))
            body = valid & (r2 > 0.0) & ((h - r > 0.0) | (h4 - r > 0.0))
        n += int((body.sum(-1) * live).sum())
    return n


def spring_list_work(p, tables, own):
    """(kept entries, merged columns, distinct columns, rows with entries)
    of a spring list: the data its kernel must read and sum."""
    row_ptr, ent = tables[6].long(), tables[7].long()
    kept = int(row_ptr[-1])
    n_row = row_ptr[1:] - row_ptr[:-1]
    row = torch.repeat_interleave(torch.arange(p.n_pad, device=own.device),
                                  n_row)
    col = ent[:kept] // p.n_slots
    new = torch.ones_like(col, dtype=torch.bool)
    new[1:] = (row[1:] != row[:-1]) | (col[1:] != col[:-1])
    return (kept, int(new.sum()), int(torch.unique(col).numel()),
            int((n_row > 0).sum()))


def list_bound(p, tables, own):
    """(merged columns, bound ms, "operations" | "bytes") of one spring
    list launch: bytes = the kept entries and their rest and activation
    terms (12 B each), row_ptr, the positions of the columns and of the
    rows they name, and the outputs, each once; operations = 3 a kept entry
    and 28 a merged column."""
    kept, merged, cols, rows = spring_list_work(p, tables, own)
    nbytes = (12 * kept + 4 * (p.n_pad + 1) + 12 * (cols + rows)
              + 12 * p.n_pad)
    ops = SPRING_ENTRY_FLOPS * kept + SPRING_TERM_FLOPS * merged
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return merged, max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                         else "bytes")


def pass_bound(p, tables, own, slab, far, data_work):
    """(candidate pairs, bound ms, "operations" | "bytes") of one launch:
    pairs = ``computed_pairs``; operations = pairs x the functor's count
    (see ``PAIR_FLOPS``; the exits' near pairs are counted here, see
    ``EXIT_FLOPS``) over the card's f32 peak; bytes = the pack rows the
    pass reads, its tables and its outputs, each once, over the card's
    memory rate. The spring pass on its list: ``list_bound``; on the
    6-tuple tables (its first design) the pair pass's bound, charged for
    ``data_work["spring"]``, the springs the slab lists."""
    if p.kind == "spring" and len(tables) == 8:
        return list_bound(p, tables, own)
    n_out, own_rows, slab_rows = pk._rows(p)
    pairs = computed_pairs(p, tables, own, far)[0]
    nbytes = 4 * (slab_rows * slab.shape[1] + n_out * p.n_pad
                  + sum(t.numel() for t in tables))
    if own.data_ptr() != slab.data_ptr():
        nbytes += 4 * own_rows * p.n_pad
    if p.kind == "spring":
        ops = pairs * p.n_slots + data_work["spring"] * (
            SPRING_ENTRY_FLOPS + SPRING_TERM_FLOPS)
    elif p.kind in EXIT_FLOPS:
        test, body = EXIT_FLOPS[p.kind]
        ops = pairs * test + near_pairs(p, tables, own, slab) * body
    else:
        ops = pairs * PAIR_FLOPS[p.kind]
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return pairs, max(t_ops, t_bytes), by


def compare(calls, label, far):
    """Kernel vs plain on each recorded pass; returns name -> max abs err
    over the real own rows. The tolerance of an output vector is KERNEL_TOL
    x the largest rounding scale (``PairPass.rounding_scale``) its
    components reach on the pass's real own rows, and the vector's largest
    magnitude there must be MIN_SIGNAL tolerances or more: a pass whose
    pairs are all marginal fails as vacuous. Pad rows (beyond ``far``; they
    pair with the pad columns at distance 0 and would dominate both maxima)
    are held to KERNEL_TOL x their own row's scale where that is larger."""
    errs = {}
    for name, (p, tables, own, slab, *used) in sorted(calls.items()):
        outs = [p.kernel(tables, own, slab), p.plain(tables, own, slab),
                p.rounding_scale(tables, own, slab)]
        torch.cuda.synchronize()
        k, r, scale = (o if isinstance(o, tuple) else (o,) for o in outs)
        for i, a in enumerate(k):
            check(bool(torch.isfinite(a).all()), f"{label} {name}[{i}]: "
                  "kernel output not finite")
        ob = int(tables[5][0])
        real = own[0, ob:ob + p.n_pad] < far
        if used:                       # rows whose sums are defined
            keep = used[0]
            k, r, scale = ([a[keep] for a in o] for o in (k, r, scale))
            real = real[keep]
        err = top = 0.0
        signal = float("inf")
        for group in pk.OUTPUT_GROUPS[p.kind]:
            row_scale = torch.stack([scale[i] for i in group]).amax(0)
            tol = KERNEL_TOL * float(row_scale[real].max())
            mag = max(float(r[i][real].abs().max()) for i in group)
            check(mag > 0.0 and mag >= MIN_SIGNAL * tol,
                  f"{label} {name}{list(group)}: max|plain| {mag:.3e} < "
                  f"{MIN_SIGNAL:g} * tolerance {tol:.3e}: vacuous")
            row_tol = torch.clamp(KERNEL_TOL * row_scale, min=tol)
            for i in group:
                d = (k[i] - r[i]).abs()
                check(bool((d <= row_tol).all()),
                      f"{label} {name}[{i}]: |kernel - plain| "
                      f"{float(d[real].max()):.3e} on real rows, tolerance "
                      f"{tol:.3e}; {float((d / row_tol).max()):.3g} "
                      "tolerances on some row")
                err = max(err, float(d[real].max()))
            top = max(top, mag)
            signal = min(signal, mag / tol)
        errs[name] = err
        print(f"  {label:5s} {name:9s} {p.kind:9s} blocks {p.n_blocks:4d} "
              f"ccol {p.ccol}: max|diff| {err:.3e}, max|plain| {top:.3e}, "
              f"least max|plain| / tolerance {signal:.3g}", flush=True)
    return errs


def time_ms(fn, reps, warm=True):
    """Mean device milliseconds per call, CUDA events around reps calls
    (after one untimed call when ``warm``)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def profiled_kernels(run):
    """name -> (launches, device microseconds) of the CUDA kernels that
    ``run()`` launches under one torch.profiler session."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    cuda = torch.autograd.DeviceType.CUDA
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return {e.key: (e.count, e.self_device_time_total)
            for e in prof.key_averages() if e.device_type == cuda}


def device_ms(fn, reps=50, tries=3, flush=None):
    """Mean device milliseconds of the one CUDA kernel a call of ``fn``
    launches: torch.profiler over ``reps`` calls (after one untimed call),
    the mean over the kernel records it kept, or None unless one of
    ``tries`` sessions kept between half of them and all. Sessions drop
    records: in one run, after the first few sessions of the process,
    the first kernel of every session; after a long profiled window in the
    same process, many (why ``--profile-steps`` runs last). With ``flush``
    (a tensor larger than the card's 50 MB L2) it is overwritten before
    every call, so each call finds its inputs in device memory, not in L2;
    the kernels that write it are left out."""
    skip = ()
    if flush is not None:
        skip = profiled_kernels(lambda: flush.fill_(1.0))
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            if flush is not None:
                flush.fill_(1.0)
            fn()

    for _ in range(tries):
        ms = _mean_ms([v for k, v in profiled_kernels(run).items()
                       if k not in skip], reps)
        if ms is not None:
            return ms
    return None


def _mean_ms(records, reps):
    """Mean milliseconds a call of the (launches, device us) ``records``,
    one a kernel name, of ``reps`` calls that launch each kernel once (a
    culled ring launch: its box kernel and its ring kernel): the sum of
    each kernel's mean, or None unless between half and all of each
    kernel's launches were recorded."""
    if not records:
        records = [(0, 0.0)]
    for n, _ in records:
        if not reps // 2 <= n <= reps:
            print(f"  device time not measured: the profiler kept {n} "
                  f"kernel records of {reps} calls", flush=True)
            return None
    return sum(us / n for n, us in records) / 1e3


def ab_device_ms(prev, new, reps=50, tries=3):
    """(first design, new) mean device milliseconds a launch, as
    ``device_ms`` takes them, in one profiler session: ``reps`` calls of
    ``prev`` (a ``pair_pass`` kernel), then of ``new``; None for each
    unless the session kept enough records of both."""
    prev()
    new()
    torch.cuda.synchronize()

    def run():
        for f in (prev, new):
            for _ in range(reps):
                f()

    for _ in range(tries):
        kernels = profiled_kernels(run)
        ms = [_mean_ms([v for k, v in kernels.items()
                        if ("pair_pass" in k) == old], reps)
              for old in (True, False)]
        if None not in ms:
            return ms
    return [None, None]


def engine_run(scene, params, dev, engine, steps, cfg_kw):
    """run(state, springs, membranes) -> state: ``steps`` steps of the fastw
    or fast engine on ``dev`` (fastw: no shell or tile overflow)."""
    if engine == "fast":
        cfg = F.compute_fast_config(scene.pos, params, **cfg_kw)
        return F.make_fast_multi_step(params, scene.layout(), cfg, steps)
    _, layout, cfg, ws = scene_setup(scene, params, dev, **cfg_kw)
    run = W.make_fastw_multi_step(params, layout, cfg, steps,
                                  return_diag=True, wall_static=ws)

    def go(state, springs, membranes):
        out, diag = run(state, springs, membranes)
        check(int(diag["shell_overflow"]) == 0
              and int(diag["tile_overflow"]) == 0,
              f"overflow on {dev}: {diag}")
        return out

    return go


def engine_vs_plain(scene, params, start, springs, membranes,
                    kind=LIQUID_PARTICLE, what="liquid", engine="fastw",
                    configs=(dict(resort_every=1), dict(resort_every=3))):
    """The engine on cuda (kernels) and on cpu (plain versions), 10 steps
    from ``start`` at each config; the largest displacement of the particles
    of ``kind`` is printed beside the difference."""
    moving = (start.ptype == kind).cpu().numpy()
    pos0 = start.pos.cpu().numpy()
    for cfg_kw in configs:
        pos, vel = {}, {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            out = engine_run(scene, params, dev, engine, 10, cfg_kw)(
                to_device(start, dev), to_device(springs, dev),
                to_device(membranes, dev))
            pos[dev] = out.pos.cpu().numpy()
            vel[dev] = out.vel.cpu().numpy()
            print(f"    {dev}: {time.perf_counter() - t0:.1f} s", flush=True)
        d = float(np.abs(pos["cuda"] - pos["cpu"]).max())
        dv = float(np.abs(vel["cuda"] - vel["cpu"]).max())
        moved = float(np.linalg.norm(pos["cpu"] - pos0, axis=1)[moving].max())
        print(f"  {engine} {cfg_kw}: max|dpos| cuda vs cpu {d:.3e} "
              f"(max|dvel| {dv:.3e}); largest {what} displacement "
              f"{moved:.3e}", flush=True)
        check(np.isfinite(pos["cuda"]).all() and d <= ENGINE_TOL,
              f"engine cuda vs cpu max|dpos| {d} > {ENGINE_TOL}")
        check(moved > 100 * ENGINE_TOL,
              f"the {what} moved only {moved}: the check is vacuous")


def check_capture(sim, label):
    """Reads and resets the simulator's diagnostics: no shell or tile
    overflow, drift inside the shell's capture bound. Returns the report."""
    ovf = sim.check_overflow()
    check(ovf["shell_overflow"] == 0 and ovf["tile_overflow"] == 0,
          f"{label}: overflow: {ovf}")
    # the shell holds every wall within reach while no particle moves more
    # than dilate - 1 cells (h each) in a resort period; window_drift_h is
    # twice that displacement bound, in h
    shell_bound = sim._fast_cfg.dilate - 1
    check(ovf["window_drift_h"] / 2 < shell_bound,
          f"{label}: window drift {ovf['window_drift_h']} h: a particle "
          f"may have moved past the shell's {shell_bound}-cell capture "
          "bound")
    return ovf


def check_run(sim, scene, steps, launches, per_step, label):
    """The checks every driven path shares: finite state, walls bitwise
    still, no overflow, drift inside the shell's capture bound, the exact
    per-step launch counts. Returns the overflow report."""
    pos, vel = sim.get_position(), sim.get_velocity()
    check(np.isfinite(pos).all() and np.isfinite(vel).all(),
          f"{label}: non-finite state")
    b0, b1 = sim.layout.boundary_range
    check(np.array_equal(pos[b0:b1], scene.pos[b0:b1]),
          f"{label}: walls moved")
    ovf = check_capture(sim, label)
    for kind, per in per_step.items():
        check(launches[kind] == per * steps,
              f"{label} {kind}: {launches[kind]} launches in {steps} steps, "
              f"expected {per * steps}")
    return ovf


def timed_run(sim, steps):
    """(seconds, launches by kind) of ``steps`` steps ending in a device
    synchronize, the launch counts set to 0 just before. The box kernel's
    launches (``pk.BOX_LAUNCHES``) are held to one a ring launch and kept
    in ``BOX_LAUNCHED``."""
    torch.cuda.synchronize()
    for counter in (pk.LAUNCHES, pk.BOX_LAUNCHES):
        for k in counter:
            counter[k] = 0
    t0 = time.perf_counter()
    sim.step(steps)
    torch.cuda.synchronize()
    dt, launches = time.perf_counter() - t0, dict(pk.LAUNCHES)
    ring = sum(n for k, n in launches.items()
               if k.removesuffix("_sub") in pk.RING)
    BOX_LAUNCHED[0] = pk.BOX_LAUNCHES["chunk_boxes"]
    check(BOX_LAUNCHED[0] == ring, f"{BOX_LAUNCHED[0]} box kernel launches "
          f"for {ring} ring launches")
    return dt, launches


def worm_integrity(sim, scene, params, parts=None):
    """The worm gate of ``bench.py``: springs hold (max strain < 0.5 over
    every spring) and the liquid's mean density is sane (rho/rho0 in
    [0.5, 2]); the density is the engine's own time-t sum (one sort + its
    density passes on the final state: ``parts``, the fastw engine's by
    default)."""
    pos = sim.get_position()
    idx = scene.spring_idx
    used = idx >= 0
    a = pos[np.repeat(scene.spring_rows, idx.shape[1])[used.ravel()]]
    r = np.linalg.norm(a - pos[idx[used]], axis=1) * params.simulation_scale
    rest = scene.spring_rest[used]
    strain = float(np.max(np.abs(r - rest) / np.maximum(rest, 1e-9)))
    if parts is None:
        parts = W._make_step_parts_w(params, sim.layout, sim._fast_cfg,
                                     wall_static=sim._wall_static)
    rho = parts.density(sim.state, sim.springs, sim.membranes).cpu().numpy()
    l0, l1 = sim.layout.liquid_range
    check(np.isfinite(rho[l0:l1]).all(), "liquid density not finite")
    ratio = float(rho[l0:l1].mean()) / params.rho0
    print(f"  integrity at step {sim.step_count}: max strain {strain:.4f} "
          f"(< 0.5) over {int(used.sum())} springs, mean liquid rho/rho0 "
          f"{ratio:.4f} (in [0.5, 2])", flush=True)
    check(strain < 0.5, f"max spring strain {strain} >= 0.5")
    check(0.5 <= ratio <= 2.0, f"mean liquid rho/rho0 {ratio} not in [0.5, 2]")
    act = sim.get_muscle_activation()
    want = muscle.waves_signal(
        torch.tensor(float(sim.step_count - 1))).numpy()
    d = float(np.abs(act - want).max())
    print(f"  muscle activation vs the wave model at t = "
          f"{sim.step_count - 1}: max|diff| {d:.2e}, max {act.max():.4f}",
          flush=True)
    check(d <= 1e-6 and act.max() > 0.0,
          f"muscle activation off the wave model by {d}")


def pair_records(kernels):
    """``pk.LAUNCHES`` key -> the device records of the pair kernels among
    ``kernels`` (device name -> records): ``spring_list`` is the spring
    kind; a ``pair_ring`` or ``pair_pass`` kernel's kind is its functor's,
    with ``_sub`` where its Gated template argument (pair_pass's second,
    pair_ring's seventh) is true."""
    out = {}
    for name, n in kernels.items():
        if "spring_list" in name:
            key = "spring"
        else:
            m = re.search(r"(pair_ring|pair_pass)<(?:\(anonymous "
                          r"namespace\)::)?([^>]*)>", name)
            if m is None:
                continue
            args = [a.strip() for a in m.group(2).split(",")]
            gated = args[6 if m.group(1) == "pair_ring" else 1] == "true"
            key = FUNCTOR_KIND[args[0]] + ("_sub" if gated else "")
        out[key] = out.get(key, 0) + n
    return out


def session_tail():
    """A CUDA graph of ``TAIL_KERNELS`` spin kernels (``torch.cuda._sleep``)
    that ``profile`` replays after the profiled steps: a session can lose
    its last kernel records when it stops (phase 20 found the pair-kernel
    records of a session's last 1 to ~4.5 steps missing, and only those,
    in 3 of 9 whole-script runs), and then the records lost are the
    tail's, which ``profile`` leaves out of every count and sum."""
    if not SESSION_TAIL:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(TAIL_KERNELS):
                torch.cuda._sleep(TAIL_CYCLES)
        SESSION_TAIL.append(graph)
    return SESSION_TAIL[0]


def profile(sim, steps, card):
    """``steps`` main-path steps under torch.profiler: device busy share,
    the pair kernels' share of device time, top device and host ops, the
    kernel and graph launch calls a step. Returns the wall ms a step, (calls,
    host us) a step of each launch call (``LAUNCH_APIS``), the pair
    kernels' device records by launch key (``pair_records``), and the busy
    ms a step and idle share, None where the profiler recorded no kernel.
    The session ends with ``session_tail``'s replay, left out of all of
    these: its kernels, and its graph launch call (the session's last)
    with that call's host time."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    tail = session_tail()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.step(steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        tail.replay()
        torch.cuda.synchronize()
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events
               if e.device_type == cuda and "spin_kernel" not in e.key]
    host = [e for e in events if e.device_type != cuda]
    dev_us = sum(e.self_device_time_total for e in kernels)
    pair_us = sum(e.self_device_time_total for e in kernels
                  if "pair_pass" in e.key or "pair_ring" in e.key)
    print(f"profile: {steps} steps, wall {wall_us / steps / 1e3:.4f} "
          f"ms/step (profiler on) [{card}]", flush=True)
    out = dict(wall_ms=wall_us / steps / 1e3, busy_ms=None, idle=None,
               pairs=pair_records({e.key: e.count for e in kernels}))
    tail_launch = max((e for e in prof.events()
                       if e.name.startswith("cudaGraphLaunch")),
                      key=lambda e: e.time_range.start, default=None)
    for api in LAUNCH_APIS:
        calls = [e for e in host if e.key.startswith(api)]
        tail = ((1, tail_launch.self_cpu_time_total)
                if api == "cudaGraphLaunch" and tail_launch else (0, 0.0))
        out[api] = ((sum(e.count for e in calls) - tail[0]) / steps,
                    (sum(e.self_cpu_time_total for e in calls) - tail[1])
                    / steps)
        print(f"  {api}: {out[api][0]:.2f} calls/step, {out[api][1]:.1f} "
              "us/step of host", flush=True)
    if dev_us == 0:
        print("  device time: not measured (the profiler recorded no CUDA "
              "kernels)", flush=True)
        return out
    out.update(busy_ms=dev_us / steps / 1e3, idle=1.0 - dev_us / wall_us)
    print(f"  device busy {dev_us / steps / 1e3:.4f} ms/step = "
          f"{dev_us / wall_us:.3f} of wall; pair kernels "
          f"{pair_us / steps / 1e3:.4f} ms/step = {pair_us / dev_us:.3f} "
          f"of device time; {len(kernels)} kernel names", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / steps:10.1f} us/step "
              f"{e.count / steps:6.1f} launches/step  {e.key[:90]}",
              flush=True)
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"  host {e.self_cpu_time_total / steps:10.1f} us/step "
              f"{e.count / steps:6.1f} calls/step  {e.key[:90]}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="main-path steps to run under torch.profiler "
                         "after the last phase (0: none)")
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run alone while "
                         f"iterating ({', '.join(PHASES)}); the run then "
                         "prints no result and exits 2")
    args = ap.parse_args(argv)
    only = [s for s in args.only.split(",") if s] or list(PHASES)
    check(set(only) <= set(PHASES), f"--only {only}")

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card = card_line()
    name = torch.cuda.get_device_name(0)
    # one parallel CPU op before the cpu-side engine runs: the first
    # parallel op of a process that takes a square root has returned
    # low-precision results in one thread's chunk on some hosts
    torch.rand(1 << 20).mul_(2.0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device 0: {name}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    so, log = _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {so.name}",
          flush=True)
    BUILD_REPORT[:] = ptxas_report(log)
    print_build_report(BUILD_REPORT, "build")

    results = {}
    for key, phase in PHASES.items():
        if key in only:
            t0 = time.perf_counter()
            results[key] = phase(card, args.profile_steps)
            print(f"phase {key}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
    if PROFILE_SIM:
        profile(PROFILE_SIM.pop(), args.profile_steps, card)
    if len(results) < len(PHASES):
        print(f"chip_smoke: only {sorted(results)} ran, no result",
              file=sys.stderr)
        return 2
    # each kernel's entry comes from the path that runs it at its main
    # shapes; launches a step on every path beside it
    kernels, per_path = {}, {}
    for res in results.values():
        if res:
            kernels.update(res["kernels"])
            per_path.update(res["launches"])
    for res in results.values():       # the A/B's numbers beside them
        for key, add in (res or {}).get("extra", {}).items():
            kernels[key].update(add)
    for key, entry in kernels.items():
        entry["launches_per_step"] = {
            path: n for path, counts in per_path.items()
            if (n := counts.get(key, 0))}
        check(entry["launches"] > 0, f"{key}: no launch on its path")
    # each shape's entry beside its kernel's (rho_star_sw after rho_star)
    names = list(kernels)
    order = sorted(names, key=lambda k: names.index(
        k.removesuffix("_sw") if k.removesuffix("_sw") in names else k)
        + 0.5 * k.endswith("_sw"))
    print(card, flush=True)
    print(json.dumps({"kernels": [kernels[k] for k in order]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def native_scenes(name):
    """sph_tpu's default scene ``name`` of ``NATIVE_SCENES``."""
    base = SimParams()
    if name == "worm":
        return generate_worm_scene(base)
    if name == "worm2":
        return generate_multi_worm_scene(N_WORMS, base)
    if name == "rworm":
        return generate_worm_scene(SimParams(**REDUCED_WORM))
    return generate_liquid_box_scene(
        base, fill_fraction=0.8 if name == "dam" else 0.15)


def native_phase(card, profile_steps):
    # 2b. the native scene builder on this host, and sph_tpu's default
    # scenes built on it
    from sph_tpu_torch.scene import native

    t0 = time.perf_counter()
    so = native.build()
    check(so is not None and native.available(),
          "native scene builder: no g++ on this host")
    print(f"native: {so.name} ready in {time.perf_counter() - t0:.2f} s "
          f"(g++ {' '.join(native.FLAGS)})", flush=True)
    for name, want in NATIVE_SCENES.items():
        t0 = time.perf_counter()
        scene = native_scenes(name)
        got = dict(scene.counts, n=scene.n_particles)
        print(f"native: {name} {got} in {time.perf_counter() - t0:.2f} s",
              flush=True)
        check(all(got[k] == v for k, v in want.items()),
              f"native {name}: {got}, sph_tpu's scene has {want}")
    return None


def settled_small_box(scene, small):
    """(state, springs, membranes) of the small box after SETTLE fastw steps
    on the card: its pool rests on the floor."""
    _, layout, cfg, ws = scene_setup(scene, small, "cuda")
    state, springs, membranes = scene.device_state("cuda")
    state = W.make_fastw_multi_step(small, layout, cfg, SETTLE,
                                    wall_static=ws)(
        state, springs, membranes)
    return state, springs, membranes


def small_box_phases(card, profile_steps):
    # 3. kernel vs plain on the small box, from its resting pool
    print("kernel vs plain:", flush=True)
    small = SimParams(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    scene = generate_liquid_box_scene(small, fill_fraction=0.5)
    _, layout, cfg, ws = scene_setup(scene, small, "cuda")
    state, springs, membranes = settled_small_box(scene, small)
    compare(record_step_inputs(small, layout, cfg, ws, state, springs,
                               membranes), "small", box_edge(small))

    # 4. engine vs plain, from the settled state kicked gently
    print("engine vs plain (8h box, 10 steps from the settled state kicked "
          "down at 0.3 m/s):", flush=True)
    engine_vs_plain(scene, small, kicked(state, speed=0.3, noise=0.05),
                    springs, membranes)


def box_phases(card, profile_steps):
    # 5. the liquid-box path
    params = SimParams()
    scene = generate_liquid_box_scene(params)
    sim = Simulator(scene, params, engine="auto", device="cuda")
    check(sim.engine == "fastw", f"auto resolved to {sim.engine}")
    n = scene.n_particles
    print(f"box path: {scene.counts}, n {n}, engine {sim.engine}, "
          f"cfg {sim._fast_cfg}", flush=True)
    sim.step(BOX_WARMUP)
    dt, launches = timed_run(sim, BOX_STEPS)
    ms_step = dt * 1e3 / BOX_STEPS
    ovf = check_run(sim, scene, BOX_STEPS, launches, PER_STEP_BOX, "box")
    pos = sim.get_position()
    l0, l1 = sim.layout.liquid_range
    lo, hi = np.asarray(params.box_min), np.asarray(params.box_max)
    check(bool(((pos[l0:l1] >= lo) & (pos[l0:l1] <= hi)).all()),
          "liquid left the box")
    print(f"box path: {BOX_STEPS} steps in {dt:.3f} s: {ms_step:.4f} "
          f"ms/step, {n * 1e3 / ms_step:.6g} particle-steps/s, window drift "
          f"{ovf['window_drift_h']:.4f} h, launches {launches} [{card}]",
          flush=True)

    # 6. kernel vs plain at the box's shapes, from its final state
    calls = record_step_inputs(params, sim.layout, sim._fast_cfg,
                               sim._wall_static, sim.state, sim.springs,
                               sim.membranes)
    compare(calls, "box", box_edge(params))
    stash_ab("box", calls, {n: PASSES[n][1] for n in calls})
    for pname, (p, tables, own, slab, *_) in sorted(calls.items()):
        ms = time_ms(lambda: p.kernel(tables, own, slab), 20)
        plain_ms = time_ms(lambda: p.plain(tables, own, slab), 3)
        print(f"  box   {pname:8s} kernel {ms:9.4f} ms  plain "
              f"{plain_ms:9.3f} ms  (x{PASSES[pname][1]}/step) [{card}]",
              flush=True)


def reduced_worm():
    """The reduced worm stepped WORM_SETTLE steps on the card: (scene,
    params, layout, cfg, wall static, state, springs, membranes)."""
    params = SimParams(**REDUCED_WORM)
    scene = generate_worm_scene(params)
    _, layout, cfg, ws = scene_setup(scene, params, "cuda")
    check(layout.springs_elastic_only, "reduced worm anchors to the walls")
    print(f"reduced worm: {scene.counts}, spring slots "
          f"{layout.spring_slots}, cfg {cfg}", flush=True)
    state, springs, membranes = scene.device_state("cuda")
    state, diag = W.make_fastw_multi_step(
        params, layout, cfg, WORM_SETTLE, return_diag=True, wall_static=ws)(
        state, springs, membranes)
    check(int(diag["shell_overflow"]) == 0
          and int(diag["tile_overflow"]) == 0, f"overflow: {diag}")
    check(bool(torch.isfinite(state.pos).all()), "reduced worm not finite")
    return scene, params, layout, cfg, ws, state, springs, membranes


def reduced_worm_kernels(card, profile_steps):
    # 7. kernel vs plain on the reduced worm, muscles active
    _, params, layout, cfg, ws, state, springs, membranes = reduced_worm()
    calls = record_step_inputs(params, layout, cfg, ws, state, springs,
                               membranes)
    elastic_input_counts(params, calls, "rworm")
    compare(calls, "rworm", box_edge(params))


def reduced_worm_engine(card, profile_steps):
    # 8. engine vs plain on the reduced worm
    scene, params, _, _, _, state, springs, membranes = reduced_worm()
    print(f"engine vs plain (reduced worm, 10 steps from step "
          f"{WORM_SETTLE}):", flush=True)
    engine_vs_plain(scene, params, state, springs, membranes,
                    kind=ELASTIC_PARTICLE, what="elastic")


def worm_phases(card, profile_steps):
    # 9. main path: the full worm
    params = SimParams()
    t0 = time.perf_counter()
    scene = generate_worm_scene(params)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim = Simulator(scene, params, engine="auto", device="cuda")
    t_init = time.perf_counter() - t0
    check(sim.engine == "fastw", f"auto resolved to {sim.engine}")
    n = scene.n_particles
    print(f"main path: {scene.counts}, n {n}, generated in {t_gen:.1f} s, "
          f"simulator built in {t_init:.1f} s, engine {sim.engine}, spring "
          f"slots {sim.layout.spring_slots}, cfg {sim._fast_cfg}",
          flush=True)
    # warm-up period. The worm's inner liquid is packed at 0.85 r0 and
    # expands: over 30 steps some particles move more than the shell's one
    # cell. step(n) below one period re-sorts at every step, which keeps
    # every wall within reach captured from step 0.
    sim.step(sim._fast_cfg.resort_every - 1)
    sim.step(1)
    warm = check_capture(sim, "worm warm-up")
    print(f"main path: warm-up period, re-sorted every step: window drift "
          f"{warm['window_drift_h']:.4f} h", flush=True)
    # one whole period more: the capture of its graph is set-up, untimed
    sim.step(sim._fast_cfg.resort_every)
    dt, launches = timed_run(sim, WORM_STEPS)
    MAIN_BOX_LAUNCHES[0] = BOX_LAUNCHED[0]
    ms_step = dt * 1e3 / WORM_STEPS
    ovf = check_run(sim, scene, WORM_STEPS, launches, PER_STEP, "worm")
    worm_integrity(sim, scene, params)
    print(f"main path: {WORM_STEPS} steps in {dt:.3f} s: {ms_step:.4f} "
          f"ms/step, {n * 1e3 / ms_step:.6g} particle-steps/s, window drift "
          f"{ovf['window_drift_h']:.4f} h (shell bound "
          f"{2 * (sim._fast_cfg.dilate - 1)} h), launches {launches} "
          f"[{card}]", flush=True)
    if profile_steps > 0:       # profiled after the last phase (main)
        PROFILE_SIM.append(sim)

    # 10. kernel vs plain at the main path's shapes, from its final state
    calls = record_step_inputs(params, sim.layout, sim._fast_cfg,
                               sim._wall_static, sim.state, sim.springs,
                               sim.membranes)
    data_work = elastic_input_counts(params, calls, "worm")
    print(f"  worm  data-dependent work: {data_work['spring']} springs "
          f"listed, {data_work['membrane']} own-column pairs within r0",
          flush=True)
    spring, spr_list = calls["spring_ms"][:2]
    kept, merged, cols, rows = spring_list_work(spring, spr_list,
                                                calls["spring_ms"][2])
    print(f"  worm  spring list: {kept} entries kept of {data_work['spring']}"
          f" listed slots, {merged} merged columns, {cols} columns, {rows} "
          f"rows with springs; membrane launch "
          f"{calls['mem_ms'][0].shared_bytes} B of dynamic shared memory",
          flush=True)
    far = box_edge(params)
    errs = compare(calls, "worm", far)
    stash_ab("worm", calls, {n: PASSES[n][1] for n in calls})
    per_kind = {k: dict(err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                        ops_ms=0.0) for k in PER_STEP}
    for pname, (p, tables, own, slab, *_) in sorted(calls.items()):
        kind, mult = PASSES[pname]
        ms = time_ms(lambda: p.kernel(tables, own, slab), 20)
        plain_ms = time_ms(lambda: p.plain(tables, own, slab), 3)
        pairs, bound_ms, by = pass_bound(p, tables, own, slab, far,
                                         data_work)
        print(f"  worm  {pname:9s} kernel {ms:9.4f} ms  plain "
              f"{plain_ms:9.3f} ms  bound {bound_ms:8.5f} ms ({by}, "
              f"{pairs:.4g} candidate pairs)  (x{mult}/step) [{card}]",
              flush=True)
        acc = per_kind[kind]
        acc["err"] = max(acc["err"], errs[pname])
        acc["ms"] += mult * ms
        acc["plain_ms"] += mult * plain_ms
        acc["bound_ms"] += mult * bound_ms
        acc["ops_ms"] += mult * bound_ms * (by == "operations")

    return dict(
        kernels=kernel_entries(per_kind, launches,
                               "one step's launches, fastw, full worm"),
        launches={"worm_fastw": {k: v / WORM_STEPS for k, v in (
            launches | {"chunk_boxes": BOX_LAUNCHED[0]}).items()}})


def kernel_entries(per_kind, launches, scope):
    """name -> the ``kernels`` JSON entry of each kernel kind accumulated
    in ``per_kind`` (err, ms, plain_ms, bound_ms, ops_ms over one step's
    launches). No single PyTorch call computes a windowed pair sum:
    library_ms is null."""
    return {kind: dict(
        name=kind, route="cuda", source=SOURCE, replaces=REPLACES[kind],
        launches=launches[kind], max_abs_err=acc["err"], ms=acc["ms"],
        plain_ms=acc["plain_ms"], bound_ms=acc["bound_ms"],
        bound_by=("operations" if 2 * acc["ops_ms"] >= acc["bound_ms"]
                  else "bytes"),
        library_ms=None, ms_scope=scope,
        registers=_regs(shipped_kernel(kind.removesuffix("_sub"),
                                       kind.endswith("_sub"))),
    ) for kind, acc in per_kind.items()}


def _regs(report_entry):
    return report_entry["regs"] if report_entry else None


# ---------------------------------------------------------------------------
# the fast engine (phases 11-15)
# ---------------------------------------------------------------------------

def record_fast_inputs(params, layout, cfg, state, springs, membranes):
    """(pass, tables, own, slab, rows the engine uses) of the last call of
    each pair pass in one sort + one step of the fast engine from ``state``:
    the liquid passes from the kicked state (see ``kicked``), spring and
    membrane from ``state`` as it is. The engine uses the force passes'
    sums (viscsurf, paccel, boundary) on rows that are not walls (it zeroes
    wall accelerations and pins walls: a wall row's surface sum counts pairs
    of walls exactly h apart, where f32 roundings may differ), the membrane
    sums on liquid rows, density and rho* on every row."""
    parts = F._make_step_parts(params, layout, cfg)
    ctx = {}
    calls = F.record_step_inputs(
        parts, kicked(state, rest_gap=REST_GAP * params.h), springs,
        membranes, ctx_out=ctx)
    not_wall = ctx["isb_s"][:cfg.n_pad] == 0
    for name in ("viscsurf", "paccel", "boundary"):
        calls[name] += (not_wall,)
    expect = {"density", "rho_star", "viscsurf", "paccel", "boundary"}
    if layout.n_elastic > 0:
        still_ctx = {}
        still = F.record_step_inputs(parts, state, springs, membranes,
                                     ctx_out=still_ctx)
        calls["membrane"] = still["membrane"] + (
            still_ctx["liq_s"][:cfg.n_pad] > 0,)
        expect.add("membrane")
        if "spring" in still:
            calls["spring"] = still["spring"]
            expect.add("spring")
    check(set(calls) == expect, f"passes called: {sorted(calls)}")
    return calls


def gated_vs_ungated(calls, label):
    """The gated kernels of the sort-time passes (density, viscsurf,
    paccel: every position they read is a sort-time one) against their
    ungated kernels on the same inputs: max |diff| and the rows that
    differ."""
    for name in ("density", "viscsurf", "paccel"):
        p, tables, own, slab = calls[name][:4]
        g = p.kernel(tables, own, slab)
        u = dataclasses.replace(p, sub=None).kernel(tables[:6], own, slab)
        g, u = (o if isinstance(o, tuple) else (o,) for o in (g, u))
        diff = torch.stack([(a - b).abs() for a, b in zip(g, u)]).amax(0)
        print(f"  {label:5s} {name:9s} gated vs ungated (sub {p.sub}): "
              f"max|diff| {float(diff.max()):.3e}, rows that differ "
              f"{int((diff > 0).sum())} of {p.n_pad}", flush=True)


def time_passes(calls, errs, far, card, label, data_work=None,
                plain_reps=3):
    """Kernel (CUDA events, 20 launches) and plain times, bound and
    computed columns per particle of each recorded fast-engine pass;
    returns launch key -> one step's totals (``kernel_entries``)."""
    per_kind = {}
    for name, (p, tables, own, slab, *_) in sorted(calls.items()):
        mult = FAST_PASSES[name]
        ms = time_ms(lambda: p.kernel(tables, own, slab), 20)
        plain_ms = time_ms(lambda: p.plain(tables, own, slab), plain_reps,
                           warm=plain_reps > 1)
        pairs, bound_ms, by = pass_bound(p, tables, own, slab, far,
                                         data_work)
        rows = computed_pairs(p, tables, own, far)[1]
        print(f"  {label:5s} {name:9s} {p.launch_key:12s} kernel {ms:9.4f} "
              f"ms  plain {plain_ms:9.3f} ms  bound {bound_ms:8.5f} ms "
              f"({by}, {pairs:.4g} candidate pairs, {pairs / rows:.1f} "
              f"columns a particle)  (x{mult}/step) [{card}]", flush=True)
        acc = per_kind.setdefault(p.launch_key, dict(
            err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0))
        acc["err"] = max(acc["err"], errs[name])
        acc["ms"] += mult * ms
        acc["plain_ms"] += mult * plain_ms
        acc["bound_ms"] += mult * bound_ms
        acc["ops_ms"] += mult * bound_ms * (by == "operations")
    return per_kind


def check_fast_run(sim, scene, steps, launches, per_step, label):
    """A fast-engine path's checks: finite state, walls bitwise still, no
    tile overflow, every launch key at exactly its count a step (others
    0). Returns the overflow report (read and reset)."""
    pos, vel = sim.get_position(), sim.get_velocity()
    check(np.isfinite(pos).all() and np.isfinite(vel).all(),
          f"{label}: non-finite state")
    b0, b1 = sim.layout.boundary_range
    check(np.array_equal(pos[b0:b1], scene.pos[b0:b1]),
          f"{label}: walls moved")
    ovf = sim.check_overflow()
    check(ovf["tile_overflow"] == 0, f"{label}: overflow {ovf}")
    for key, n in launches.items():
        want = per_step.get(key, 0) * steps
        check(n == want, f"{label} {key}: {n} launches in {steps} steps, "
              f"expected {want}")
    return ovf


def first_period(sim, label):
    """The first resort period in single-step chunks (a sort every step:
    a fresh scene's start-up transient moves particles most); prints its
    window drift."""
    r = sim._fast_cfg.resort_every
    sim.step(r - 1)
    sim.step(1)
    ovf = sim.check_overflow()
    print(f"{label}: first {r} steps re-sorted every step: window drift "
          f"{ovf['window_drift_h']:.4f} h", flush=True)


def spring_strain(pos, scene, params):
    """(max strain of the springs between elastic particles, max strain of
    the springs anchored to walls or None)."""
    idx = scene.spring_idx
    used = idx >= 0
    rows = np.repeat(scene.spring_rows, idx.shape[1])[used.ravel()]
    cols = idx[used]
    r = np.linalg.norm(pos[rows] - pos[cols], axis=1) * params.simulation_scale
    rest = scene.spring_rest[used]
    strain = np.abs(r - rest) / np.maximum(rest, 1e-9)
    wall = scene.ptype[cols] == BOUNDARY_PARTICLE
    return (float(strain[~wall].max()),
            float(strain[wall].max()) if wall.any() else None)


def small_fast_phases(card, profile_steps):
    # 11. kernel vs plain, the small box on the fast engine, every pass of
    # one step ungated and gated
    small = SimParams(x_max=8 * H, y_max=8 * H, z_max=8 * H)
    scene = generate_liquid_box_scene(small, fill_fraction=0.5)
    state, springs, membranes = settled_small_box(scene, small)
    far = box_edge(small)
    print("fast engine, kernel vs plain (8h box, block 128, ccol 128):",
          flush=True)
    for sub in SUBS:
        cfg = F.compute_fast_config(scene.pos, small, block=128, ccol=128,
                                    sub=sub)
        calls = record_fast_inputs(small, scene.layout(), cfg, state,
                                   springs, membranes)
        compare(calls, f"s{sub}", far)
        if sub:
            gated_vs_ungated(calls, f"s{sub}")

    # 12. the fast engine on cuda vs cpu, from the settled state kicked
    # gently
    print("fast engine vs plain (8h box, 10 steps from the settled state "
          "kicked down at 0.3 m/s):", flush=True)
    engine_vs_plain(scene, small, kicked(state, speed=0.3, noise=0.05),
                    springs, membranes, engine="fast",
                    configs=[dict(block=128, ccol=128, resort_every=r,
                                  sub=sub)
                             for r in (1, 3) for sub in (None, 32)])


def tiny_worm_phases(card, profile_steps):
    # 13. the wall-anchored worm: auto picks the fast engine, whose springs
    # take the gather fallback
    params = SimParams(**TINY_WORM)
    scene = generate_worm_scene(params)
    sim = Simulator(scene, params, engine="auto", device="cuda")
    check(sim.engine == "fast", f"auto resolved to {sim.engine}")
    check(not sim.layout.springs_elastic_only,
          "the worm's springs do not anchor to walls")
    print(f"wall-anchored worm: {scene.counts}, n {scene.n_particles}, "
          f"engine {sim.engine}, cfg {sim._fast_cfg}", flush=True)
    first_period(sim, "wall-anchored worm")
    steps = TINY_SETTLE - sim._fast_cfg.resort_every
    dt, launches = timed_run(sim, steps)
    per_step = dict(PER_STEP_DAM, membrane=1)
    ovf = check_fast_run(sim, scene, steps, launches, per_step,
                         "wall-anchored worm")
    body, anchors = spring_strain(sim.get_position(), scene, params)
    print(f"wall-anchored worm at step {sim.step_count}: {dt * 1e3 / steps:.4f}"
          f" ms/step, window drift {ovf['window_drift_h']:.4f} h, launches "
          f"{launches}; max strain {body:.4f} (springs between elastic "
          f"particles, < 0.5), {anchors:.4f} (springs anchored to walls, "
          f"< 1) [{card}]", flush=True)
    check(body < 0.5, f"max strain {body} >= 0.5 on the worm's springs")
    check(anchors < 1.0, f"max strain {anchors} >= 1 on the wall anchors")

    # the fallback's accelerations on the card against the cpu
    st = sim.state
    a_cu = elastic_accel(st.pos, sim.springs, st.muscle_activation, params)
    a_cpu = elastic_accel(st.pos.cpu(), to_device(sim.springs, "cpu"),
                          st.muscle_activation.cpu(), params)
    d = float((a_cu.cpu() - a_cpu).abs().max())
    top = float(a_cpu.abs().max())
    print(f"  elastic_accel cuda vs cpu: max|diff| {d:.3e}, max|a| "
          f"{top:.3e} ({scene.counts['springs']} springs)", flush=True)
    check(top > 0.0 and d <= KERNEL_TOL * top,
          f"elastic_accel cuda vs cpu {d} > {KERNEL_TOL} * {top}")

    print(f"fast engine vs plain (wall-anchored worm, 10 steps from step "
          f"{sim.step_count}):", flush=True)
    engine_vs_plain(scene, params, st, sim.springs, sim.membranes,
                    kind=ELASTIC_PARTICLE, what="elastic", engine="fast",
                    configs=[dict(resort_every=10)])
    return dict(kernels={}, launches={"tiny_worm_fast": {
        k: v / steps for k, v in launches.items()}})


def dam_break_phases(card, profile_steps):
    # 14. the dam-break: the 918k-particle single-card configuration
    params = SimParams()
    t0 = time.perf_counter()
    scene = generate_liquid_box_scene(params, fill_fraction=0.8)
    sim = Simulator(scene, params, engine="auto", device="cuda")
    check(sim.engine == "fast", f"auto resolved to {sim.engine}")
    n = scene.n_particles
    print(f"dam-break: {scene.counts}, n {n}, engine {sim.engine}, cfg "
          f"{sim._fast_cfg}, set up in {time.perf_counter() - t0:.1f} s",
          flush=True)
    sim.step(DAM_WARMUP)
    warm = sim.check_overflow()
    dt, launches = timed_run(sim, DAM_STEPS)
    ms_step = dt * 1e3 / DAM_STEPS
    ovf = check_fast_run(sim, scene, DAM_STEPS, launches, PER_STEP_DAM,
                         "dam-break")
    pos = sim.get_position()
    l0, l1 = sim.layout.liquid_range
    lo, hi = np.asarray(params.box_min), np.asarray(params.box_max)
    check(bool(((pos[l0:l1] >= lo) & (pos[l0:l1] <= hi)).all()),
          "liquid left the box")
    print(f"dam-break: {DAM_STEPS} steps in {dt:.3f} s: {ms_step:.4f} "
          f"ms/step, {n * 1e3 / ms_step:.6g} particle-steps/s, window drift "
          f"{warm['window_drift_h']:.4f} h (warm-up period), "
          f"{ovf['window_drift_h']:.4f} h (timed), launches {launches} "
          f"[{card}]", flush=True)

    # kernel vs plain on the final state, timed at those shapes (the plain
    # versions once each: they gather ~10^9 pairs a call)
    far = box_edge(params)
    calls = record_fast_inputs(params, sim.layout, sim._fast_cfg, sim.state,
                               sim.springs, sim.membranes)
    errs = compare(calls, "dam", far)
    per_kind = time_passes(calls, errs, far, card, "dam", plain_reps=1)
    fast_ab_inputs(params, sim, sim.state, "dam")
    return dict(
        kernels=kernel_entries({"density": per_kind["density"]}, launches,
                               "one step's launches, fast, dam-break"),
        launches={"dambreak_fast": {k: v / DAM_STEPS for k, v in (
            launches | {"chunk_boxes": BOX_LAUNCHED[0]}).items()}})


def fast_worm_phases(card, profile_steps):
    # 15. the full worm on the fast engine, TPU-tuned config, ungated and
    # gated at sub 32
    params = SimParams()
    scene = generate_worm_scene(params)
    sim = Simulator(scene, params, engine="fast", device="cuda",
                    fast_config=R4)
    print(f"fast worm: {scene.counts}, cfg {sim._fast_cfg}", flush=True)
    first_period(sim, "fast worm")
    sim.step(FAST_WORM_STEPS - sim._fast_cfg.resort_every)
    parts = F._make_step_parts(params, sim.layout, sim._fast_cfg)
    worm_integrity(sim, scene, params, parts)
    ovf = sim.check_overflow()
    print(f"fast worm: window drift {ovf['window_drift_h']:.4f} h after "
          "the first period", flush=True)

    # the same state, the gated config: 120 timed steps of each in turn
    sim32 = Simulator(scene, params, engine="fast", device="cuda",
                      fast_config=dict(R4, sub=32))
    runs, launches_by = {}, {}
    for label, s, per_step in (
            ("fast worm", sim, PER_STEP_FAST_WORM),
            ("fast worm sub 32", sim32,
             {k + "_sub" if k in pk.GATED else k: v
              for k, v in PER_STEP_FAST_WORM.items()})):
        if s is sim32:
            sim32.state = sim.state
            # one period first: its graph's capture is set-up, untimed
            sim32.step(sim32._fast_cfg.resort_every)
        dt, launches = timed_run(s, FAST_WORM_TIMED)
        check_fast_run(s, scene, FAST_WORM_TIMED, launches, per_step, label)
        runs[label] = dt * 1e3 / FAST_WORM_TIMED
        launches_by[label] = launches
        print(f"{label}: {FAST_WORM_TIMED} steps: {runs[label]:.4f} ms/step, "
              f"{scene.n_particles * 1e3 / runs[label]:.6g} particle-steps/s"
              f", launches {launches} [{card}]", flush=True)
    worm_integrity(sim32, scene, params, parts)

    far = box_edge(params)
    # what the gate saves at the TPU sweep's tile width and at this one:
    # computed columns a particle and kernel time of the density pass on
    # the final state's own sort
    for ccol in (128, R4["ccol"]):
        counts, times = [], []
        for sub in (None, 32):
            cfg = F.compute_fast_config(scene.pos, params, block=R4["block"],
                                        ccol=ccol, sub=sub)
            gparts = F._make_step_parts(params, sim.layout, cfg)
            ctx, _ = gparts.sort_ctx(sim32.state, sim.springs,
                                     sim.membranes)
            pack = F._pack(gparts.carry_of(ctx, sim32.state)[:3])
            p = gparts.passes["density"]
            pairs, rows = computed_pairs(p, ctx["rho_tables"], pack, far)
            counts.append(pairs / rows)
            times.append(time_ms(
                lambda: p.kernel(ctx["rho_tables"], pack, pack), 20))
        print(f"  fast worm, ccol {ccol}: density pass computes "
              f"{counts[0]:.1f} columns a particle ungated, {counts[1]:.1f} "
              f"at sub 32 ({counts[1] / counts[0]:.3f}); kernel "
              f"{times[0]:.4f} / {times[1]:.4f} ms [{card}]", flush=True)
    fast_ab_inputs(params, sim, sim32.state, "fast_worm")
    entries = {}
    for label, s in (("fworm", sim), ("fw32", sim32)):
        calls = record_fast_inputs(params, s.layout, s._fast_cfg, sim32.state,
                                   s.springs, s.membranes)
        data_work = elastic_input_counts(params, calls, label,
                                         names=("spring", "membrane"))
        errs = compare(calls, label, far)
        if s is sim32:
            gated_vs_ungated(calls, label)
        per_kind = time_passes(calls, errs, far, card, label, data_work)
        if s is sim32:
            entries = kernel_entries(
                {k: v for k, v in per_kind.items() if k.endswith("_sub")},
                launches_by["fast worm sub 32"],
                "one step's launches, fast, full worm, sub 32")
    return dict(kernels=entries, launches={
        "worm_fast": {k: v / FAST_WORM_TIMED
                      for k, v in launches_by["fast worm"].items()},
        "worm_fast_sub32": {k: v / FAST_WORM_TIMED for k, v in
                            launches_by["fast worm sub 32"].items()}})


# ---------------------------------------------------------------------------
# the exact engine, the bench and the glue path (phases 16-18)
# ---------------------------------------------------------------------------

def exact_phases(card, profile_steps):
    # 16a. the bench's gate box on the exact engine, cuda vs cpu
    p, scene = bench.gate_box_scene(SimParams())
    layout = scene.layout()
    print(f"exact engine vs plain cpu (gate box, {scene.n_particles} "
          f"particles, {EXACT_BOX_STEPS} steps):", flush=True)
    pos = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out = S.multi_step(*scene.device_state(dev), p, layout,
                           EXACT_BOX_STEPS)
        pos[dev] = out.pos.cpu().numpy()
        print(f"    {dev}: {time.perf_counter() - t0:.1f} s", flush=True)
    d = float(np.abs(pos["cuda"] - pos["cpu"]).max())
    moved = float(np.linalg.norm(pos["cpu"] - scene.pos, axis=1).max())
    print(f"  exact: max|dpos| cuda vs cpu {d:.3e}; largest displacement "
          f"{moved:.3e}", flush=True)
    check(np.isfinite(pos["cuda"]).all() and d <= ENGINE_TOL,
          f"exact engine cuda vs cpu max|dpos| {d} > {ENGINE_TOL}")
    check(moved > 100 * ENGINE_TOL, f"the gate box moved only {moved}")

    # 16b. the bench's box gate on the card: fastw and fast against exact
    for engine in ("fastw", "fast"):
        check(bench.gate_box_equivalence(SimParams(), engine=engine,
                                         device="cuda"),
              f"box gate {engine} vs exact failed on cuda")

    # 16c. the full worm on the exact engine
    params = SimParams()
    scene = generate_worm_scene(params)
    sim = Simulator(scene, params, engine="exact", device="cuda")
    n = scene.n_particles
    print(f"exact worm: {scene.counts}, n {n}, cell_capacity "
          f"{sim.params.cell_capacity} (scene-measured)", flush=True)
    sim.step(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dt, launches = timed_run(sim, EXACT_WORM_STEPS)
    peak = torch.cuda.max_memory_allocated()
    pos_w = sim.get_position()
    check(np.isfinite(pos_w).all() and np.isfinite(sim.get_velocity()).all(),
          "exact worm: non-finite state")
    b0, b1 = sim.layout.boundary_range
    check(np.array_equal(pos_w[b0:b1], scene.pos[b0:b1]),
          "exact worm: walls moved")
    check(not any(launches.values()),
          f"exact worm launched pair kernels: {launches}")
    ovf = sim.check_overflow()
    ms_step = dt * 1e3 / EXACT_WORM_STEPS
    print(f"exact worm: {EXACT_WORM_STEPS} steps in {dt:.3f} s: "
          f"{ms_step:.4f} ms/step, {n * 1e3 / ms_step:.6g} particle-steps/s,"
          f" peak memory {peak / 2**30:.3f} GiB, cell_overflow "
          f"{ovf['cell_overflow']} [{card}]", flush=True)

    # 16d. diagnostics on the full worm, as the bench's worm gate calls it
    for label, dparams in (("bench params", params),
                           ("scene-measured capacity", sim.params)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        diag = S.diagnostics(sim.state, dparams)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        rho = diag["rho"].cpu().numpy()
        l0, l1 = sim.layout.liquid_range
        check(np.isfinite(rho).all(), "diagnostics: rho not finite")
        print(f"  diagnostics ({label}, cell_capacity "
              f"{dparams.cell_capacity}): {dt * 1e3:.3f} ms, peak memory "
              f"{peak / 2**30:.3f} GiB, neighbor_overflow "
              f"{int(diag['neighbor_overflow'])}, cell_overflow "
              f"{int(diag['cell_overflow'])}, mean liquid rho/rho0 "
              f"{float(rho[l0:l1].mean()) / params.rho0:.4f}, mean "
              f"neighbours {float(diag['neighbor_count'].float().mean()):.2f}"
              f" [{card}]", flush=True)
    return None


def bench_phase(card, profile_steps):
    # 17. the port's bench in a subprocess: one JSON line, value > 0,
    # engine fastw, no reason, both gates PASS
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SPH_BENCH_")}
    env["SPH_BENCH_WATCHDOG_S"] = str(BENCH_WATCHDOG_S)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "sph_tpu_torch.bench"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=BENCH_WATCHDOG_S + 60)
    print(f"bench: exit {res.returncode} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in res.stderr.splitlines():
        print("  " + line, flush=True)
    lines = res.stdout.strip().splitlines()
    check(res.returncode == 0 and len(lines) == 1,
          f"bench: exit {res.returncode}, stdout {res.stdout!r}")
    rec = json.loads(lines[0])
    print(f"bench line: {json.dumps(rec)} [{card}]", flush=True)
    check(rec["value"] > 0 and rec["engine"] == "fastw"
          and "reason" not in rec, f"bench result {rec}")
    err = res.stderr
    for gate in ("GATE worm integrity", "GATE box fastw-vs-exact",
                 "GATE box stale-window"):
        ok = [ln for ln in err.splitlines() if gate in ln]
        check(len(ok) == 1 and ok[0].endswith("PASS"),
              f"bench {gate}: {ok}")
    # the timed steps went through the six fastw kernels
    counts = json.loads(err.split("# pair-kernel launches in the ")[1]
                        .split(": ", 1)[1].splitlines()[0])
    steps = int(err.split("# pair-kernel launches in the ")[1].split()[0])
    for kind, per in PER_STEP.items():
        check(counts.get(kind, 0) == per * steps,
              f"bench {kind}: {counts.get(kind, 0)} launches in {steps} "
              f"steps, expected {per * steps}")
    return None


def pack_phase(card, profile_steps):
    # 18. the Pack kernel against its plain version, then the glue path
    from sph_tpu_torch.ops import pack as pack_ops
    from sph_tpu_torch.scripts import r4_glue_micro as glue

    err = 0.0
    for n in (glue.N, glue.N + 13):
        fields = glue.make_fields(n, seed=1)
        k = pack_ops.pack_kernel(fields)
        r = pack_ops.pack_plain(fields)
        torch.cuda.synchronize()
        err = max(err, float((k - r).abs().max()))
        check(torch.equal(k, r), f"Pack kernel != torch.stack at n {n}")
        print(f"  pack n {n}: kernel == plain bitwise", flush=True)

    # the glue path: launches and pack() calls counted over its run
    calls = [0]

    def counted(fields):
        calls[0] += 1
        return pack_ops.pack(fields)

    glue_pack = glue.pack
    glue.pack = counted
    torch.cuda.synchronize()
    pack_ops.LAUNCHES["pack"] = 0
    try:
        times = glue.run()
    finally:
        glue.pack = glue_pack
    launches = pack_ops.LAUNCHES["pack"]
    check(launches > 0 and launches == calls[0],
          f"glue path: {launches} Pack launches for {calls[0]} pack calls")
    print(f"glue path (n {glue.N}, {glue.ROWS} rows, {glue.REPS} calls a "
          f"candidate; D == A bitwise) [{card}]:", flush=True)
    for name, ms in times.items():
        print(f"  {name:44s} {ms:9.5f} ms", flush=True)

    fields = glue.make_fields(glue.N)
    ms = glue.time_ms(lambda: pack_ops.pack_kernel(fields))
    plain_ms = glue.time_ms(lambda: pack_ops.pack_plain(fields))
    library_ms = glue.time_ms(lambda: torch.stack(fields, 0))
    nbytes = 2 * glue.ROWS * glue.N * 4
    bound_ms = nbytes / PEAK_BYTES_S * 1e3
    print(f"  pack kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, torch.stack "
          f"{library_ms:.5f} ms, bound {bound_ms:.5f} ms ({nbytes} bytes); "
          f"CUDA events around {glue.REPS} back-to-back calls [{card}]",
          flush=True)
    # device times: inputs warm in L2 (back-to-back calls leave them there:
    # 15 MB of a 50 MB L2), then cold, as the glue path's caller finds them
    # after a step's pair passes: a 256 MB buffer written before every call
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    dev, cold = ([device_ms(f, flush=fl) for f in (
        lambda: pack_ops.pack_kernel(fields),
        lambda: torch.stack(fields, 0))] for fl in (None, flush))
    del flush
    for what, ts in (("L2 warm", dev), ("L2 flushed", cold)):
        print(f"  device time a call (torch.profiler, 50 calls, {what}): "
              "pack kernel " + ", torch.stack ".join(
                  "not measured" if t is None else f"{t:.5f} ms"
                  for t in ts)
              + f"; bound {bound_ms:.5f} ms [{card}]", flush=True)
    entry = dict(
        name="pack", route="cuda", source="sph_tpu_torch/ops/csrc/pack.cu",
        replaces="scripts/r4_glue_micro.py:48", launches=launches,
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes", library_ms=library_ms,
        ms_scope=(f"one call, {glue.ROWS} rows x {glue.N}, CUDA events "
                  f"around {glue.REPS} calls (host dispatch included)"),
        device_ms=cold[0], library_device_ms=cold[1],
        device_ms_l2_warm=dev[0], library_device_ms_l2_warm=dev[1],
        # the glue's n is a multiple of 4: the float4 instantiation
        registers=_regs(next((r for r in BUILD_REPORT
                              if r["key"] == ("pack_rows", "float4")), None)))
    return dict(kernels={"pack": entry},
                launches={"glue_per_pack_call": {"pack": launches
                                                 / calls[0]}})


# ---------------------------------------------------------------------------
# the ring driver: build report, in-call A/B against the first design
# (phase 19)
# ---------------------------------------------------------------------------

FUNCTORS = {"density": "Density", "rho_star": "RhoStar",
            "viscsurf": "ViscSurf", "paccel": "PAccel",
            "boundary": "Boundary", "spring": "Spring",
            "membrane": "Membrane"}
# inputs of the redesigned kernels (the ring kinds and the spring list),
# label -> {name: (call, launches a step)}, filled by the phases that record
# them (5, 10, 14, 15); phase 19 records what is missing from one resort
# period of the path (``--only ab``)
AB_INPUTS = {}
# the dam-break's (sim, state) its ring inputs were recorded from
AB_DAM_SIM = [None]
AB_LABELS = ("worm", "box", "dam", "fast_worm")
AB_KINDS = (*pk.RING, "spring")
AB_REPS = 20
# the box kernel's launches in the last timed_run; the worm main path's
BOX_LAUNCHED = [0]
MAIN_BOX_LAUNCHES = [0]
# the ptxas report of the library (filled in main)
BUILD_REPORT = []
# the main path's simulator, profiled after the last phase (--profile-steps)
PROFILE_SIM = []


def describe(mangled):
    """(driver, kind, label) of a kernel from its mangled name."""
    driver = next((d for d in ("pair_ring", "pair_pass", "spring_list",
                               "pack_rows", "pair_ring_boxes")
                   if f"{len(d)}{d}" in mangled), "?")
    kind = next((k for k, f in FUNCTORS.items() if f"{len(f)}{f}" in mangled),
                "")
    ints = [int(x) for x in re.findall(r"Li(\d+)E", mangled)]
    bools = [int(x) for x in re.findall(r"Lb([01])E", mangled)]
    if driver == "pair_ring" and len(ints) >= 5 and len(bools) >= 2:
        label = (f"pair_ring<{FUNCTORS[kind]}, R {ints[0]}, TPR {ints[1]}, "
                 f"stages {ints[2]}, rows/CTA {ints[3]}, exit {bools[0]}, "
                 f"gated {bools[1]}, chunk {ints[4]}>")
        # the unculled form (chunk 0) apart from the shipped kernel
        key = (kind, bools[1]) if ints[4] else (kind, bools[1], "nocull")
    elif driver == "pair_pass" and bools:
        label = f"pair_pass<{FUNCTORS[kind]}, gated {bools[0]}>"
        key = (kind, bools[0])
    elif driver == "spring_list":
        label, key = "spring_list<Spring>", ("spring", 0)
    elif driver == "pair_ring_boxes" and ints:
        label, key = f"pair_ring_boxes<chunk {ints[0]}>", (driver,)
    elif driver == "pack_rows":
        elem = "float4" if "6float4" in mangled else "float"
        label, key = f"pack_rows<{elem}>", (driver, elem)
    else:
        label, key = driver, (driver,)
    return dict(driver=driver, kind=kind, label=label, key=key)


def ptxas_report(log):
    """[dict(mangled, driver, kind, label, key, regs, smem, stack,
    spill_st, spill_ld)] of each kernel in an ``-Xptxas -v`` log."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = dict(mangled=m[1], regs=None, smem=0, stack=None,
                       spill_st=None, spill_ld=None, **describe(m[1]))
            out.append(cur)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m and cur is not None and m[1] != cur["mangled"]:
            cur = None   # a device function's report, not the kernel's
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m[1]), spill_st=int(m[2]),
                       spill_ld=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["regs"] = int(m[1])
            m2 = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(m2[1]) if m2 else 0
    return out


def shipped_kernel(kind, gated):
    """The ptxas entry of the kernel that kind's entry point launches (the
    ring driver's for the kinds in ``pk.RING``, the list kernel's for the
    spring pass)."""
    driver = ("pair_ring" if kind in pk.RING else
              "spring_list" if kind == "spring" else "pair_pass")
    return next((r for r in BUILD_REPORT if r["driver"] == driver
                 and r["key"] == (kind, int(gated))), None)


def print_build_report(report, label):
    print(f"  {label}: registers, shared memory and spills of each kernel "
          "(-Xptxas -v):", flush=True)
    for r in sorted(report, key=lambda r: r["label"]):
        print(f"    {r['label']:58s} {r['regs']} registers, {r['smem']} B "
              f"static smem, {r['stack']} B stack, {r['spill_st']}/"
              f"{r['spill_ld']} B spill stores/loads", flush=True)


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def stash_ab(label, calls, mults):
    AB_INPUTS[label] = {name: (c, mults[name]) for name, c in calls.items()
                        if c[0].kind in AB_KINDS}


def fast_ab_inputs(params, sim, state, label):
    """The fast engine's density (the time-t density and rho* on the
    iteration pack), viscsurf and paccel launches on ``state``, ungated and
    at sub 8/16/32 (the sim's config otherwise), and its boundary, spring
    and membrane launches (ungated kernels) where the scene has them."""
    out = {}
    for sub in SUBS:
        cfg = dataclasses.replace(sim._fast_cfg, sub=sub)
        calls = record_fast_inputs(params, sim.layout, cfg, state,
                                   sim.springs, sim.membranes)
        for kind in ("density", "rho_star", "viscsurf", "paccel"):
            out[f"{kind}_s{sub}" if sub else kind] = (
                calls[kind], FAST_PASSES[kind])
        if sub is None:
            for kind in ("boundary", "spring", "membrane"):
                if kind in calls:
                    out[kind] = (calls[kind], FAST_PASSES[kind])
    AB_INPUTS[label] = out
    if label == "dam":
        AB_DAM_SIM[0] = (sim, state)


def ab_record(label):
    """Record ``label``'s ring-kernel inputs after one resort period of its
    path (when the phase that records them did not run)."""
    params = SimParams()
    t0 = time.perf_counter()
    if label in ("box", "worm"):
        scene = (generate_liquid_box_scene if label == "box"
                 else generate_worm_scene)(params)
        sim = Simulator(scene, params, engine="auto", device="cuda")
        first_period(sim, label)
        calls = record_step_inputs(params, sim.layout, sim._fast_cfg,
                                   sim._wall_static, sim.state, sim.springs,
                                   sim.membranes)
        stash_ab(label, calls, {n: PASSES[n][1] for n in calls})
    elif label == "dam":
        scene = generate_liquid_box_scene(params, fill_fraction=0.8)
        sim = Simulator(scene, params, engine="auto", device="cuda")
        first_period(sim, "dam-break")
        fast_ab_inputs(params, sim, sim.state, label)
    else:
        scene = generate_worm_scene(params)
        sim = Simulator(scene, params, engine="fast", device="cuda",
                        fast_config=R4)
        first_period(sim, "fast worm")
        fast_ab_inputs(params, sim, sim.state, label)
    print(f"  {label}: inputs recorded after one resort period "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def tile_stats(p, tables):
    cnt = tables[4].float()
    act = cnt[cnt > 0]
    return float(act.mean()), int(cnt.max()), int(act.numel())


def prev_call(p, tables, own, slab):
    return pk._call(p, tables, own, slab, entry=f"sph_pair_{p.kind}_prev")


def launch_floor_ms():
    """Device milliseconds of an empty launch: torch's elementwise kernel
    on one element (torch.profiler), the floor under any kernel's time."""
    one = torch.zeros(1, device="cuda")
    return device_ms(lambda: one.add_(1.0))


def held_to(a, b, call, bitwise, scales, far):
    """(ok, max|diff| over real own rows): outputs ``a`` against ``b``
    bitwise, or (a kernel that splits rows) as ``compare`` holds a kernel
    to its plain version:
    KERNEL_TOL x the rounding scale's max over real own rows, a larger
    row's own (the scales cached in ``scales`` by call)."""
    p, tables, own, slab = call[:4]
    ob = int(tables[5][0])
    real = own[0, ob:ob + p.n_pad] < far
    err = max(float((x - y)[real].abs().max()) for x, y in zip(a, b))
    if bitwise:
        return all(torch.equal(x, y) for x, y in zip(a, b)), err
    if id(call) not in scales:
        scale = p.rounding_scale(tables, own, slab)
        scales[id(call)] = scale if isinstance(scale, tuple) else (scale,)
    scale = scales[id(call)]
    ok = True
    for group in pk.OUTPUT_GROUPS[p.kind]:
        row = torch.stack([scale[i] for i in group]).amax(0)
        tol = torch.clamp(KERNEL_TOL * row,
                          min=KERNEL_TOL * float(row[real].max()))
        ok &= all(bool(((a[i] - b[i]).abs() <= tol).all()) for i in group)
    return ok, err


def host_launch_us(call, reps=200):
    """Host microseconds of one pair launch and of its parts, host clock
    over ``reps`` calls without a synchronise."""
    p, tables, own, slab = call[:4]
    n_out = pk._rows(p)[0]
    parts = {
        "whole launch (PairPass.kernel)":
            lambda: p.kernel(tables, own, slab),
        "_check": lambda: pk._check(p, tables, own, slab),
        "torch.empty of the outputs": lambda: torch.empty(
            (n_out, p.n_pad), dtype=torch.float32, device=own.device),
    }
    out = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
    return out


def nocull_call(p, tables, own, slab):
    return pk._call(p, tables, own, slab, entry=f"sph_pair_{p.kind}_nocull")


def split_device_ms(fn, reps=50, tries=3):
    """(ring kernel, box kernel) mean device milliseconds a call of ``fn``
    (a culled ring launch: the box kernel, then the ring kernel), as
    ``device_ms`` takes them; None for each unless a session kept enough
    records of both."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    for _ in range(tries):
        kernels = profiled_kernels(run)
        ms = [_mean_ms([v for k, v in kernels.items()
                        if ("pair_ring_boxes" in k) == box], reps)
              for box in (False, True)]
        if None not in ms:
            return ms
    return [None, None]


def cull_check(label, name, call):
    """The shipped ring kernel (with its box cull) against its unculled
    form (``sph_pair_<kind>_nocull``) on one launch: the outputs' bits
    equal; where the pass culls, the boxes its box kernel left in
    ``pk.box_buffer`` equal ``pk.chunk_boxes`` of the slab; its device
    counters (one launch with
    the tracer on) equal the plain model ``pk.cull_counts`` (the kernel
    may fuse the gap's squares, the model does not: a chunk at the
    threshold may fall either way). Returns (chunks tested, culled)."""
    p, tables, own, slab = call[:4]
    new = pk._call(p, tables, own, slab)
    n_boxes = -(-slab.shape[1] // pk.CHUNK)
    boxes = pk.box_buffer(own.device, n_boxes)[:n_boxes].clone()
    old = nocull_call(p, tables, own, slab)
    torch.cuda.synchronize()
    same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(new, old))
    check(same, f"cull {label} {name}: the culled kernel's outputs are not "
          "bitwise its unculled form's")
    want = pk.chunk_boxes(slab, pk._RING_ROW0.get(p.kind, 0), pk.CHUNK)
    check(not p.culls or torch.equal(boxes, want), f"cull {label} {name}: "
          "the box kernel's boxes differ from chunk_boxes")
    before = pk.cull_counters()
    with trace.tracing():
        pk._call(p, tables, own, slab)
        torch.cuda.synchronize()
    after = pk.cull_counters()
    tested, culled = (after.get(f"pair.{p.kind}.{k}", 0)
                      - before.get(f"pair.{p.kind}.{k}", 0)
                      for k in ("chunks", "culled"))
    m_tested, m_culled = pk.cull_counts(p, tables, own, slab)
    check(tested == m_tested
          and abs(culled - m_culled) <= 2 + m_tested // 10000,
          f"cull {label} {name}: device counters {tested} tested, {culled} "
          f"culled; the model {m_tested}, {m_culled}")
    return tested, culled, m_tested, m_culled


def cull_ab(label, name, call, mult, card, totals):
    """``cull_check`` on one recorded launch, then the culled and unculled
    kernels timed in turns (unculled, culled, culled, unculled; CUDA
    events around ``AB_REPS`` calls, the culled call's box kernel
    included) and by torch.profiler device time (the culled call's ring
    and box kernels apart), and the box kernel's plain version
    (``pk.chunk_boxes``) by CUDA events and its byte bound. Adds a step's
    share (``mult`` launches) to ``totals``."""
    p, tables, own, slab = call[:4]
    tested, culled, m_tested, m_culled = cull_check(label, name, call)
    ts = [time_ms(f, AB_REPS) for f in (
        lambda: nocull_call(p, tables, own, slab),
        lambda: pk._call(p, tables, own, slab),
        lambda: pk._call(p, tables, own, slab),
        lambda: nocull_call(p, tables, own, slab))]
    old_ms, new_ms = (ts[0] + ts[3]) / 2, (ts[1] + ts[2]) / 2
    old_dev = device_ms(lambda: nocull_call(p, tables, own, slab))
    ring_dev, box_dev = split_device_ms(lambda: pk._call(p, tables, own,
                                                          slab))
    row0 = pk._RING_ROW0.get(p.kind, 0)
    box_plain = time_ms(lambda: pk.chunk_boxes(slab, row0, pk.CHUNK),
                        AB_REPS)
    n_boxes = -(-slab.shape[1] // pk.CHUNK)
    box_bound = (12 * slab.shape[1] + 32 * n_boxes) / PEAK_BYTES_S * 1e3
    share = culled / max(tested, 1)
    print(f"  cull {label:9s} {name:12s} bitwise True, boxes True; chunks "
          f"tested {tested}, culled {culled} ({share:.4f}; the model "
          f"{m_tested}, {m_culled}); unculled {ts[0]:.4f} / {ts[3]:.4f} ms, "
          f"culled {ts[1]:.4f} / {ts[2]:.4f} ms, x{old_ms / new_ms:.3f}; "
          f"device unculled {fmt_ms(old_dev)}, culled {fmt_ms(ring_dev)} + "
          f"box {fmt_ms(box_dev)} ms (plain {box_plain:.4f}, bound "
          f"{box_bound:.5f}) (x{mult}/step) [{card}]", flush=True)
    group = p.kind if label in ("worm", "box") else name
    acc = totals.setdefault((label, group), dict(
        old=0.0, new=0.0, old_dev=0.0, ring_dev=0.0, box_dev=0.0,
        box_plain=0.0, box_bound=0.0, tested=0, culled=0))
    acc["old"] += mult * old_ms
    acc["new"] += mult * new_ms
    for key, ms in (("old_dev", old_dev), ("ring_dev", ring_dev),
                    ("box_dev", box_dev)):
        acc[key] = (None if ms is None or acc[key] is None
                    else acc[key] + mult * ms)
    acc["box_plain"] += mult * box_plain
    acc["box_bound"] += mult * box_bound
    acc["tested"] += mult * tested
    acc["culled"] += mult * culled


def wide_tiles(card):
    """Tiles wider than 32 chunks, which the shipped entry points send to
    the unculled kernel: the dam-break's launches at ccol and ccol_c 1024
    from the recorded state, each through ``cull_check`` (no chunk
    tested)."""
    params = SimParams()
    sim, state = AB_DAM_SIM[0]
    cfg = dataclasses.replace(sim._fast_cfg, ccol=1024, ccol_c=1024)
    calls = record_fast_inputs(params, sim.layout, cfg, state, sim.springs,
                               sim.membranes)
    for name, call in sorted(calls.items()):
        if call[0].kind in pk.RING:
            tested, culled, _, _ = cull_check("dam1024", name, call)
            check(tested == 0, f"cull dam ccol 1024 {name}: {tested} chunks "
                  "tested")
            print(f"  cull dam ccol {call[0].ccol} {name:9s} bitwise True, "
                  f"unculled kernel (chunks tested {tested}) [{card}]",
                  flush=True)


def ab_phase(card, profile_steps):
    # 19. the redesigned kernels (the ring driver's, the spring list)
    # against their first designs (pair_pass) on every recorded launch:
    # bitwise or within the kernel tolerance, then timed in turns
    far = box_edge(SimParams())
    for label in AB_LABELS:
        if label not in AB_INPUTS:
            ab_record(label)
    for r in (shipped_kernel(k, g) for k in AB_KINDS for g in (0, 1)):
        if r is not None:
            check(r["spill_st"] == 0 and r["spill_ld"] == 0,
                  f"{r['label']} spills: {r}")
    floor_ms = launch_floor_ms()
    print(f"  ab device time of an empty launch (one-element add_, "
          f"torch.profiler): {fmt_ms(floor_ms)} ms [{card}]", flush=True)
    totals, scales, cull_totals = {}, {}, {}
    for label in AB_LABELS:
        for name, (call, mult) in sorted(AB_INPUTS[label].items()):
            p, tables, own, slab = call[:4]
            ring = pk.RING.get(p.kind)
            if ring is not None:
                cull_ab(label, name, call, mult, card, cull_totals)
            # the list kernel keeps one thread a row
            bitwise = ring is None or ring.tpr == 1
            if ring is None:
                # the first design stages 3 + 3 n_slots rows a tile: above
                # 48 KB its launch takes the shared-memory opt-in branch
                staged = 4 * p.slab_rows * p.ccol
                print(f"  ab {label:9s} {name:12s} first design stages "
                      f"{staged} B a tile (opt-in above {48 * 1024})",
                      flush=True)
                check(label != "worm" or staged > 48 * 1024,
                      "the first spring design's launch did not take the "
                      "shared-memory opt-in branch")
            new = pk._call(p, tables, own, slab)
            old = prev_call(p, tables, own, slab)
            torch.cuda.synchronize()
            ok, err = held_to(new, old, call, bitwise, scales, far)
            check(ok, f"ab {label} {name}: the redesigned kernel differs "
                  f"from the first design (max|diff| {err:.3e})")
            ts = [time_ms(f, AB_REPS) for f in (
                lambda: prev_call(p, tables, own, slab),
                lambda: pk._call(p, tables, own, slab),
                lambda: pk._call(p, tables, own, slab),
                lambda: prev_call(p, tables, own, slab))]
            prev_ms, new_ms = (ts[0] + ts[3]) / 2, (ts[1] + ts[2]) / 2
            # device time without the host's dispatch, which sets the
            # CUDA-event time of the short launches
            dev = ab_device_ms(lambda: prev_call(p, tables, own, slab),
                               lambda: pk._call(p, tables, own, slab))
            if ring is None:
                # the spring list's bound, the first design's beside it
                data_work = dict(spring=int((slab[3:3 + p.n_slots] >= 0)
                                            .sum()))
                pairs, bound_ms, by = pass_bound(p, tables, own, slab, far,
                                                 None)
                all_ms = pass_bound(p, tables[:6], own, slab, far,
                                    data_work)[1]
                ctas = -(-p.n_pad // 256)
                charge = "pair-form charge"
            else:
                pairs, bound_ms, by = pass_bound(p, tables, own, slab, far,
                                                 None)
                all_ms = pairs * PAIR_FLOPS[p.kind] / PEAK_F32_FLOPS * 1e3
                ctas = p.n_blocks * p.block // ring.rows_cta
                charge = "all-pairs charge"
            mean_t, max_t, act = tile_stats(p, tables)
            if p.kind in EXIT_FLOPS:
                near = near_pairs(p, tables, own, slab)
                print(f"  ab {label:9s} {name:12s} {near} pairs under the "
                      f"exit's reach of {pairs} candidate pairs "
                      f"({near / max(pairs, 1):.4f})", flush=True)
            print(f"  ab {label:9s} {name:12s} {p.launch_key:10s} blocks "
                  f"{p.n_blocks} ({act} with tiles: {mean_t:.2f} mean, "
                  f"{max_t} max) ccol {p.ccol}: "
                  f"{'bitwise' if bitwise else 'within tolerance'} "
                  f"(max|diff| {err:.1e}); previous {ts[0]:.4f} / "
                  f"{ts[3]:.4f} ms ({p.n_blocks} CTAs), new {ts[1]:.4f} / "
                  f"{ts[2]:.4f} ms ({ctas} CTAs), x{prev_ms / new_ms:.3f}; "
                  f"device {fmt_ms(dev[0])} / {fmt_ms(dev[1])} ms; "
                  f"bound {bound_ms:.5f} ms ({by}; {charge} "
                  f"{all_ms:.5f}), bound/new {bound_ms / new_ms:.3f} "
                  f"(x{mult}/step) [{card}]", flush=True)
            # the fastw paths sum a kind's launches; the fast paths keep
            # each gate setting apart
            group = p.kind if label in ("worm", "box") else name
            acc = totals.setdefault((label, group),
                                    dict(prev=0.0, new=0.0, bound=0.0,
                                         all_pairs=0.0, err=0.0,
                                         prev_dev=0.0, new_dev=0.0))
            acc["prev"] += mult * prev_ms
            acc["new"] += mult * new_ms
            for key, ms in zip(("prev_dev", "new_dev"), dev):
                acc[key] = (None if ms is None or acc[key] is None
                            else acc[key] + mult * ms)
            acc["bound"] += mult * bound_ms
            acc["all_pairs"] += mult * all_ms
            acc["err"] = max(acc["err"], err)
    for (label, group), a in sorted(totals.items()):
        print(f"  ab {label:9s} {group:12s} per step: previous {a['prev']:.4f}"
              f" ms, new {a['new']:.4f} ms (x{a['prev'] / a['new']:.3f}); "
              f"device {fmt_ms(a['prev_dev'])} / {fmt_ms(a['new_dev'])} ms; "
              f"bound {a['bound']:.5f} ms = {a['bound'] / a['new']:.3f} of "
              f"the new kernel's time (all-pairs or pair-form charge "
              f"{a['all_pairs']:.5f}) [{card}]", flush=True)

    for (label, group), a in sorted(cull_totals.items()):
        print(f"  cull {label:9s} {group:12s} per step: unculled "
              f"{a['old']:.4f} ms, culled {a['new']:.4f} ms "
              f"(x{a['old'] / a['new']:.3f}); device unculled "
              f"{fmt_ms(a['old_dev'])}, culled {fmt_ms(a['ring_dev'])} + box "
              f"{fmt_ms(a['box_dev'])} ms (plain {a['box_plain']:.4f}, "
              f"bound {a['box_bound']:.5f}); chunks culled "
              f"{a['culled'] / max(a['tested'], 1):.4f} of "
              f"{a['tested']} [{card}]", flush=True)
    wide_tiles(card)
    # the box kernel's entry: one step of the fastw worm's launches (the
    # main path), its launches counted there; device time only, since the
    # ring kind's entry point launches it with its ring kernel
    worm = [a for (label, _), a in cull_totals.items() if label == "worm"]
    box_dev = [a["box_dev"] for a in worm]
    box_entry = dict(
        name="chunk_boxes", route="cuda", source=SOURCE, replaces=None,
        launches=MAIN_BOX_LAUNCHES[0], max_abs_err=0.0,
        ms=None if None in box_dev else sum(box_dev),
        plain_ms=sum(a["box_plain"] for a in worm),
        bound_ms=sum(a["box_bound"] for a in worm), bound_by="bytes",
        library_ms=None,
        ms_scope="one step's launches, fastw, full worm: torch.profiler "
                 "device time of pair_ring_boxes (launched with each ring "
                 "kernel, so CUDA events cannot take it alone); plain_ms "
                 "by CUDA events around the plain version's calls",
        registers=_regs(next((r for r in BUILD_REPORT
                              if r["driver"] == "pair_ring_boxes"), None)))
    print(f"  box kernel a worm step: device {fmt_ms(box_entry['ms'])} ms, "
          f"plain {box_entry['plain_ms']:.4f} ms, bound "
          f"{box_entry['bound_ms']:.5f} ms; {box_entry['launches']} "
          f"launches on the main path [{card}]", flush=True)

    def step_total(label, groups):
        """One step's totals over the fast-engine groups (or a fastw
        kind) of ``label``."""
        out = {}
        for key in totals[(label, groups[0])]:
            vals = [totals[(label, g)][key] for g in groups]
            out[key] = (max(vals) if key == "err" else None
                        if None in vals else sum(vals))
        return out

    # each kind on the path where it takes the most time: density on the
    # dam-break (the time-t density and the 3 rho* launches), the others on
    # the fastw worm
    main_ab = {kind: ("worm", (kind,)) for kind in AB_KINDS}
    main_ab["density"] = ("dam", ("density", "rho_star"))
    for kind, (label, groups) in main_ab.items():
        a = step_total(label, groups)
        print(f"  ab {label} {kind}: the new kernel "
              f"{'is' if a['new'] < a['prev'] else 'is NOT'} below the "
              f"previous design a step (previous {a['prev']:.4f} ms, new "
              f"{a['new']:.4f} ms) [{card}]", flush=True)

    call = AB_INPUTS["worm"]["pacc_mm"][0]
    print(f"  host time of one pair launch (pacc_mm, 200 calls, no "
          f"synchronise) [{card}]:", flush=True)
    for name, us in host_launch_us(call).items():
        print(f"    {name:34s} {us:8.2f} us", flush=True)

    def extra(label, groups, kind, gated):
        a = step_total(label, groups)
        cur = shipped_kernel(kind, gated)
        prev = next((r for r in BUILD_REPORT if r["driver"] == "pair_pass"
                     and r["key"] == (kind, int(gated))), None)
        c = {}
        if kind in pk.RING:
            cs = [cull_totals[(label, g)] for g in groups]
            c = dict(nocull_ms=sum(x["old"] for x in cs),
                     cull_ms=sum(x["new"] for x in cs),
                     culled_share=sum(x["culled"] for x in cs)
                     / max(sum(x["tested"] for x in cs), 1))
        return dict(prev_ms=a["prev"], ab_ms=a["new"], **c,
                    prev_device_ms=a["prev_dev"], ab_device_ms=a["new_dev"],
                    ab_scope=f"in-call A/B, {label}, CUDA events around "
                             f"{AB_REPS} launches, previous/new/new/"
                             "previous",
                    registers=cur and cur["regs"],
                    prev_registers=prev and prev["regs"],
                    bound_ms_all_pairs=a["all_pairs"])
    out = {kind: extra(label, groups, kind, False)
           for kind, (label, groups) in main_ab.items()}
    out["spring"]["launch_floor_device_ms"] = floor_ms
    for kind, groups in (("density", ("density_s32", "rho_star_s32")),
                         ("viscsurf", ("viscsurf_s32",)),
                         ("paccel", ("paccel_s32",))):
        out[kind + "_sub"] = extra("fast_worm", groups, kind, True)
    return dict(kernels={"chunk_boxes": box_entry}, launches={}, extra=out)


# ---------------------------------------------------------------------------
# the compiled resort period: graphed against eager (phase 20)
# ---------------------------------------------------------------------------

def graph_stats(label):
    """Prints, and takes out of ``graphed.CAPTURES``, each period graph
    captured since the last call: its steps, capture plus instantiate
    seconds, pool bytes and pair launches a replay."""
    for c in graphed.CAPTURES:
        print(f"  {label}: {c['r_steps']}-step period graph: capture + "
              f"instantiate {c['capture_s']:.3f} s, pool "
              f"{c['pool_bytes']} B ({c['pool_bytes'] / 2**20:.1f} MiB), "
              f"launches a replay {c['launches']}", flush=True)
    graphed.CAPTURES.clear()


def graph_turns(label, make_sim, warm, steps, per_step, card, sims=None):
    """ms/step of ``steps`` steps on an eager and a graphed Simulator in
    turns E G G E (``make_sim(cuda_graph)``, each first stepped by
    ``warm(sim)``); every run's launches at exactly ``per_step`` a step
    (other keys 0). Returns the two simulators."""
    if sims is None:
        sims = {"E": make_sim(False), "G": make_sim(True)}
        for sim in sims.values():
            warm(sim)
    times = {"E": [], "G": []}
    for k in "EGGE":
        dt, launches = timed_run(sims[k], steps)
        for key, n in launches.items():
            want = per_step.get(key, 0) * steps
            check(n == want, f"{label} {k} {key}: {n} launches in {steps} "
                  f"steps, expected {want}")
        times[k].append(dt * 1e3 / steps)
    print(f"{label}: {steps} steps a run, E G G E: "
          f"{times['E'][0]:.4f} {times['G'][0]:.4f} {times['G'][1]:.4f} "
          f"{times['E'][1]:.4f} ms/step (eager / graphed) [{card}]",
          flush=True)
    graph_stats(label)
    return sims


def graph_phase(card, profile_steps):
    # 20. the compiled resort period on the main path: 60 steps graphed and
    # eager from one state, held bitwise; every path's ms/step in turns;
    # the profiler's launch calls, busy and idle share of graphed steps
    params = SimParams()
    worm = generate_worm_scene(params)

    def worm_sim(cuda_graph):
        sim = Simulator(worm, params, engine="auto", device="cuda",
                        cuda_graph=cuda_graph)
        check(sim.engine == "fastw", f"auto resolved to {sim.engine}")
        return sim

    def warm_worm(sim):
        # the first period one step at a time (phase 9), then one whole
        # period: both graphs of the Simulator, GRAPH_STEPS in all
        first_period(sim, "graph worm")
        sim.step(GRAPH_STEPS - sim._fast_cfg.resort_every)

    graphed.CAPTURES.clear()
    sims = {"E": worm_sim(False), "G": worm_sim(True)}
    for sim in sims.values():
        warm_worm(sim)
    torch.cuda.synchronize()
    e, g = sims["E"].state, sims["G"].state
    check(int(e.step) == int(g.step) == GRAPH_STEPS,
          f"steps {int(e.step)}, {int(g.step)}")
    dpos = float((e.pos - g.pos).abs().max())
    dvel = float((e.vel - g.vel).abs().max())
    bitwise = all(torch.equal(getattr(e, f), getattr(g, f))
                  for f in ("pos", "vel", "muscle_activation"))
    moved = float((g.pos - torch.as_tensor(worm.pos, device=g.pos.device))
                  .abs().max())
    print(f"graph: the fastw worm after {GRAPH_STEPS} steps, graphed vs "
          f"eager: bitwise {bitwise}, max|dpos| {dpos:.3e}, max|dvel| "
          f"{dvel:.3e}; largest displacement {moved:.3e}", flush=True)
    check(moved > 100 * ENGINE_TOL, f"the worm moved only {moved}")
    if not bitwise:
        # the eager loop against itself: the graph must match it bitwise
        # unless the card's eager steps are not reproducible
        again = worm_sim(False)
        warm_worm(again)
        d2 = float((again.state.pos - e.pos).abs().max())
        print(f"graph: eager vs eager max|dpos| {d2:.3e}", flush=True)
        check(d2 > 0.0, "the graphed period differs from the eager loop, "
              "which repeats itself bitwise")
        check(dpos <= ENGINE_TOL, f"graphed vs eager max|dpos| {dpos} > "
              f"{ENGINE_TOL}")
    graph_turns("graph fastw worm", worm_sim, warm_worm, GRAPH_TIMED,
                PER_STEP, card, sims=sims)
    gl, el = (profile(sims[k], GRAPH_PROFILE, card) for k in "GE")

    def fmt(x, spec):
        return "not measured" if x is None else format(x, spec)

    print(f"graph: profiled fastw worm, {GRAPH_PROFILE} steps, graphed vs "
          f"eager: cudaLaunchKernel {gl['cudaLaunchKernel'][0]:.2f} vs "
          f"{el['cudaLaunchKernel'][0]:.2f} a step, cudaGraphLaunch "
          f"{gl['cudaGraphLaunch'][0]:.3f} vs {el['cudaGraphLaunch'][0]:.3f}"
          f" a step, host in launch calls "
          f"{sum(gl[a][1] for a in LAUNCH_APIS):.1f} vs "
          f"{sum(el[a][1] for a in LAUNCH_APIS):.1f} us a step, wall "
          f"{gl['wall_ms']:.4f} vs {el['wall_ms']:.4f} ms/step, device busy "
          f"{fmt(gl['busy_ms'], '.4f')} vs {fmt(el['busy_ms'], '.4f')} "
          f"ms/step, idle {fmt(gl['idle'], '.3f')} vs "
          f"{fmt(el['idle'], '.3f')} [{card}]", flush=True)
    check(el["cudaLaunchKernel"][0] > 100 and gl["cudaGraphLaunch"][0] > 0,
          "the profiler did not record the launch calls: eager "
          f"{el['cudaLaunchKernel'][0]} cudaLaunchKernel, graphed "
          f"{gl['cudaGraphLaunch'][0]} cudaGraphLaunch a step")
    check(gl["cudaLaunchKernel"][0] <= GRAPH_MAX_LAUNCHES,
          f"graphed worm: {gl['cudaLaunchKernel'][0]} cudaLaunchKernel a "
          f"step > {GRAPH_MAX_LAUNCHES}")
    # the device's own count of each pair kernel against the launches a
    # step: a graph that dropped or repeated a pair kernel of its period
    # (2 periods here) would miss by 2 records or more; a session may drop
    # its first kernel record, so 1 record short in all is allowed
    want = {k: v * GRAPH_PROFILE for k, v in PER_STEP.items()}
    for k, prof in (("graphed", gl), ("eager", el)):
        got = prof["pairs"]
        short = {key: want.get(key, 0) - n for key, n in
                 (want | got).items() if got.get(key, 0) != want.get(key, 0)}
        print(f"graph: {k} worm, pair kernel records on the device in "
              f"{GRAPH_PROFILE} steps: {got} (expected {want})", flush=True)
        check(all(v >= 0 for v in short.values())
              and sum(short.values()) <= 1,
              f"{k} worm: the device ran the pair kernels {got} times in "
              f"{GRAPH_PROFILE} steps, expected {want}")
    del sims

    # the other paths, eager and graphed in turns
    box = generate_liquid_box_scene(params)
    graph_turns(
        "graph box", lambda cg: Simulator(box, params, device="cuda",
                                          cuda_graph=cg),
        lambda sim: sim.step(sim._fast_cfg.resort_every), GRAPH_TIMED,
        PER_STEP_BOX, card)
    fast_worm = {}
    for sub in (None, 32):
        per_step = {k + "_sub" if sub and k in pk.GATED else k: v
                    for k, v in PER_STEP_FAST_WORM.items()}
        fast_worm[sub] = graph_turns(
            f"graph fast worm sub {sub}",
            lambda cg, sub=sub: Simulator(
                worm, params, engine="fast", device="cuda",
                fast_config=dict(R4, sub=sub), cuda_graph=cg),
            warm_worm, GRAPH_TIMED, per_step, card)
    del fast_worm
    dam = generate_liquid_box_scene(params, fill_fraction=0.8)
    graph_turns(
        "graph dam-break", lambda cg: Simulator(dam, params, device="cuda",
                                                cuda_graph=cg),
        lambda sim: sim.step(DAM_WARMUP), GRAPH_TIMED, PER_STEP_DAM, card)
    return None


# ---------------------------------------------------------------------------
# the simulator facade: checkpoints, the ladder, dumps, the in-graph wall
# path and the CLI (phase 21)
# ---------------------------------------------------------------------------

def worm_sim(worm, params, **kw):
    """The full worm through ``Simulator(engine="auto", device="cuda")``,
    graphed (the default); it must resolve to fastw."""
    sim = Simulator(worm, params, engine="auto", device="cuda", **kw)
    check(sim.engine == "fastw", f"auto resolved to {sim.engine}")
    return sim


def same_state(a, b):
    """Positions, velocities, activation and step of two states equal
    bitwise."""
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("pos", "vel", "muscle_activation", "step"))


def synced_s(fn):
    """Seconds of ``fn()`` ending in a device synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def runtime_checkpoint(worm, params, tmp, card):
    """21a: 45 steps, save, 45 more; a new Simulator restores and steps 45,
    bitwise; a second restore into it (its graphs kept) steps 45, bitwise,
    capturing nothing. Returns (checkpoint path, the first Simulator)."""
    a = worm_sim(worm, params)
    first_period(a, "runtime checkpoint")
    a.step(RUNTIME_STEPS - a._fast_cfg.resort_every)
    ck = os.path.join(tmp, "worm.npz")
    t_save = synced_s(lambda: a.save(ck))
    keys = sorted(np.load(ck).files)
    check(keys == sorted(CKPT_KEYS + ("color",)),
          f"checkpoint keys {keys}, expected sph_tpu's {CKPT_KEYS}")
    a.step(RUNTIME_STEPS)
    b = worm_sim(worm, params)
    t_restore = synced_s(lambda: b.restore(ck))
    check(b.step_count == RUNTIME_STEPS, f"restored at step {b.step_count}")
    b.step(RUNTIME_STEPS)
    check(same_state(a.state, b.state), "the restored run differs from the "
          f"uninterrupted one after {RUNTIME_STEPS} steps: max|dpos| "
          f"{float((a.state.pos - b.state.pos).abs().max()):.3e}")
    captures = len(graphed.CAPTURES)
    t_again = synced_s(lambda: b.restore(ck))
    b.step(RUNTIME_STEPS)
    check(same_state(a.state, b.state), "a second restore into the same "
          "Simulator differs from the uninterrupted run")
    check(len(graphed.CAPTURES) == captures, "the second restore captured "
          f"{len(graphed.CAPTURES) - captures} new period graphs")
    moved = float((a.state.pos - torch.as_tensor(worm.pos,
                                                  device=a.state.pos.device))
                  .abs().max())
    check(moved > 100 * ENGINE_TOL, f"the worm moved only {moved}")
    print(f"runtime: checkpoint at step {RUNTIME_STEPS}: save "
          f"{t_save:.3f} s, {os.path.getsize(ck)} B, keys = sph_tpu's; "
          f"restore into a new Simulator {t_restore:.3f} s, into the same "
          f"one {t_again:.3f} s (no new graph); {RUNTIME_STEPS} steps on, "
          f"both runs bitwise equal the uninterrupted one (step "
          f"{a.step_count}, largest displacement {moved:.3e}) [{card}]",
          flush=True)
    graph_stats("runtime checkpoint")
    return ck, a


WALL_STEPS = 5   # steps from each resort's common state (21d)


def walls_sums(a, params, ws):
    """21d: one sort of ``a``'s state on both wall paths: whether the shell
    rows are equal bitwise, and the largest |diff| of the in-graph
    (``raw_sw``, f32) wall-wall sums from the hoisted (host f64) ones on
    the real shell rows, with their largest |sum| (the pass's rounding
    scale: the terms are positive) and the rows that differ."""
    ctxs = [W._make_step_parts_w(params, a.layout, a._fast_cfg, wall_static=w)
            .sort_ctx(a.state, a.springs, a.membranes)[0] for w in (None, ws)]
    same = all(torch.equal(x, y) for x, y in zip(ctxs[0]["shell_static"],
                                                  ctxs[1]["shell_static"]))
    real = ctxs[1]["shell_static"][6][:len(ctxs[1]["ww_const"])] > 0
    got, ref = (c["ww_const"][real].double() for c in ctxs)
    diff = (got - ref).abs()
    return (same, float(diff.max()), float(ref.abs().max()),
            int((diff > 0).sum()), int(real.sum()))


def walls_run(a, params, steps, wall_static, start=None):
    """``steps`` fastw steps of ``a``'s scene from ``start`` (``a``'s
    state) on the given wall path."""
    return W.make_fastw_multi_step(params, a.layout, a._fast_cfg, steps,
                                   wall_static=wall_static)(
        a.state if start is None else start, a.springs, a.membranes)


def runtime_walls(a, params, card):
    """21d: the fastw engine with the walls sorted in the graph
    (``wall_static=None``: ``raw_sw`` once a resort) against the hoisted
    path: the wall sums of one sort (``walls_sums``), ``WALL_STEPS`` steps
    after each resort from a common state, and two periods from the same
    state beside the hoisted path's own divergence under a one-ulp change
    of its wall sums; the raw_sw launch against its plain version on one
    resort's inputs, timed beside its bound. Returns the kernels-line
    entry and the launches a step."""
    state, springs, membranes = a.state, a.springs, a.membranes
    layout, cfg, ws = a.layout, a._fast_cfg, a._wall_static
    steps = WALL_PERIODS * cfg.resort_every
    runs = {key: W.make_fastw_multi_step(params, layout, cfg, steps,
                                         return_diag=True, wall_static=w)
            for key, w in (("in-graph", None), ("hoisted", ws))}
    outs, launches = {}, {}
    for key, run in runs.items():           # the first call captures
        out, diag = run(state, springs, membranes)
        check(int(diag["shell_overflow"]) == 0
              and int(diag["tile_overflow"]) == 0,
              f"walls {key}: overflow {diag}")
        outs[key] = out
    # the wall sums of one sort: the in-graph f32 sums against the host's
    # f64 ones, held as a kernel is held to its plain version
    same, dww, scale, n_diff, n_real = walls_sums(a, params, ws)
    print(f"runtime walls: one sort at step {int(state.step)}: shell rows "
          f"equal bitwise {same}; wall sums on the {n_real} real shell rows,"
          f" in-graph (f32) vs hoisted (f64): max|diff| {dww:.3e} (<= "
          f"{KERNEL_TOL:g} x {scale:.4g}), {n_diff} rows differ", flush=True)
    check(same and dww <= KERNEL_TOL * scale,
          f"walls: shell rows equal {same}, wall sums differ by {dww}")
    # a few steps after each resort of the two periods, from a common
    # state: the hoisted path's at the start and one period on
    mid = walls_run(a, params, cfg.resort_every, ws)
    d_short = max(float((walls_run(a, params, WALL_STEPS, None, s0).pos
                         - walls_run(a, params, WALL_STEPS, ws, s0).pos)
                        .abs().max()) for s0 in (state, mid))
    # the two periods whole. Where the liquid presses on the walls (the
    # pool's last x-column starts within h of the far x-wall) a wall's
    # density leaves its clamp, and there one ulp of the wall sums grows
    # over the periods: the control is the hoisted path with every wall
    # sum one ulp up, and the in-graph path may differ from the hoisted
    # one by no more than that control (nor by more than ENGINE_TOL where
    # the control stays below it)
    up = dict(ws, ww=torch.nextafter(ws["ww"], torch.full_like(
        ws["ww"], float("inf"))))
    control = float((walls_run(a, params, steps, up).pos
                     - outs["hoisted"].pos).abs().max())
    d = float((outs["in-graph"].pos - outs["hoisted"].pos).abs().max())
    moved = float((outs["in-graph"].pos - state.pos).abs().max())
    print(f"runtime walls: walls sorted in the graph vs wall_static: "
          f"max|dpos| {d_short:.3e} over {WALL_STEPS} steps from step "
          f"{int(state.step)} and from step {int(mid.step)} (<= "
          f"{ENGINE_TOL:g}); {d:.3e} over {WALL_PERIODS} periods from step "
          f"{int(state.step)}, against {control:.3e} for wall_static with "
          f"its wall sums one ulp up (<= max({ENGINE_TOL:g}, that)); "
          f"largest displacement {moved:.3e}", flush=True)
    check(np.isfinite(outs["in-graph"].pos.cpu().numpy()).all()
          and d_short <= ENGINE_TOL and d <= max(ENGINE_TOL, control),
          f"in-graph walls vs wall_static: {d_short} over {WALL_STEPS} "
          f"steps, {d} over {WALL_PERIODS} periods (control {control})")
    check(moved > 100 * ENGINE_TOL, f"the worm moved only {moved}")
    times = {k: [] for k in runs}
    for key in ("hoisted", "in-graph", "in-graph", "hoisted"):
        for k in pk.LAUNCHES:
            pk.LAUNCHES[k] = 0
        times[key].append(synced_s(lambda: runs[key](state, springs,
                                                     membranes)) * 1e3 / steps)
        launches[key] = dict(pk.LAUNCHES)
    extra = launches["in-graph"]["rho_star"] - launches["hoisted"]["rho_star"]
    check(launches["hoisted"]["rho_star"] == PER_STEP["rho_star"] * steps
          and extra == WALL_PERIODS
          and {k: v for k, v in launches["in-graph"].items() if k != "rho_star"}
          == {k: v for k, v in launches["hoisted"].items() if k != "rho_star"},
          f"walls in the graph: launches {launches}, expected one more "
          "rho_star launch a period")
    print(f"runtime walls: ms/step in turns S G G S (wall_static, in-graph): "
          f"{times['hoisted'][0]:.4f} {times['in-graph'][0]:.4f} "
          f"{times['in-graph'][1]:.4f} {times['hoisted'][1]:.4f}; rho_star "
          f"launches {launches['in-graph']['rho_star']} vs "
          f"{launches['hoisted']['rho_star']} in {steps} steps [{card}]",
          flush=True)
    graph_stats("runtime walls")

    parts = W._make_step_parts_w(params, layout, cfg, wall_static=None)
    calls = W.record_step_inputs(parts, state, springs, membranes)
    p, tables, own, slab = calls["raw_sw"]
    far = box_edge(params)
    err = compare({"raw_sw": calls["raw_sw"]}, "worm", far)["raw_sw"]
    ms = time_ms(lambda: p.kernel(tables, own, slab), 20)
    plain_ms = time_ms(lambda: p.plain(tables, own, slab), 3)
    dev = device_ms(lambda: p.kernel(tables, own, slab))
    pairs, bound_ms, by = pass_bound(p, tables, own, slab, far, None)
    print(f"  worm  raw_sw    kernel {ms:9.4f} ms (device "
          f"{fmt_ms(dev)})  plain {plain_ms:9.3f} ms  bound {bound_ms:8.5f} "
          f"ms ({by}, {pairs:.4g} candidate pairs; {p.n_blocks} shell "
          f"blocks x wall columns {slab.shape[1]}, ccol {p.ccol}) (x1 a "
          f"period, 1/{cfg.resort_every} a step) [{card}]", flush=True)
    entry = dict(
        name="rho_star_sw", route="cuda", source=SOURCE,
        replaces=REPLACES["rho_star"], launches=extra, max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
        library_ms=None, device_ms=dev,
        ms_scope=("one launch (one a resort period), shell rows x wall "
                  "columns, fastw with wall_static=None, full worm"),
        registers=_regs(shipped_kernel("rho_star", False)))
    per_step = {k: v / steps for k, v in launches["in-graph"].items()}
    per_step["rho_star_sw"] = extra / steps
    return {"rho_star_sw": entry}, {"worm_fastw_walls_in_graph": per_step}


def runtime_dumps(worm, params, ck, tmp, card):
    """21c: 60 steps from the checkpoint with a frame every 10 steps,
    async and sync writes, byte-identical files of 7 frames; beside them
    the same steps without dumps, and with a resort every step and no dump
    (what the single-step periods of a dumped run cost alone), in turns
    N 1 A S N. Every Simulator's graphs are captured before the turns."""
    from sph_tpu_torch.scene.io import load_trajectory

    sims, paths = {}, {}
    for key, kw in (("none", {}), ("single", dict(fast_config=dict(
                        resort_every=1))),
                    ("async", dict(async_io=True)),
                    ("sync", dict(async_io=False))):
        if key in ("async", "sync"):
            paths[key] = os.path.join(tmp, "dump_" + key)
            kw = dict(kw, dump_dir=paths[key], dump_interval=DUMP_INTERVAL)
        sims[key] = sim = worm_sim(worm, params, **kw)
        for n in {1, sim._fast_chunk}:      # capture, the state unchanged
            sim._fast_run_for(n)(sim.state, sim.springs, sim.membranes)
    graph_stats("runtime dumps")
    ms = {}
    for key in ("none", "single", "async", "sync", "none"):
        sim = sims[key]
        sim.restore(ck)

        def run():
            sim.step(DUMP_STEPS)
            sim.flush()
        ms.setdefault(key, []).append(synced_s(run) * 1e3 / DUMP_STEPS)
    files = [open(os.path.join(paths[k], "position_buffer.txt"), "rb").read()
             for k in ("async", "sync")]
    frames = load_trajectory(os.path.join(paths["async"],
                                          "position_buffer.txt"))[2]
    print(f"runtime dumps: {DUMP_STEPS} steps from step {RUNTIME_STEPS}, a "
          f"frame every {DUMP_INTERVAL} (single-step periods, as in "
          f"sph_tpu), turns N 1 A S N: ms/step without dumps "
          f"{ms['none'][0]:.4f}, a resort every step without dumps "
          f"{ms['single'][0]:.4f}, dumps async {ms['async'][0]:.4f}, sync "
          f"{ms['sync'][0]:.4f}, without dumps {ms['none'][1]:.4f}; "
          f"{len(frames)} frames, {len(files[0])} B, async == sync: "
          f"{files[0] == files[1]} [{card}]", flush=True)
    check(files[0] == files[1], "async and sync dumps differ")
    check(len(frames) == 1 + DUMP_STEPS // DUMP_INTERVAL,
          f"{len(frames)} frames")
    check(np.isfinite(frames).all(), "dumped frames not finite")
    check(not graphed.CAPTURES, "a graph was captured in the timed runs")


def runtime_ladder(worm, params, tmp, card):
    """21b: 150 steps of the adaptive ladder (threshold 0.25 h) from step
    0, chunk by chunk; ms/step against the fixed period in turns A F F A;
    profiles of one run each."""
    graphed.CAPTURES.clear()
    ad = worm_sim(worm, params, adaptive_resort=True,
                  drift_threshold_h=LADDER_THRESHOLD_H)
    ck0 = os.path.join(tmp, "worm0.npz")
    ad.save(ck0)
    shell_cells = ad._fast_cfg.dilate - 1
    rows = []
    while ad.step_count < LADDER_STEPS:
        left = LADDER_STEPS - ad.step_count
        size = ad._fast_chunk if left >= ad._fast_chunk else 1
        ad.step(size)
        ovf = ad.check_overflow()
        rows.append((size, ovf["window_drift_h"], ovf["shell_overflow"],
                     ovf["tile_overflow"], ad._fast_chunk))
    check(ad.step_count == LADDER_STEPS, f"ladder at step {ad.step_count}")
    for i, (size, drift, shell, tile, nxt) in enumerate(rows):
        print(f"  ladder chunk {i}: period {size}, drift bound "
              f"{drift:.4f} h, shell overflow {shell}, tile overflow {tile},"
              f" next period {nxt}", flush=True)
    first = rows[0]
    print(f"runtime ladder: the first {first[0]}-step period moves a "
          f"particle up to {first[1] / 2:.4f} cells (bound; drift "
          f"{first[1]:.4f} h) against the shell's {shell_cells}: outruns "
          f"the shell: {first[1] / 2 >= shell_cells}", flush=True)
    check(all(r[2] == 0 and r[3] == 0 for r in rows),
          "ladder: shell or tile overflow")
    n_graphs = len(graphed.CAPTURES)
    print(f"runtime ladder: {n_graphs} period graphs for period lengths "
          f"{sorted(ad._fast_runs)} (levels {ad._chunk_levels} and 1)",
          flush=True)
    check(n_graphs <= 4 and len(ad._fast_runs) <= 4,
          f"{n_graphs} graphs, runners {sorted(ad._fast_runs)}")
    graph_stats("runtime ladder")
    fixed = worm_sim(worm, params)
    fixed.step(LADDER_STEPS)                 # its graphs, untimed
    graph_stats("runtime fixed period")
    sims = {"A": ad, "F": fixed}

    def reset(sim):
        sim.restore(ck0)
        if sim is ad:
            ad._fast_chunk = ad._chunk_levels[0]
    ms = {"A": [], "F": []}
    for k in "AFFA":
        reset(sims[k])
        ms[k].append(synced_s(lambda: sims[k].step(LADDER_STEPS)) * 1e3
                     / LADDER_STEPS)
    print(f"runtime ladder: {LADDER_STEPS} steps from step 0, A F F A "
          f"(adaptive / fixed period {ad._fast_cfg.resort_every}): "
          f"{ms['A'][0]:.4f} {ms['F'][0]:.4f} {ms['F'][1]:.4f} "
          f"{ms['A'][1]:.4f} ms/step; graphs captured in the timed runs: "
          f"{len(graphed.CAPTURES)} [{card}]", flush=True)
    graph_stats("runtime timed")
    prof = {}
    for k in "AF":
        reset(sims[k])
        prof[k] = profile(sims[k], LADDER_STEPS, card)

    def fmt(x, spec):
        return "not measured" if x is None else format(x, spec)
    print(f"runtime ladder: profiled, adaptive vs fixed: wall "
          f"{prof['A']['wall_ms']:.4f} vs {prof['F']['wall_ms']:.4f} "
          f"ms/step, cudaGraphLaunch {prof['A']['cudaGraphLaunch'][0]:.3f} vs "
          f"{prof['F']['cudaGraphLaunch'][0]:.3f} a step "
          f"({prof['A']['cudaGraphLaunch'][1]:.1f} vs "
          f"{prof['F']['cudaGraphLaunch'][1]:.1f} us of host), device busy "
          f"{fmt(prof['A']['busy_ms'], '.4f')} vs "
          f"{fmt(prof['F']['busy_ms'], '.4f')} ms/step, idle "
          f"{fmt(prof['A']['idle'], '.3f')} vs {fmt(prof['F']['idle'], '.3f')}"
          f" [{card}]", flush=True)


def runtime_cli(worm, tmp, card):
    """21e: the CLI on the card in subprocesses: run with a dump and a
    checkpoint, run on from the checkpoint, info."""
    env = dict(os.environ, PYTHONPATH=REPO)
    dump, ck = os.path.join(tmp, "cli_dump"), os.path.join(tmp, "cli.npz")
    outs = []
    for args in (["run", *CLI_SCENE, *CLI_RUN, "--steps", str(CLI_STEPS),
                  "--dump", dump, "--dump-every", str(CLI_MORE),
                  "--checkpoint", ck],
                 ["run", *CLI_SCENE, *CLI_RUN, "--steps", str(CLI_MORE),
                  "--restore", ck],
                 ["info", *CLI_SCENE]):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "sph_tpu_torch", *args],
                             cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=CLI_TIMEOUT_S)
        tail = res.stdout.strip().splitlines()[-3:]
        print(f"runtime cli: {' '.join(args)}: exit "
              f"{res.returncode} in {time.perf_counter() - t0:.1f} s; "
              f"{' | '.join(tail)}", flush=True)
        check(res.returncode == 0, f"cli {args}: {res.stderr[-2000:]}")
        outs.append(res.stdout)
    check(f"[[ step {CLI_STEPS} ]]" in outs[0] and os.path.exists(ck)
          and os.path.exists(os.path.join(dump, "position_buffer.txt")),
          f"cli run: no step {CLI_STEPS}, checkpoint or dump")
    check(f"[[ step {CLI_STEPS + CLI_MORE} ]]" in outs[1],
          f"the restored cli run did not reach step {CLI_STEPS + CLI_MORE}")
    info = json.loads(outs[2][outs[2].index("{"):])
    check(all(info[k] == v for k, v in worm.counts.items()),
          f"cli info {info} vs {worm.counts}")


def runtime_phase(card, profile_steps):
    # 21. the simulator facade on the full worm: checkpoints, the in-graph
    # wall path, dumps, the adaptive ladder and the CLI
    import shutil
    import tempfile

    params = SimParams()
    worm = generate_worm_scene(params)
    tmp = tempfile.mkdtemp(prefix="sph_runtime_")
    try:
        graphed.CAPTURES.clear()
        ck, a = runtime_checkpoint(worm, params, tmp, card)
        kernels, launches = runtime_walls(a, params, card)
        del a
        runtime_dumps(worm, params, ck, tmp, card)
        runtime_ladder(worm, params, tmp, card)
        runtime_cli(worm, tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(kernels=kernels, launches=launches)


# ---------------------------------------------------------------------------
# the at-scale legs and the locomotion run (phases 22-23)
# ---------------------------------------------------------------------------

def scale_phase(card, profile_steps):
    # 22. ``scripts.bench_scale.measure`` on the 2-worm scene and the
    # dam-break, each on fastw and on fast
    base = SimParams()
    t0 = time.perf_counter()
    worm2 = generate_multi_worm_scene(N_WORMS, base)
    wide = generate_multi_worm_params(N_WORMS, base)
    t_worm = time.perf_counter() - t0
    t0 = time.perf_counter()
    dam = generate_liquid_box_scene(base, fill_fraction=0.8)
    print(f"scale: {N_WORMS}-worm scene {worm2.counts}, n "
          f"{worm2.n_particles}, generated in {t_worm:.1f} s; dam-break "
          f"{dam.counts}, n {dam.n_particles}, generated in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(worm2.n_particles == NATIVE_SCENES["worm2"]["n"],
          f"2-worm scene: {worm2.n_particles} particles")
    check(worm2.layout().springs_elastic_only,
          "the 2-worm scene anchors springs to the walls")
    launches = {}
    for label, scene, params, engine, per_step in (
            ("worm2_fastw", worm2, wide, "fastw", PER_STEP),
            ("worm2_fast", worm2, wide, "fast", PER_STEP_FAST_WORM),
            ("dam_fastw", dam, base, "fastw", PER_STEP_BOX),
            ("dam_fast", dam, base, "fast", PER_STEP_DAM)):
        t0 = time.perf_counter()
        r = bench_scale.measure(label, scene, params, engine=engine,
                                rounds=SCALE_ROUNDS)
        total = time.perf_counter() - t0
        caps = "; ".join(
            f"{c['r_steps']}-step graph: capture + instantiate "
            f"{c['capture_s']:.3f} s, pool {c['pool_bytes']} B "
            f"({c['pool_bytes'] / 2**20:.1f} MiB)" for c in r["captures"])
        bound = r["shell_bound_h"]
        outruns = bound is not None and r["warm_drift_h"] >= bound
        print(f"  {label}: engine {r['engine']}, {r['particles']} particles, "
              f"{r['steps']} timed steps: {r['ms_step']:.4f} ms/step, "
              f"{r['pps']:.6g} particle-steps/s; first chunk "
              f"{r['compile_s']:.3f} s ({caps}); set-up and run "
              f"{total:.1f} s; window drift {r['warm_drift_h']:.4f} h "
              f"(first chunk, outruns the shell: {outruns}), "
              f"{r['drift_h']:.4f} h (timed; shell bound {bound} h); shell "
              f"overflow {r['shell_overflow']}, tile overflow "
              f"{r['tile_overflow']} (tiles sph_tpu's Pallas caps would "
              f"drop; the port's kernels have none); launches a step "
              f"{r['launches']} [{card}]", flush=True)
        check(r["engine"] == engine, f"{label}: ran {r['engine']}")
        check(r["finite"], f"{label}: non-finite state")
        check(r["walls_still"], f"{label}: walls moved")
        check(r["in_box"], f"{label}: liquid left the box")
        check(r["shell_overflow"] == 0,
              f"{label}: shell overflow {r['shell_overflow']}: moving-wall "
              "pairs dropped")
        check(bound is None or r["drift_h"] < bound,
              f"{label}: window drift {r['drift_h']} h past the shell's "
              f"capture bound {bound} h")
        busy, wall, top = runner_profile(r["run"], r["state"], r["springs"],
                                         r["membranes"], 1, top=6)
        print(f"  {label}: profiled chunk: wall {wall:.4f} ms/step "
              f"(profiler on), device busy "
              + ("not measured" if busy is None else
                 f"{busy:.4f} ms/step, idle share {1.0 - busy / wall:.4f}")
              + f" [{card}]", flush=True)
        for name, us, n in top:
            print(f"    {us:10.1f} us/step {n:6.1f} launches/step  "
                  f"{name[:90]}", flush=True)
        for key in set(per_step) | set(r["launches"]):
            check(r["launches"].get(key, 0) == per_step.get(key, 0),
                  f"{label} {key}: {r['launches'].get(key, 0)} launches a "
                  f"step, expected {per_step.get(key, 0)}")
        if label != "dam_fast":          # dambreak_fast holds its counts
            launches[label] = r["launches"]
        del r           # the runner's graph and state, before the next
    return dict(kernels={}, launches=launches)


def runner_profile(run, state, springs, membranes, chunks, top=0):
    """``chunks`` back-to-back runner calls under torch.profiler: (device
    busy ms a step (the kernels' device time summed; None where the
    profiler recorded no kernel), wall ms a step with the profiler on, the
    ``top`` kernels by device time as (name, us a step, launches a
    step))."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    step0 = int(state.step)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(chunks):
            state, _ = run(state, springs, membranes)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    steps = int(state.step) - step0
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    dev_us = sum(e.self_device_time_total for e in kernels)
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    return (dev_us / 1e3 / steps if dev_us else None, wall_ms / steps,
            [(e.key, e.self_device_time_total / steps, e.count / steps)
             for e in ranked])


def locomotion_phase(card, profile_steps):
    # 23. ``scripts.locomotion`` on the full worm, 20,000 steps with the
    # acceptance gate, on fastw (the main path) and on fast (sph_tpu's
    # engine for this run), on the scene of sph_tpu's record
    argv = ["--steps", str(LOCO_STEPS), "--chunk", str(LOCO_CHUNK),
            "--report-every", str(LOCO_REPORT), "--assert-propels",
            "--frames", ""]
    ref = REF_LOCO
    for engine in ("fastw", "fast"):
        out = {}
        t0 = time.perf_counter()
        rc = locomotion.main(argv + ["--engine", engine], out)
        total = time.perf_counter() - t0
        busy_step = runner_profile(out["run"], out["state"], out["springs"],
                                   out["membranes"], LOCO_PROFILE_CHUNKS)[0]
        idle = ("not measured" if busy_step is None
                else f"{1.0 - busy_step / out['ms_step']:.4f}")
        busy_txt = ("not measured" if busy_step is None
                    else f"{busy_step:.4f}")
        print(f"locomotion [{engine}]: {out['steps']} steps of "
              f"{out['particles']} particles in {total:.1f} s: dz "
              f"{out['dz']:+.4f} (sph_tpu {ref['dz']:+.4f}), noise "
              f"{out['noise']:.4f} ({ref['noise']:.4f}), final max strain "
              f"{out['strain']:.4f} ({ref['strain']:.3f}), start "
              f"{out['strain0']:.4f}; {out['verdict']}; elastic bounding box "
              f"{np.round(out['bb0'], 4).tolist()} -> "
              f"{np.round(out['bb1'], 4).tolist()}; {out['ms_step']:.4f} "
              f"ms/step over the loop (reports and the first capture "
              f"included), device busy {busy_txt} ms/step over "
              f"{LOCO_PROFILE_CHUNKS} profiled chunks, idle share {idle}; "
              f"window drift {out['first_drift_h']:.4f} h in the first "
              f"chunk, {out['drift_h']:.4f} h after it (shell bound "
              f"{out['shell_bound_h']} h), overflow {out['overflow']} "
              f"[{card}]", flush=True)
        bound = out["shell_bound_h"]
        if bound is not None:
            print(f"  locomotion [{engine}]: the first period outruns the "
                  f"shell: {out['first_drift_h'] >= bound}", flush=True)
        check(out["engine"] == engine, f"locomotion: ran {out['engine']}")
        check(out["particles"] == NATIVE_SCENES["worm"]["n"],
              f"locomotion: {out['particles']} particles, not the scene of "
              "sph_tpu's record")
        check(rc == 0 and out["passed"],
              f"locomotion [{engine}]: the acceptance gate failed "
              f"({out['verdict']}, strain {out['strain']})")
        check(np.sign(out["dz"]) == np.sign(ref["dz"]),
              f"locomotion [{engine}]: dz {out['dz']} against sph_tpu's "
              f"{ref['dz']}")
        check(out["overflow"].get("shell_overflow", 0) == 0,
              f"locomotion [{engine}]: overflow {out['overflow']}")
        del out         # the runner's graph and state, before the next
    return None


# ---------------------------------------------------------------------------
# the multi-GPU halo engine (phase 24)
# ---------------------------------------------------------------------------

HALO_WORLD = 2           # ranks sharing the card (gloo)
HALO_DEVICE = "cuda:0"   # the ranks' card and the references'
HALO_PERIOD = 5          # the full worm's resort period: two periods a run
HALO_TOL = 1e-4          # positions beyond 3 h of near-coincident pairs
HALO_NEAR_TOL = 1e-2     # positions near them (the reduced worm's rule)
HALO_LIQUID = ("density", "rho_star", "viscsurf", "paccel", "boundary")
HALO_ELASTIC = ("spring", "membrane")


def halo_scene(scene, params, world):
    """(``scene`` padded to ``world * block``, its fast config at
    resort_every ``HALO_PERIOD``, the Simulator's measured halo_pad and
    mig_cap clamped to the rows of one rank)."""
    from sph_tpu_torch.parallel import (measure_halo_pad,
                                        measure_migration_pad,
                                        pad_scene_to_devices)

    kw = dict(resort_every=HALO_PERIOD, block_multiple=math.lcm(8, world))
    block = F.compute_fast_config(scene.pos, params, **kw).block
    scene = pad_scene_to_devices(scene, world * block)
    cfg = F.compute_fast_config(scene.pos, params, **kw)
    per_dev = cfg.n_blocks // world * cfg.block
    pads = dict(
        halo_pad=min(measure_halo_pad(scene.pos, params, cfg), per_dev),
        mig_cap=min(measure_migration_pad(scene.pos, params, cfg), per_dev))
    return scene, cfg, pads


def own_rows(scene, params, cfg, pos, rank, world):
    """The particle ids of ``rank``'s own rows after a replicated resort
    at ``pos`` (-1 for pad rows), in its slab order."""
    pencil, cid = F._cells(torch.as_tensor(pos), params, cfg.dims)
    order = torch.argsort(cid, stable=True).numpy()
    n_loc = cfg.n_blocks // world * cfg.block
    ids = np.full(n_loc, -1, np.int64)
    got = order[rank * n_loc:(rank + 1) * n_loc]
    ids[:len(got)] = got
    return ids


def record_halo_rank(comm, scene, params, cfg, pads, start, names):
    """Rank function: (pass, tables, own, slab, rows the engine uses) of
    the last call of each pair pass in ``names`` in one halo step (the
    replicated resort) from ``start``, recorded on the rank that owns the
    most rows the passes act on (liquid rows for the liquid passes,
    elastic rows for the spring and membrane passes); {} elsewhere."""
    from sph_tpu_torch.parallel import make_halo_fast_multi_step, shard_state
    from sph_tpu_torch.parallel.dryrun import with_start

    state, springs, membranes = scene.device_state(comm.device)
    state = with_start(state, start)
    ptype = np.append(scene.ptype, BOUNDARY_PARTICLE)  # pad rows: walls
    kind = ELASTIC_PARTICLE if "spring" in names else LIQUID_PARTICLE
    counts = [int((ptype[own_rows(scene, params, cfg, start["pos"], r,
                                  comm.world)] == kind).sum())
              for r in range(comm.world)]
    run = make_halo_fast_multi_step(comm, params, scene.layout(), cfg, 1,
                                    halo_pad=pads["halo_pad"])
    calls = {}
    for name, p in list(run.passes.items()):
        def rec(tables, own, slab, _name=name, _p=p):
            calls[_name] = (_p, tables, own, slab)
            return _p(tables, own, slab)
        run.passes[name] = rec
    run(shard_state(state, comm), springs, membranes)
    if comm.rank != int(np.argmax(counts)):
        return {}
    t = ptype[own_rows(scene, params, cfg, start["pos"], comm.rank,
                       comm.world)]
    used = {"viscsurf": t != BOUNDARY_PARTICLE,
            "paccel": t != BOUNDARY_PARTICLE,
            "boundary": t != BOUNDARY_PARTICLE,
            "membrane": t == LIQUID_PARTICLE}
    return {k: (*calls[k], torch.as_tensor(used[k])) if k in used
            else calls[k] for k in names}


def record_end(comm, scene, params, cfg, pads, end):
    """The pair passes' inputs of one halo step from ``end`` (a gathered
    state) on the ranks ``record_halo_rank`` picks: spring and membrane
    from ``end`` as it is, the liquid passes from ``end`` kicked (see
    ``kicked``)."""
    start = {k: getattr(end, k) for k in ("pos", "vel", "muscle_activation",
                                           "step")}
    kick = kicked(end, rest_gap=REST_GAP * params.h)
    kstart = dict(start, pos=kick.pos, vel=kick.vel)
    recorded = {}
    for names, s in ((HALO_ELASTIC, start), (HALO_LIQUID, kstart)):
        recorded.update(record_halo_rank(comm, scene, params, cfg, pads,
                                         {k: v.cpu() for k, v in s.items()},
                                         names))
    return recorded


def timed_comm(comm, once_rows=None):
    """A copy of ``comm`` whose four operations are timed and counted.
    Each call adds its host seconds, from a drained device to its return
    (under nccl, which only enqueues, to its end on the device: so the
    wait for a peer is in them), to ``seconds`` and one to ``calls``, and
    logs (where, op, seconds, bytes sent, bytes received) in ``log``.
    ``where`` is the copy's ``where`` at the call ("resort" until
    ``mark_steps`` moves it), or "call" for an all-gather of ``once_rows``
    rows or more (the distributed resort's entry sort and exit unsort,
    once a call). Bytes, as ``sph_tpu``'s ``scripts/resort_bytes.py``
    counts them: a neighbour send's tensor where the neighbour exists,
    (ranks - 1) x the rank's share of an all-gather, a psum's tensor
    once."""
    import copy

    t = copy.copy(comm)
    t.seconds, t.calls, t.log, t.where = 0.0, 0, [], "resort"
    nccl = comm.backend == "nccl"
    up, down = comm.rank + 1 < comm.world, comm.rank > 0

    def nbytes(name, a):
        b = a.numel() * a.element_size()
        return {"all_gather": ((comm.world - 1) * b,) * 2,
                "psum": (b, b),
                "send_next": (b * up, b * down),
                "send_prev": (b * down, b * up)}[name]

    def timed(name):
        op = getattr(comm, name)

        def call(a, *args, **kw):
            if comm.device.type == "cuda":
                torch.cuda.synchronize(comm.device)
            t0 = time.perf_counter()
            out = op(a, *args, **kw)
            if nccl:
                torch.cuda.synchronize(comm.device)
            dt = time.perf_counter() - t0
            t.seconds += dt
            t.calls += 1
            once = (once_rows is not None and name == "all_gather"
                    and a.dim() > 0 and a.shape[0] >= once_rows)
            t.log.append(dict(where="call" if once else t.where, op=name,
                              seconds=dt, bytes=nbytes(name, a)))
            return out
        return call

    for name in ("all_gather", "psum", "send_next", "send_prev"):
        setattr(t, name, timed(name))
    return t


def mark_steps(run, t):
    """Label ``t``'s log (a ``timed_comm``) by the halo steps of ``run``: a
    step's exchanges, from its first (positions and velocities: the two
    calls just before its density pass) to its last (before its boundary
    pass), are "step"; the rest stays "resort" (the resort and the
    period's drift max)."""
    density, boundary = run.passes["density"], run.passes["boundary"]

    def dens(*args):
        for e in t.log[-2:]:
            e["where"] = "step"
        t.where = "step"
        return density(*args)

    def bnd(*args):
        t.where = "resort"
        return boundary(*args)

    run.passes.update(density=dens, boundary=bnd)


def comm_sums(t):
    """``t.log`` summed by where: {where: dict(seconds, calls, sent,
    recv)}."""
    out = {}
    for e in t.log:
        s = out.setdefault(e["where"], dict(seconds=0.0, calls=0, sent=0,
                                            recv=0))
        s["seconds"] += e["seconds"]
        s["calls"] += 1
        s["sent"] += e["bytes"][0]
        s["recv"] += e["bytes"][1]
    return out


def halo_worm_rank(comm, scene, params, cfg, pads, n_steps):
    """Rank function: the full worm through both resorts twice (the first
    pair compared and counted, the second timed, each with its collectives'
    host time from ``timed_comm``), then the inputs of one step from the
    replicated run's end state recorded as it is (spring, membrane) and
    kicked (the liquid passes; see ``kicked``)."""
    from sph_tpu_torch.parallel.dryrun import halo_runs
    from sph_tpu_torch.parallel.sharded import gather_state

    comm = timed_comm(comm)
    out = []
    end = None
    seconds, calls = 0.0, 0
    for res, rec in halo_runs(comm, scene, params, cfg,
                              [(n_steps, False), (n_steps, True)] * 2,
                              **pads):
        rec.update(comm_seconds=comm.seconds - seconds,
                   comm_calls=comm.calls - calls)
        full = gather_state(res, comm)
        seconds, calls = comm.seconds, comm.calls
        if comm.rank == 0:
            rec.update(pos=full.pos, vel=full.vel, step=full.step)
        out.append(rec)
        if end is None:
            end = full
    return dict(runs=out,
                recorded=record_end(comm, scene, params, cfg, pads, end))


def halo_compare(ref_pos, pos, near, label):
    """The reduced worm's rule: HALO_TOL beyond 3 h of near-coincident
    pairs, HALO_NEAR_TOL everywhere; returns (max, max beyond)."""
    d = np.abs(pos - ref_pos).max(1)
    far_max = float(d[~near].max())
    n_over = int((d > HALO_TOL).sum())
    print(f"  {label}: max |dpos| {float(d.max()):.3e} ({n_over} rows "
          f"beyond {HALO_TOL:g}), {far_max:.3e} beyond 3 h of the "
          f"{int(near.sum())} rows near coincident pairs; bitwise "
          f"{bool(np.array_equal(pos, ref_pos))}", flush=True)
    check(far_max <= HALO_TOL and float(d.max()) <= HALO_NEAR_TOL,
          f"{label}: max |dpos| {float(d.max())}, {far_max} away from the "
          "near-coincident pairs")
    return float(d.max()), far_max


def fast_reference(scene, params, cfg, n_steps, dev):
    """The fast engine on one card from the scene's start: (its positions
    after ``n_steps``, {cuda_graph: ms/step of a second run})."""
    state, springs, membranes = scene.device_state(dev)
    timings = {}
    for graph in (False, True):
        run = F.make_fast_multi_step(params, scene.layout(), cfg, n_steps,
                                     cuda_graph=graph)
        ref = run(state, springs, membranes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(state, springs, membranes)
        torch.cuda.synchronize()
        timings[graph] = (time.perf_counter() - t0) * 1e3 / n_steps
    return ref.pos.cpu().numpy(), timings


def halo_launches(res, i, per_step, n_steps, world, label):
    """Run ``i``'s pair-kernel launches summed over the ranks, held to
    ``world`` x the fast engine's a step; returns them a step."""
    total = {}
    for r in res:
        for k, v in r["runs"][i]["launches"].items():
            total[k] = total.get(k, 0) + v
    for kind, per in per_step.items():
        check(total.get(kind, 0) == per * n_steps * world,
              f"{label} {kind}: {total.get(kind, 0)} launches in "
              f"{n_steps} steps on {world} ranks, expected "
              f"{per * n_steps * world}")
    check(set(total) == set(per_step), f"{label}: launched {sorted(total)}")
    return {k: v / n_steps for k, v in total.items()}


def halo_run_checks(run, n_steps, label):
    """A halo run's overflow counts 0, its step count, finite positions."""
    ovf = {k: int(v) for k, v in run["diag"].items()
           if k.endswith("overflow")}
    check(not any(ovf.values()), f"{label}: overflow {ovf}")
    check(int(run["step"]) == n_steps, f"{label}: step")
    check(np.isfinite(run["pos"]).all(), f"{label}: not finite")


def halo_worm_checks(backend, devices, card):
    """Phase 24 (b) and (c) on ``backend``: returns the launches a step of
    each resort, summed over the ranks."""
    from sph_tpu_torch.parallel import make_halo_fast_multi_step
    from sph_tpu_torch.parallel.comm import Comm
    from sph_tpu_torch.parallel.launch import run_ranks

    params = SimParams()
    scene, cfg, pads = halo_scene(generate_worm_scene(params), params,
                                  HALO_WORLD)
    print(f"halo worm: {scene.counts}, n {scene.n_particles}, cfg {cfg}, "
          f"{pads}, {HALO_WORLD} {backend} ranks on {devices}", flush=True)
    n_steps = 2 * HALO_PERIOD
    t0 = time.perf_counter()
    res = run_ranks(halo_worm_rank, HALO_WORLD, backend, devices, scene,
                    params, cfg, pads, n_steps)
    print(f"halo worm: ranks done in {time.perf_counter() - t0:.1f} s",
          flush=True)

    dev = torch.device(HALO_DEVICE)
    state, springs, membranes = scene.device_state(dev)
    near = worm_near_coincident(scene, params)
    ref_pos, timings = fast_reference(scene, params, cfg, n_steps, dev)
    per_step = {}
    for i, label in enumerate(("replicated", "distributed")):
        run = res[0]["runs"][i]
        halo_run_checks(run, n_steps, f"halo {label}")
        halo_compare(ref_pos, run["pos"], near,
                     f"halo {label} vs fast, {n_steps} steps")
        per_step[label] = halo_launches(res, i, PER_STEP_FAST_WORM, n_steps,
                                        HALO_WORLD, f"halo {label}")
        timed = [r["runs"][i + 2] for r in res]
        ms = max(t["seconds"] for t in timed) * 1e3 / n_steps
        first = max(r["runs"][i]["seconds"] for r in res) * 1e3 / n_steps
        comm_ms = [t["comm_seconds"] * 1e3 / n_steps for t in timed]
        print(f"halo {label} ({backend}, {HALO_WORLD} ranks sharing the "
              f"card): {ms:.4f} ms/step over {n_steps} steps (2 periods, a "
              f"resort each; the rank's second run; its first, compared "
              f"above: {first:.4f}), of it in the collectives (host clock "
              f"from the rank's device drain, so the wait for the other "
              f"rank's share of the card included) "
              f"{', '.join(f'{c:.4f}' for c in comm_ms)} ms/step by rank, "
              f"{timed[0]['comm_calls'] / n_steps:.1f} calls a step; "
              f"launches {per_step[label]} a step, window drift "
              f"{float(run['diag']['window_drift']):.4f} [{card}]",
              flush=True)
    # the halo engine in a world of one on the same card: its own eager
    # cost, no peer and no collective
    one = make_halo_fast_multi_step(Comm(device=dev), params,
                                    scene.layout(), cfg, n_steps, **pads)
    one(state, springs, membranes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one(state, springs, membranes)
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    print(f"fast engine, same config, one card: {timings[False]:.4f} "
          f"ms/step eager, {timings[True]:.4f} ms/step graphed; the halo "
          f"engine in a world of one (replicated resort): {one_ms:.4f} "
          f"ms/step; each over {n_steps} steps [{card}]", flush=True)
    halo_kernels(res, params, dev, "halo")
    return per_step


def halo_kernels(res, params, dev, label):
    """Phase 24 (c): each pair kernel against its plain version on the
    slab inputs a rank recorded (``record_end``)."""
    calls = {}
    for r in res:
        for name, (p, *rest) in r["recorded"].items():
            calls[name] = (p, *(
                tuple(torch.as_tensor(t, device=dev) for t in a)
                if isinstance(a, tuple) else torch.as_tensor(a, device=dev)
                for a in rest))
    check(set(calls) == set(HALO_LIQUID + HALO_ELASTIC),
          f"{label}: recorded {sorted(calls)}")
    elastic_input_counts(params, calls, label, names=HALO_ELASTIC)
    compare(calls, label, box_edge(params))


def worm_near_coincident(scene, params):
    """Rows within 3 h of a liquid row within 0.01 r0 of an elastic row
    (the generated worm's ill-conditioned rows)."""
    p0 = scene.pos
    elastic = scene.ptype == ELASTIC_PARTICLE
    liquid = np.flatnonzero(scene.ptype == LIQUID_PARTICLE)
    d = cKDTree(p0[elastic]).query(p0[liquid])[0]
    near = np.zeros(len(p0), bool)
    for rows in cKDTree(p0).query_ball_point(
            p0[liquid[d < 0.01 * params.r0]], 3.0 * params.h):
        near[rows] = True
    return near


# ---- phase 24 (d): nccl, a card a rank ----
NCCL_DEADLINE_S = 600    # a run_ranks call of (d)
NCCL_SCENES = ("worm", "worm2", "dam")


def nccl_world():
    """(d)'s nccl ranks on this machine: 4 where it has 4 cards or more, 2
    on 2 or 3, 0 (not run) on one."""
    n = torch.cuda.device_count()
    return 4 if n >= 4 else 2 if n >= 2 else 0


def comm_check_rank(comm):
    """Rank function: the four collectives on rank-stamped tensors (the
    halo engine's dtypes and shapes: f32 rows, i64 counts, 0-d sums), and
    the rank's card."""
    r, dev = comm.rank, comm.device
    a = torch.arange(3, dtype=torch.float32, device=dev) + 10 * r
    return dict(
        rank=r, world=comm.world,
        card=torch.cuda.current_device() if dev.type == "cuda" else None,
        gather=comm.all_gather(a[None]),
        gather_int=comm.all_gather(torch.full((2, 2), r, dtype=torch.int64,
                                              device=dev)),
        psum=comm.psum(a), psum0=comm.psum(torch.tensor(r + 1, device=dev)),
        next=comm.send_next(a, -1.0),
        prev=comm.send_prev(a, torch.full((3,), -2.0, device=dev)),
        pmax=comm.pmax(torch.tensor(float(r), device=dev)))


def nccl_comm_check(world, devices):
    """(d0): ``comm_check_rank`` on ``world`` nccl ranks, every result
    held to its value."""
    from sph_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    res = run_ranks(comm_check_rank, world, "nccl", devices,
                    timeout_s=NCCL_DEADLINE_S)
    stamp = [np.arange(3, dtype=np.float32) + 10 * r for r in range(world)]
    for r, out in enumerate(res):
        check(out["rank"] == r and out["world"] == world
              and out["card"] == r, f"nccl rank {r}: {out}")
        check(np.array_equal(out["gather"], np.stack(stamp))
              and np.array_equal(out["gather_int"], np.repeat(
                  np.arange(world), 2)[:, None].repeat(2, 1))
              and np.array_equal(out["psum"], sum(stamp))
              and int(out["psum0"]) == world * (world + 1) // 2
              and np.array_equal(out["next"], stamp[r - 1] if r
                                 else np.full(3, -1.0, np.float32))
              and np.array_equal(out["prev"], stamp[r + 1]
                                 if r + 1 < world
                                 else np.full(3, -2.0, np.float32))
              and float(out["pmax"]) == world - 1,
              f"nccl rank {r}: collectives {out}")
    print(f"halo (d0): the four collectives on {world} nccl ranks, cards "
          f"{[out['card'] for out in res]}: as expected, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def halo_cards_scene(name):
    """(params, scene, the fast engine's launches a step) of (d)'s scene
    ``name``: the full worm, the 2-worm stress scene, the dam-break."""
    base = SimParams()
    if name == "worm":
        return base, generate_worm_scene(base), PER_STEP_FAST_WORM
    if name == "worm2":
        return (generate_multi_worm_params(N_WORMS, base),
                generate_multi_worm_scene(N_WORMS, base), PER_STEP_FAST_WORM)
    return (base, generate_liquid_box_scene(base, fill_fraction=0.8),
            PER_STEP_DAM)


def halo_cards_rank(comm, scene, params, cfg, pads, n_steps, record):
    """Rank function of (d): one discarded run (NCCL forms a pair's
    point-to-point connection at its first exchange), then each resort
    three times from the scene's start, the ranks starting together:
    first under ``timed_comm`` (compared, its launches counted, its
    collectives' host seconds and bytes by where), then twice bare
    (timed). With ``record``, the pair passes' inputs of one more step
    (``record_end``)."""
    from sph_tpu_torch.parallel import make_halo_fast_multi_step, shard_state
    from sph_tpu_torch.parallel.dryrun import _timed
    from sph_tpu_torch.parallel.sharded import gather_state

    state, springs, membranes = scene.device_state(comm.device)
    state_l = shard_state(state, comm)
    n_loc = scene.n_particles // comm.world
    make_halo_fast_multi_step(comm, params, scene.layout(), cfg, n_steps,
                              **pads)(state_l, springs, membranes)
    runs, end = [], None
    for distributed in (False, True):
        traced = timed_comm(comm, n_loc if distributed else None)
        for c in (traced, comm, comm):
            run = make_halo_fast_multi_step(
                c, params, scene.layout(), cfg, n_steps,
                distributed_resort=distributed, **pads)
            if c is traced:
                mark_steps(run, c)
            comm.psum(torch.zeros(1, device=comm.device))
            before = dict(pk.LAUNCHES)
            (res, diag), secs = _timed(
                comm, lambda: run(state_l, springs, membranes))
            rec = dict(diag=diag, seconds=secs, launches={
                k: v - before[k] for k, v in pk.LAUNCHES.items()
                if v != before[k]})
            if c is traced:
                rec["comm"] = comm_sums(c)
                full = gather_state(res, comm)
                if comm.rank == 0:
                    rec.update(pos=full.pos, step=full.step)
                end = full if end is None else end
            runs.append(rec)
    recorded = (record_end(comm, scene, params, cfg, pads, end) if record
                else {})
    return dict(runs=runs, recorded=recorded)


def comm_report(res, i, n_steps, world):
    """Run ``i``'s collectives from every rank's ``comm_sums``: host ms
    and bytes sent and received a step, a resort and (the distributed
    resort's entry and exit) a call, each the largest over the ranks."""
    n_resorts = n_steps // HALO_PERIOD
    per = dict(step=n_steps, resort=n_resorts, call=1)
    out = {}
    for where, div in per.items():
        sums = [r["runs"][i]["comm"].get(where) for r in res]
        if not any(sums):
            continue
        z = dict(seconds=0.0, calls=0, sent=0, recv=0)
        sums = [s or z for s in sums]
        out[where] = dict(
            ms=[s["seconds"] * 1e3 / div for s in sums],
            calls=max(s["calls"] for s in sums) / div,
            sent_mb=max(s["sent"] for s in sums) / div / 1e6,
            recv_mb=max(s["recv"] for s in sums) / div / 1e6)
    return out


def halo_cards_checks(name, world, devices, card):
    """(d) on scene ``name`` at ``world`` nccl ranks: both resorts against
    the fast engine on one card, launches, times and traffic; the pair
    kernels on the worm's slab inputs. Returns the launches a step of
    each resort summed over the ranks, the padded scene, the reference
    positions, the near-coincident rows and the replicated run's
    positions."""
    from sph_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    params, scene, per_step = halo_cards_scene(name)
    scene, cfg, pads = halo_scene(scene, params, world)
    label = f"halo nccl {name}"
    print(f"{label}: {scene.counts}, n {scene.n_particles}, generated in "
          f"{time.perf_counter() - t0:.1f} s, cfg {cfg}, {pads}, {world} "
          f"nccl ranks on {devices}", flush=True)
    n_steps = 2 * HALO_PERIOD
    t0 = time.perf_counter()
    res = run_ranks(halo_cards_rank, world, "nccl", devices, scene, params,
                    cfg, pads, n_steps, name == "worm",
                    timeout_s=NCCL_DEADLINE_S)
    print(f"{label}: ranks done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    dev = torch.device(HALO_DEVICE)
    near = (worm_near_coincident(scene, params) if name != "dam"
            else np.zeros(scene.n_particles, bool))
    ref_pos, timings = fast_reference(scene, params, cfg, n_steps, dev)
    per_resort = {}
    for i, resort in enumerate(("replicated", "distributed")):
        run = res[0]["runs"][3 * i]
        halo_run_checks(run, n_steps, f"{label} {resort}")
        halo_compare(ref_pos, run["pos"], near,
                     f"{label} {resort} vs fast, {n_steps} steps")
        per_resort[resort] = halo_launches(
            res, 3 * i, per_step, n_steps, world, f"{label} {resort}")
        ms = [max(r["runs"][3 * i + j]["seconds"] for r in res)
              * 1e3 / n_steps for j in (1, 2)]
        traced = max(r["runs"][3 * i]["seconds"] for r in res) \
            * 1e3 / n_steps
        traffic = comm_report(res, 3 * i, n_steps, world)
        print(f"{label} {resort}: {ms[0]:.4f} ms/step over {n_steps} steps "
              f"on {world} cards (2 periods, a resort each; the slowest "
              f"rank's, after a warm-up run; the next run: {ms[1]:.4f}; the "
              f"run compared above, with every collective drained: "
              f"{traced:.4f}); launches "
              f"{per_resort[resort]} a step over the ranks; window drift "
              f"{float(run['diag']['window_drift']):.4f} [{world} x {card}]",
              flush=True)
        for where, v in traffic.items():
            print(f"  collectives a {where}: "
                  f"{', '.join(f'{m:.4f}' for m in v['ms'])} ms by rank "
                  f"(host clock, device drained before and after each), "
                  f"{v['calls']:.1f} calls; sent {v['sent_mb']:.4f} MB, "
                  f"received {v['recv_mb']:.4f} MB (the busiest rank)",
                  flush=True)
    print(f"{label}: the fast engine, same config, one card: "
          f"{timings[False]:.4f} ms/step eager, {timings[True]:.4f} ms/step "
          f"graphed, over {n_steps} steps [{card}]", flush=True)
    if name == "worm":
        halo_kernels(res, params, dev, f"halo nccl {world} ranks")
    return dict(launches=per_resort, scene=scene, ref=ref_pos, near=near,
                pos=res[0]["runs"][0]["pos"])


def run_group(cmd, timeout_s, **kw):
    """``subprocess.run(cmd)`` in a session of its own, the whole session
    killed if it outlives ``timeout_s`` (torchrun's and run_ranks's
    children too)."""
    import signal

    p = subprocess.Popen(cmd, start_new_session=True, text=True,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, **kw)
    try:
        out, err = p.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        err += f"\nkilled after {timeout_s} s"
    return subprocess.CompletedProcess(cmd, p.returncode, out, err)


def nccl_scripts(world, worm):
    """(d2, d3): ``multihost_halo --backend nccl`` (2 x 2, four cards)
    and a ``world``-rank torchrun of the CLI on the full worm, rank 0
    printing and writing the checkpoint, whose positions are held to the
    fast engine's by the worm's rule. ``worm``: (d)'s worm results
    (``halo_cards_checks``)."""
    import shutil
    import tempfile

    env = dict(os.environ, PYTHONPATH=REPO)
    if world == 4:
        t0 = time.perf_counter()
        res = run_group([sys.executable, "-m",
                         "sph_tpu_torch.scripts.multihost_halo",
                         "--backend", "nccl"], CLI_TIMEOUT_S, cwd=REPO,
                        env=env)
        tail = res.stdout.strip().splitlines()
        print(f"halo (d2): multihost_halo --backend nccl: exit "
              f"{res.returncode} in {time.perf_counter() - t0:.1f} s; "
              + " | ".join(tail), flush=True)
        check(res.returncode == 0,
              f"multihost_halo --backend nccl: {res.stderr[-2000:]}")
    else:
        print(f"halo (d2): multihost_halo --backend nccl: not run ({world} "
              "cards; it takes 4)", flush=True)
    n_steps = 2 * HALO_PERIOD        # the steps of (d)'s worm runs
    tmp = tempfile.mkdtemp(prefix="sph_nccl_cli_")
    try:
        t0 = time.perf_counter()
        res = run_group(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(world), "-m", "sph_tpu_torch", "run",
             "--scene", "worm", "--steps", str(n_steps),
             "--resort-every", str(HALO_PERIOD), "--report-every",
             str(HALO_PERIOD), "--engine", "halo", "--backend", "nccl",
             "--checkpoint", "ck.npz"], CLI_TIMEOUT_S, cwd=tmp, env=env)
        out = res.stdout
        print(f"halo (d3): torchrun --nproc-per-node {world} -m "
              f"sph_tpu_torch run --engine halo --backend nccl: exit "
              f"{res.returncode} in {time.perf_counter() - t0:.1f} s; "
              + " | ".join(out.strip().splitlines()), flush=True)
        check(res.returncode == 0, f"torchrun cli: {res.stderr[-3000:]}")
        cards = str([f"cuda:{i}" for i in range(world)])
        check("engine: halo" in out
              and f"ranks: {world} nccl ranks on {cards}" in out
              and f"[[ step {n_steps} ]]" in out,
              f"torchrun cli: {out[-2000:]}")
        check(out.count("engine: halo") == 1, "torchrun cli: more than "
              "one rank printed")
        ck = np.load(os.path.join(tmp, "ck.npz"))
        n = worm["scene"].n_particles
        check(int(ck["step"]) == n_steps and len(ck["pos"]) == n
              and np.array_equal(ck["ptype"], worm["scene"].ptype),
              "torchrun cli: the checkpoint's step, rows or types")
        halo_compare(worm["ref"], ck["pos"], worm["near"],
                     f"torchrun cli checkpoint vs fast, {n_steps} steps")
        print(f"  bitwise the replicated nccl run's: "
              f"{bool(np.array_equal(ck['pos'], worm['pos']))}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def halo_nccl(world, card):
    """Phase 24 (d) on ``world`` nccl ranks, a card each: the collectives,
    the dry run, the three scenes, the 2 x 2 chain and the torchrun CLI.
    Returns the scenes' launches a step by path."""
    from sph_tpu_torch.parallel.dryrun import dryrun_multichip

    print(f"halo (d): {world} nccl ranks, a card each; the cards: "
          + " | ".join(card_lines()), flush=True)
    devices = [f"cuda:{i}" for i in range(world)]
    nccl_comm_check(world, devices)
    t0 = time.perf_counter()
    out = dryrun_multichip(world, "nccl", "cuda")
    print(f"halo (d1): dryrun_multichip({world}, nccl, cuda) in "
          f"{time.perf_counter() - t0:.1f} s: errors {out['sharded_err']:.3e}"
          f" / {out['halo_err']:.3e} / {out['distributed_err']:.3e}",
          flush=True)
    launches = {}
    for name in NCCL_SCENES:
        out = halo_cards_checks(name, world, devices, card)
        for resort, counts in out.pop("launches").items():
            launches[f"halo_nccl{world}_{name}_{resort}"] = counts
        if name == "worm":
            worm = out
        del out
    nccl_scripts(world, worm)
    return launches


def halo_phase(card, profile_steps):
    # 24. the multi-GPU halo engine on ranks that share the card, then
    # (d) under nccl on a card a rank where the machine has two or more;
    # the parallel package (torch.distributed, torch.multiprocessing) is
    # imported here, so phases 1-23 run without it
    from sph_tpu_torch.parallel.dryrun import dryrun_multichip

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = dryrun_multichip(HALO_WORLD, "gloo", HALO_DEVICE)
    total = {}
    for rank in out["launches"]:
        for run in rank:
            for k, v in run["launches"].items():
                total[k] = total.get(k, 0) + v
    check(total.get("density", 0) > 0 and total.get("paccel", 0) > 0,
          f"dryrun: the ranks launched {total}")
    print(f"halo (a): dryrun_multichip({HALO_WORLD}, gloo, cuda) in "
          f"{time.perf_counter() - t0:.1f} s, the halo runs' launches over "
          f"the ranks {total}", flush=True)
    per_step = halo_worm_checks("gloo", HALO_DEVICE, card)
    launches = {"halo": per_step["replicated"],
                "halo_distributed": per_step["distributed"]}
    world = nccl_world()
    if world:
        launches.update(halo_nccl(world, card))
    else:
        print(f"nccl: not run ({torch.cuda.device_count()} card)",
              flush=True)
    return dict(kernels={}, launches=launches)


TRACE_STEPS = 30     # one period of the main path under profile_trace
# the spans a graphed fastw period opens (runtime.timing's tracer)
TRACE_SPANS = {"sim.step", "engine.period", "graph.stage", "graph.replay",
               "graph.result", "sim.diag", "sim.sync"}


def trace_phase(card, profile_steps):
    # 25. ``runtime.timing.profile_trace`` on the main path, its Chrome
    # trace read back
    import tempfile

    from sph_tpu_torch.runtime.timing import profile_trace, tracing

    params = SimParams()
    sim = Simulator(generate_worm_scene(params), params, engine="auto",
                    device="cuda")
    period = sim._fast_cfg.resort_every
    sim.step(period - 1)         # the first period a step at a time
    sim.step(1)
    sim.step(period)             # its graph's capture
    with tracing():
        sim.step(period)         # the tracer's graph (marked) captured
    tail = session_tail()
    with tempfile.TemporaryDirectory() as log_dir:
        t0 = time.perf_counter()
        with profile_trace(log_dir):
            sim.step(TRACE_STEPS)
            tail.replay()
        t_trace = time.perf_counter() - t0
        files = [os.path.join(log_dir, f) for f in os.listdir(log_dir)]
        check(len(files) == 1 and files[0].endswith(".pt.trace.json"),
              f"profile_trace wrote {files}")
        size = os.path.getsize(files[0])
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    records = pair_records(kernels)
    names = {e.get("name") for e in events}
    spans = TRACE_SPANS & names
    print(f"trace: {TRACE_STEPS} main-path steps under profile_trace in "
          f"{t_trace:.2f} s (the trace's export included), "
          f"{os.path.basename(files[0])}: {size} B, {len(events)} events, "
          f"{sum(kernels.values())} kernel records of {len(kernels)} "
          f"names; pair-kernel records {records} against launches "
          f"{ {k: v * TRACE_STEPS for k, v in PER_STEP.items()} }; "
          f"program spans {sorted(spans)} [{card}]", flush=True)
    for kind in PER_STEP:
        check(records.get(kind, 0) > 0,
              f"trace: no record of the {kind} kernel in the trace")
    check(spans == TRACE_SPANS, f"trace: no range of the program's spans "
          f"{sorted(TRACE_SPANS - spans)} in the trace")
    return None


# name -> phase(card, profile_steps), in running order; a phase that runs a
# kernel's main path returns its ``kernels`` entries and launches a step
PHASES = {"native": native_phase, "small": small_box_phases,
          "box": box_phases,
          "rworm": reduced_worm_kernels, "rworm_engine": reduced_worm_engine,
          "worm": worm_phases, "small_fast": small_fast_phases,
          "tiny_worm": tiny_worm_phases, "dam": dam_break_phases,
          "fast_worm": fast_worm_phases, "exact": exact_phases,
          "bench": bench_phase, "pack": pack_phase, "ab": ab_phase,
          "graph": graph_phase, "runtime": runtime_phase,
          "scale": scale_phase, "locomotion": locomotion_phase,
          "halo": halo_phase, "trace": trace_phase}


if __name__ == "__main__":
    sys.exit(main())
