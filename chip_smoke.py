#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one GPU.

Run from the repository root:  python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi) and builds the CUDA
   kernels from ``magent_tpu_torch/csrc`` (nvcc, sm_90a);
2. runs one battle 2x1000, B=16 step with the kernel wrappers recording
   their operands, then holds each kernel against its plain PyTorch version
   on those operands (ints exact, floats within the stated atol) and times
   both with CUDA events; prints ``occupant``'s ``pair form`` and
   ``rank_prefix``'s ``rank form`` lines (ms, bound, share of bound, launch
   split, launches per step); holds ``occupant`` (on the split template)
   in every (cluster, warps) split of ``tools/profile_rect.py``'s table on
   the step's operands and on random ones at ragged A, B = 1 and 16, on
   unique and on duplicate cells;
2b. holds the threefry kernel (each draw of ``magent_tpu_torch.random`` on
   a CUDA key) against its plain version on the card and on the CPU, bit
   for bit, one launch per draw, at the benchmark's shapes (``split`` of one
   key and of 64 and 256 env keys, ``fold_in``, the e-greedy ``randint``
   and ``uniform`` at 64 x 1600, the learner's ``randint`` over 716,800
   rows, ``uniform`` (256, 3200) in [0, 1) and [tiny, 1), the snake's food
   ``randint``) and prints a ``rng form`` line each (kernel ms, host us per
   draw, the plain version's ms on the card, bound, share);
2c. holds the GRU cell's kernels (``ops/gru_cell.py``: the gates forward,
   acting and carry forms, and their backward) against their plain
   versions at battle_drqn's [102,400, 512] with bf16 projections, one
   launch each, times each beside its bound (bytes / 3.35 TB/s) and the
   plain version's ms (a ``gru form`` line each), and counts their
   launches over one train step of battle_drqn's own loop (map 200, 64
   worlds of 2x1600, GRU 512 in bf16, rollout 8): 48 forwards and 16
   backwards, 3 and 1 per acting step and group;
3. runs the lockstep path — ``VecGridWorld(battle(200), [1000, 1000],
   n_envs=16)``: reset, warm-up, then timed ``observe_all -> random_actions
   -> transition`` steps — and checks from the launch counters that every
   step went through its four kernels and two threefry launches; times each
   phase synchronized, then profiles a few more steps with torch.profiler
   (device ops and device time per step, busy share, the kernels that take
   the most time);
4. runs the stateful path — ``GridWorld("battle", map_size=125)`` with the
   2x625 armies ``examples/train_battle.py`` places: warm-up, then timed
   ``get_observation x2 -> set_action x2 -> step -> get_reward x2 ->
   clear_dead`` steps; checks from the launch counters that every step
   went through its kernels (``rank_prefix_hp``, ``move_claims`` once,
   ``window_gather`` twice), counts the host syncs per step and profiles a
   few steps; then holds the grid path's kernels against their plain
   versions on the operands of one more step (``window_gather`` at B=1,
   f32), times them and prints ``rank_prefix_hp``'s ``rank form`` line and
   ``move_claims``' ``pair form`` line; holds ``move_claims`` (on the split
   template, the pairs i < j alone) in every split on the step's operands
   and on random ones at ragged A with one shared sentinel;
4b. runs train_tiger's loop — ``GridWorld("double_attack")`` placed as
   ``examples/train_tiger.py`` places it (walls, deer and tigers on 4%, 5%
   and 1% of the cells), deer acting at random, each tiger with a deer in
   its attack range attacking it through the ``view2attack`` table, the
   rest at random: at map 500 (12,500 + 2,500 agents, A = 20,480 slots:
   the grid path's sort branches; both groups' 6.31 MB images take
   ``window_gather_banded``) and at map 400 (A = 10,240: the pair kernels,
   ``window_gather``): warm-up, 20 timed ``get_observation x2 ->
   set_action x2 -> step -> get_reward x2 -> clear_dead`` steps, launches
   per step from the counters (map 500: ``window_gather_banded`` 2, no
   pair kernel; map 400: ``rank_prefix_hp`` 1, ``move_claims`` 1,
   ``window_gather`` 2), the ordered tiger pairs the double-attack rule
   paid (more than 0), host syncs, the profiler and the loop's peak
   memory; at map 500 the rule built as ``GeneralRule`` (4 blocks of
   2,048 x 2,048 tiger slots) on a step's state, exactly equal to the
   compiled ``PairSharedObjectRule``, with its device time and peak
   memory; then the path's kernels against their plain versions on one
   more step's operands with their ``window form``, ``rank form`` and
   ``pair form`` lines, and ``move_claims`` in every split at A =
   10,240; later phases report their peak memory from the end of this
   one;
4c. runs train_pursuit's loop — ``GridWorld("pursuit")`` placed as
   ``examples/train_pursuit.py`` places it (3% walls, 1.25% 2x2 predators,
   2.5% prey) — at map 1000 (A = 49,152: the sort branches, both groups on
   ``window_gather_banded``) and map 500 (A = 12,288: ``rank_prefix_hp``),
   20 timed steps each with the launch counts, host syncs, the profiler
   and peak memory, ``cell_slot`` against its rebuild from the positions,
   and the path's kernels against their plain versions;
4d. runs turn mode at ``scripts/bench_pursuit.py --turn``'s geometry, the
   script's config and placements copied here (predators facing at random):
   the lockstep loop at map 1000, one world (A = 37,500: the sort branches
   and the turn phase; both groups' four-band stacked images, ~90 MB each,
   through ``window_gather_banded``) and at map 64 with B=16 (caps [51,
   102]: ``rank_prefix_hp``, the stacked images through ``window_gather``):
   20 timed steps each with the launch counts per step asserted, host
   syncs, phase times, the profiler and the loop's peak memory;
   ``cell_slot`` after them equal to its rebuild from positions, facings
   and body sizes, and all four facings among the live agents; the window
   kernel on the stacked images' recorded operands against its plain
   version in f32 and bf16 (``window form`` lines) and ``rank_prefix_hp``
   at map 64; then GPU = CPU, exactly, for map 64 (B=16, 3 steps), map 1000
   (2 steps) and the golden ``turn_bodies`` layout through ``GridWorld``
   on both grid routes;
4e. runs the reference-order engines and the snake: every C++ GridWorld
   golden of ``tests/golden/scenarios.py`` through ``run_scenario`` with
   ``GridWorld(engine_mode="sequential")`` on the card (the step on the
   host, ``core/seq_engine.py``; the observation through the window
   kernels) and ``snake_basic`` through ``run_snake_scenario`` by the
   port's sequential snake (host NumPy), each held to its golden with
   ``tests/test_reference_parity.py``'s and ``tests/test_snake_parity.py``'s
   assertions; the sequential GridWorld at train_battle's width (map 125,
   2x625): 20 timed steps (wall ms, host ms in ``SequentialEngine.step`` and
   in the state's round trip, launches per step asserted: ``window_gather``
   2, nothing else), host syncs, the profiler, ``window_gather`` against its
   plain version on one step's operands, and GPU = CPU over 5 steps with
   the armies interleaved; the fast ``DiscreteSnake`` at the JAX package's
   defaults (map 100, view 21 x 21, 256 slots, rings of 48; 100 walls, 500
   food, 256 snakes, seed 0): 50 timed ``get_observation -> set_action ->
   step -> clear_dead`` steps (``window_gather`` 1 and threefry 4 per step,
   nothing else), host syncs, the profiler (device ops per step with the
   threefry kernel fewer than with the draws' plain version on the card),
   ``window_gather`` against its plain version at the snake's shape, and
   GPU = CPU over 20 steps (every state field, the threefry key included,
   views, features, rewards);
5. runs pursuit's gridless rect path, the lockstep loop of
   ``scripts/train_evidence.py`` — ``VecGridWorld(pursuit(64), [51, 102],
   n_envs=16)`` with its placements (seed 11): holds ``occupant_rect``
   (with and without ``exclude_self``), ``rect_first_overlap`` (both gates)
   ``window_gather4`` (no epilogue, liveness, minimap + self mark +
   liveness) and ``rank_prefix`` against their plain versions on one
   step's operands, prints each rect and rank form's ms, bound, share of
   bound, launch split (cluster and warps, ``rect_split``) and launches
   per step, and each ``window form`` line (ms, bound, share, the span
   split, launches per step from the counters), times the loop (launches
   per step: occupant_rect 1, rect_first_overlap 2, rank_prefix 1,
   window_gather4 2), counts host syncs and profiles it;
6. runs the same path on one world at ``scripts/bench_pursuit.py``'s
   density, map 500 (A = 9375): the rect kernels' and ``rank_prefix``'s
   checks and per-form lines at those shapes (``rank_prefix`` also with
   runs of slots sharing a target and random damage, since pursuit deals
   none) and ``window_gather4`` by a direct call on the map-500 image;
   records the step's ``window_gather_banded`` calls (slot order with the
   observation's liveness epilogue) and its forms off the path (no
   epilogue; a seeded minimap, self cells and liveness; band order), held
   in phase 7; then 20 timed steps, whose 6.41 MB images take
   ``window_gather_banded`` (launches per step: occupant_rect 1,
   rect_first_overlap 2, rank_prefix 1, window_gather_banded 2); and, once
   phase 7's loop has reported its peak device memory (their plain
   versions hold up to ~13 GB), both rect kernels in both forms against
   their plain versions on ``tools/profile_rect.py``'s ragged random and
   adversarial operands (A from 1 to 16,384);
7. runs pursuit at its reference scale, one world at map 1000 (A = 37,500,
   seed 5), which takes the y-segmented sweeps and the banded gather: holds
   ``occupant_rect_seg``, ``rect_first_overlap_seg`` (both gates),
   ``rank_prefix_seg`` and ``window_gather_banded`` against their plain
   versions on one step's operands (the banded gather in its path's form
   and the three off the path, here and at map 500, with a ``window
   form`` line each; the occupant with random hp, the rank
   sweep with random damage, and also with runs of sorted rows sharing a
   target, since pursuit's hp and damage are constant), and the three
   sweeps' overflow branch on the first 3000 sorted rows of those forms
   with a window of 512 rows; holds ``occupant_rect_seg`` and
   ``rank_prefix_seg`` (on the split template) in every
   (cluster, warps) split of ``tools/profile_rect.py``'s table on each of
   those forms, and prints a ``seg form`` line per form (ms, bound, share
   of bound, the split ``seg_split`` picks, launches per step); times 20
   steps (launches per step:
   occupant_rect_seg 1, rect_first_overlap_seg 2, rank_prefix_seg 1,
   window_gather_banded 2, nothing else; 2 plans), counts the timed steps
   whose plans overflowed (read after the window), checks the host syncs
   per step against the map-500 loop's, and profiles it;
8. runs the window-gather cost ladder (``magent_tpu_torch.tools.
   profile_window``, the port of ``scripts/profile_window.py``) at the
   script's geometry (map 200, C=5, 13x13, B=16, N=2048, chunks of 200):
   holds each of its six levels and ``shared`` against its plain version
   and ``ladder(mask)`` against ``window_gather4`` (all exact), then, with
   the launch counters set to 0, times every variant, ``window_gather4``
   without and with its epilogue included, and prints each one's bound and
   each level's increment over the one before;
9. runs the fused trainers at ``scripts/bench_train.py``'s geometry —
   battle 2x1000, map 200, B=16, bf16 views (``obs_dtype``) and a bf16 net
   trunk, rollout 8, 4 train steps per call, ``ClipAdam(1e-4, 5)``, target
   refresh every 40, eps 0.3: holds the bf16 forms of the three window
   kernels against their plain versions (``window_gather`` on the
   trainer's operands, B=16, and on their first env, B=1;
   ``window_gather4`` on phase 5's map-64 forms, ``window_gather_banded``
   on phase 7's map-1000 forms, each with its ``window form`` line),
   checks that bf16 views are the f32 views rounded (battle 2x1000,
   pursuit map 64), then runs ``dqn`` (``train_minibatch=16384``) and
   ``dqn_remat`` (``sample_steps=2``) from the trusty battle checkpoints
   (``params_from_flax``), ``a2c`` (no CommNet) and ``drqn``
   (``share_acting``, ``unroll_remat="all"``) from fresh nets (flax's
   initializers from seeded ``torch.Generator``s): one warm call and 3
   timed calls each, with trained agent-steps/s, ms per train step split
   into rollout and learner, host syncs, device ops and the kernels'
   device time per train step (torch.profiler), peak device memory, and
   the launch counts per train step (bf16 ``window_gather`` 2 per env
   step, plus 4 per sampled step in remat and 2 for A2C's bootstrap;
   ``occupant``, ``rank_prefix``, ``move_resolve`` 1 per env step); then
   one step of each trainer on the GPU and on the CPU at a small size
   (f32, TF32 off; eps 1.0 for the Q trainers; A2C's draws all clear of
   ties by 1e-5; DRQN's hiddens too);
10. runs 4 steps at battle map 64, 2x200, B=4, 6 GridWorld steps at battle
    map 40, 2x64, 8 double_attack GridWorld steps at map 60 (train_tiger's
    layout, pair kernels) and at map 20 (the golden layout, sort branches
    forced) and 3 at map 500 (sort branches; ordered tiger pairs paid in
    all: more than 0), 4 steps of pursuit map 64, B=16 without and with 3%
    interior walls, 4 steps of pursuit's one world at map 662 (A =
    16,434: the segmented sweeps and the banded gather), and 4 steps of
    battle map 64, 2x200, B=4 with bf16 views forced onto the banded route
    (its minimap epilogue), on the GPU and on the CPU from the same keys
    and actions, and asserts equal states, views and features;
11. runs the model layer at ``examples/train_battle.py``'s width —
    ``GridWorld("battle", map_size=125)`` with the 2x625 armies, two
    ``ProcessingModel``s of ``DeepQNetwork`` with ``build_alg("dqn")``'s
    hyperparameters (batch 256, memory 2**20, target_update 1200,
    train_freq 5, lr 1e-4) loaded from the bundled trusty checkpoints:
    20 timed ``get_observation -> infer_action(eps 0.1) -> set_action ->
    step -> get_reward -> sample_step -> clear_dead`` steps (ms per env
    step split into env, inference and sampling; launches per env step
    asserted: ``window_gather`` 2, ``rank_prefix_hp`` 1, ``move_claims``
    1), host syncs, the profiler, then one ``train()`` per model (ms and
    host syncs per batch; device ops and device ms per batch from the
    profiler) and peak memory; the same for ``AdvantageActorCritic`` and
    ``DeepRecurrentQNetwork`` from fresh seeded nets (10 steps); the views'
    NumPy round trip (card -> host -> card) timed; both trusty checkpoints
    saved and reloaded bit for bit; a ``SubprocessModel`` whose spawned
    worker holds the card: act (equal to a ``ProcessingModel``'s), sample,
    train, save, load, quit; then GPU = CPU for each kind over one round
    (DQN 5 steps, A2C and DRQN 3; episode buffers of 100 agents) and one
    ``train()`` per model (``tests/_torch_model_play.py``'s loop and
    near-tie rule; the trainers' tolerances per Adam step);
12. runs rendering (pygame is never imported): (a) phase 4's world and
    loop with ``set_render_dir`` and ``render()`` after each step: ms per
    step with and without it, ms per rendered frame, host syncs per frame
    (sync debug mode), bytes written per frame, launches per step asserted
    (``window_gather`` 2, ``rank_prefix_hp`` 1, ``move_claims`` 1), then
    a second episode and a render query; (b) ``BattleServer()`` at its
    defaults (map 125, eps 0.05, the trusty checkpoints asserted loaded):
    ``get_info``, 20 timed ``get_data`` frames over the whole map (ms per
    frame split into env step, inference and render info; syncs and
    launches per frame, the launches asserted as in (a)), ``get_banners``
    and ``get_status``; ``ArrangeServer()`` at its defaults (map 100,
    ``RandomActor``) for 10 frames, each drawing the absorbed goal markers
    and no other; (c) GPU = CPU: (a)'s calls replayed on a CPU
    ``GridWorld`` (``tests/_torch_render_replay.py``) write the same
    ``config.json``, ``video_1.txt`` and ``video_2.txt`` byte for byte;
    the card server's first 10 frames equal a CPU server's playing the
    card models' actions; the fast ``DiscreteSnake`` at phase 4e's
    defaults rendered for 20 steps, replayed on the CPU, the same files;
13. runs the examples (``magent_tpu_torch/examples``), the second backend
    (``builtin/th_model``) and the scale scripts: (a) the second backend's
    DQN and A2C (``build_alg(..., backend="torch")``) on train_battle's
    loop at map 125, 2x625 (20 and 10 timed steps, ms per env step split
    into env, inference and sampling, launches per step asserted, syncs,
    one ``train()`` per model with its syncs per batch), GPU = CPU over one
    round of 5 steps and one ``train()`` (episode buffers of 100 agents;
    phase 11's tolerances and near-tie rule), and a ``thdqn``/``tha2c``
    checkpoint saved on the card loaded on the CPU bit for bit; (b) every
    training example at its default map through its ``setup`` (battle,
    single, against, multi at 125, trans at 60, gather at 200, pursuit at
    1000, tiger at 500, arrange at 100), one untrained round of 20 steps at
    round 0's eps: ms per step, launches per step asserted from the
    counters against the routes' kernels; ``train_battle_fused`` at its
    defaults (map 64, B=16), one train step per algorithm, launches
    asserted; (c) the reference harness's nine candidates
    (``scripts/test/test_examples.py``) at their sizes with ``--train``,
    cut to 20 steps, on both backends; (d) ``python -m
    magent_tpu_torch.examples.train_battle --train --n_round 1 --map_size
    32`` in a subprocess: exit 0 and its round-0 log line; (e) ``test_1m``
    at 1,000,000 agents (host loop: FPS, per-phase times, the engine's
    route, the copies' share of the step, peak memory, a profiled step;
    ``--vectorized --n_envs 1``), ``test_mega`` at 1M over 64 envs with
    ``--observe`` in f32 and bf16, each window kernel they launch held
    against its plain version at those shapes and timed beside its bound,
    and GPU = CPU for test_1m's world at 10,000 agents over 5 steps (every
    state field);
14. runs sharding (``parallel/sharding.py``): (a) on a one-rank mesh
    (``make_mesh()``: the card, nccl) at scripts/bench_train.py's
    geometry, the ``dqn`` fused trainer placed by ``param_sharding`` over
    2 train steps and the lockstep loop from a state placed by
    ``state_sharding`` over 20 steps, each equal to the unsharded run bit
    for bit (the trainers on cuDNN's deterministic algorithms); (b) two
    gloo ranks sharing the card (this script with ``--shard-rank``,
    started through ``examples/launch_multihost.py``'s poller, each under
    ``timeout``) run launch_multihost's ``--mode env``, ``--mode train``
    at dp=2 and at dp=1 x tp=2 (map 64, 2x64, 4 envs): every rank's env
    rows equal the one-process run's, losses within TRAIN_LOSS_RTOL, the
    gathered parameters and moments by the Adam rule, and each rank's
    kernel calls of one lockstep step held against their plain versions;
    (c) ``python -m magent_tpu_torch.examples.test_scaling`` at its
    defaults (map 200, 2x1000, 8 envs, 32 steps): its one point; (d)
    ``DeepQNetwork(num_gpu=2)`` caps at the one card, and two replicas on
    it (``devices=["cuda:0"] * 2``) act as the unsharded model;
15. runs the driving scripts (``magent_tpu_torch/tools``, ``/examples``,
    ROADMAP item 22), each through its ``main`` at its own widths, the
    launch counters set to 0 before it and read after, and one sample of
    each path's kernel calls held against the plain versions: (repair)
    each trainer at bench_train's geometry twice from one key, bit for
    bit (``deterministic_convolutions``), ``dqn`` f32 and bf16 also on
    cuDNN's defaults (parameters that differ, ms per train step either
    way, the learn half's device ms either way), ``DeepQNetwork.train``
    twice with and without the repair at the card test's size, and a
    deterministic-algorithms scan of one f32 step each;
    (22a) ``tools.bench``, ``tools.bench_train`` (all four trainers) and
    ``tools.bench_pursuit`` (map 1000, default and ``--turn``) at their
    defaults; (22b) ``examples.train_evidence`` on pursuit, gather and
    tiger at map 64, B=16, then ``tournament_pursuit`` over pursuit's
    generations, ``eval_checkpoint`` with ``trusty-battle-game-l`` at its
    map 64 and ``tournament`` over two of its epochs at its map 125 (the
    depth cuts printed); (22c) ``profile_phases``, ``profile_sweep``,
    ``profile_micro`` and ``profile_banded`` at their defaults, one step of
    each ``profile_phases`` variant and one iteration of each
    ``profile_banded`` variant held (``profile_drqn`` runs in phase 16);
    (22d) both
    fuzzers (the port's leg on the card against its leg on the CPU),
    ``diff_seg_chip`` at n=6000 and n=20000 (the segmented sweeps engaged
    there, bit for bit) and ``search`` cut to one round of one algorithm;
16. runs the JAX profilers' split variants and the trainers' other forms:
    ``tools.profile_drqn``'s 13 variants at its default width (battle
    2x1000, B=16, rollout 8, bf16; ``--calls`` and ``--inner`` cut, as
    printed), one iteration of each held; ``profile_phases one_group
    view_only`` (view_only prints its skip line at battle's windows) with
    one step of ``one_group`` held; ``profile_banded plain`` at 16 x
    62,500, its sink equal to ``fixed_img``'s at the same positions;
    ``profile_micro``'s four primitives; one train step of A2C with CommNet
    nets at bench_train's geometry (ms, launches asserted, its kernel
    calls held); then GPU = CPU at the small size for A2C with CommNet
    and DRQN's other five forms (``share_acting`` x ``unroll_remat``),
    each also twice on the card, bit for bit; each variant's ms printed
    with the card's name and power limit;
17. prints the ``kernels`` JSON line, then ``{"ok": true, "device": ...}``
    as the last line.

Any failure raises (exit code 1).  Without a CUDA device it exits with 2
and prints no result.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import copy
import functools
import gc
import json
import math
import os
import statistics
import shutil
import subprocess
import sys
import tempfile
import time
import types
import warnings

import numpy as np
import torch

from magent_tpu_torch.ops import KERNELS
from magent_tpu_torch.tools import bench, bench_train
from magent_tpu_torch.tools.bench_pursuit import pursuit_config
from magent_tpu_torch.tools.bench_pursuit import placements as pursuit_placements
from magent_tpu_torch.tools.bench_train import fresh_nets, trainer_args
from magent_tpu_torch.tools.profile_gather import window_bytes
from magent_tpu_torch.tools.timing import HBM_BYTES_PER_S, device_ms

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
# battle's full width: the BASELINE.json headline workload (bench.py)
MAP_SIZE, N_PER_GROUP, N_ENVS = 200, 1000, 16
WARMUP_STEPS, TIMED_STEPS, PROFILE_STEPS = 3, 20, 5
# reduced size for the GPU-vs-CPU agreement run
SMALL_MAP, SMALL_N, SMALL_ENVS, SMALL_STEPS = 64, 200, 4, 4
# the stateful path: examples/train_battle.py's map, armies of 625 each
GW_MAP, GW_WARMUP, GW_TIMED, GW_SYNC_STEPS = 125, 10, 60, 5
# reduced size for the GridWorld GPU-vs-CPU run: 2x64 agents, map 40
GW_SMALL_MAP, GW_SMALL_STEPS = 40, 6
# pursuit: the training protocol of scripts/train_evidence.py (map 64,
# B=16; placements seed 11) and the one-world throughput protocol of
# scripts/bench_pursuit.py (map 500; seed 5); interior walls as many as
# examples/train_pursuit.py adds (3% of the cells)
P_MAP, P_ENVS, P_SEED = 64, 16, 11
P_BIG_MAP, P_BIG_SEED = 500, 5
P_WALL_FRAC, P_SMALL_STEPS = 0.03, 4
# pursuit at the reference's own scale (bench_pursuit.py's defaults, map
# 1000, one world), the smallest map whose world takes the segmented sweeps
# (GPU vs CPU), and the overflow check: the first rows of a sorted step
# with a window narrower than a segment, so that every plan overflows
P_SEG_MAP, P_SEG_SEED, P_SEG_SMALL_MAP = 1000, 5, 662
SEG_OVERFLOW_ROWS, SEG_OVERFLOW_WIN = 3000, 512
# plans per map-1000 step: the occupant and both move sweeps share margin
# 4, the rank sweep plans margin 8
SEG_PLANS_PER_STEP = 2
# the rank sweep's dense form: each run of this many sorted rows shares a
# target (the step's attackers rarely share one, so its sums are mostly 0)
SEG_SHARE = 4

# the fused trainers: tools.bench_train's geometry (battle 2x1000 at
# MAP_SIZE, N_ENVS; bf16 views and trunk), its defaults and constants,
# from the trusty checkpoints
_BENCH_TRAIN = bench_train.cli().parse_args([])
TRAIN_ROLLOUT, TRAIN_SPC = _BENCH_TRAIN.rollout, _BENCH_TRAIN.steps_per_call
TRAIN_SAMPLE_STEPS = _BENCH_TRAIN.sample_steps
TRAIN_TARGET_UPDATE, TRAIN_EPS = bench_train.TARGET_UPDATE, bench_train.EPS
TRAIN_CALLS, TRAIN_LR = bench_train.CALLS, bench_train.LR
TRUSTY = tuple("data/models/trusty-battle-game-%s/tfdqn_0.npz" % side
               for side in "lr")
# bench_train's four algorithms; a2c and drqn have no trusty checkpoint and
# start from tools.bench_train's fresh nets, flax's initializers drawn from
# torch.Generator seeds bench_train.NET_SEED + group
TRAINERS = ("dqn", "dqn_remat", "a2c", "drqn")
TRAINER_NETS = {"dqn": "trusty weights", "dqn_remat": "trusty weights",
                "a2c": "fresh nets (no CommNet)",
                "drqn": "fresh nets, share_acting, unroll_remat all, "
                        "target_update %d, eps %g" % (TRAIN_TARGET_UPDATE,
                                                      TRAIN_EPS)}
# window_gather_bf16 launches per train step beyond the rollout's 2 per env
# step: remat re-renders steps t and t + 1 of both groups per sampled step,
# A2C renders the post-rollout state once for its bootstrap values
LEARNER_VIEWS = {"dqn": 0, "dqn_remat": 4 * TRAIN_SAMPLE_STEPS, "a2c": 2,
                 "drqn": 0}

# phase 11, the model layer: examples/train_battle.py's per-group loop
# (train_battle.py:49-64, the steps of examples/rollout.py:88-200) at its
# map GW_MAP with place_armies' 2x625; build_alg's hyperparameters, copied
# from examples/rollout.py:273-301 (a2c: 10 x the learning rate)
MODEL_HYPER = {
    "dqn": dict(batch_size=256, memory_size=2 ** 20, learning_rate=1e-4,
                target_update=1200, train_freq=5),
    "a2c": dict(batch_size=256, learning_rate=1e-3),
    "drqn": dict(batch_size=256 // 8, unroll_step=8, memory_size=8 * 625,
                 learning_rate=1e-4, target_update=1200, train_freq=5),
}
MODEL_CLASSES = {"dqn": "DeepQNetwork", "a2c": "AdvantageActorCritic",
                 "drqn": "DeepRecurrentQNetwork"}
# timed env steps per kind (dqn from the trusty checkpoints, a2c and drqn
# from fresh nets seeded MODEL_SEED + group), then one train() per model;
# e-greedy eps as the examples' late rounds
MODEL_STEPS = {"dqn": 20, "a2c": 10, "drqn": 10}
MODEL_WARMUP, MODEL_SYNC_STEPS, MODEL_PROFILE_STEPS = 2, 2, 2
MODEL_EPS, MODEL_SEED = 0.1, 0
MODEL_PER_STEP = {"window_gather": 2, "rank_prefix_hp": 1, "move_claims": 1}
# GPU = CPU: one round of this many steps per kind, then one train() per
# model, under the trainers' tolerances (TRAIN_* above), per Adam step
MODEL_CMP_STEPS = {"dqn": 5, "a2c": 3, "drqn": 3}
MODEL_CMP_EPISODES = 100
# the trainers' GPU-vs-CPU step: tests/test_train_fused.py's size, f32
TRAIN_SMALL_MAP, TRAIN_SMALL_CAPS, TRAIN_SMALL_ENVS, TRAIN_SMALL_T = (
    20, [6, 6], 4, 3)
# its tolerances (tests/_torch_train_checks.py): f32 sums in other orders
# on the two devices (losses); the Adam moments to a share of each tensor's
# largest: a ReLU whose input lies within rounding of 0 opens on one device
# and not the other and passes a sample's whole gradient (in one step at
# this size conv1's moments lie 3e-3 of their largest apart); Adam's first
# step moves a parameter by about lr * sign(g), so parameters within
# TRAIN_PARAM_ATOL where the gradient's sign is settled (its moment above
# the moment tolerance), and 2 * lr more elsewhere
TRAIN_LOSS_RTOL, TRAIN_MOMENT_RTOL = 1e-5, 1e-2
TRAIN_PARAM_ATOL = 0.2 * TRAIN_LR
# A2C's draws: equal wherever the top two log(policy) + gumbel scores lie
# further apart than the devices' rounding of softmax and log
# (tests/test_torch_port_a2c.py); DRQN's hiddens after three f32 GRU steps
TRAIN_MARGIN, TRAIN_HIDDEN_ATOL = 1e-5, 1e-5

# The data sheet's 67 TFLOP/s float32 counts an FMA as two operations; the
# kernels here do no FMA and mostly int32 work, so their peaks are taken per
# instruction, from the CUDA C++ Programming Guide's throughput table for
# compute capability 9.0: per SM and clock, 128 float32 adds or multiplies,
# 64 int32 adds, compares or min/max.  Times the SM count and the card's max
# SM clock (nvidia-smi clocks.max.sm): see peak_rates().
F32_PER_SM_CLK, INT32_PER_SM_CLK = 128, 64
# f32 tolerance of the pair sums: the kernel adds in slot order, the plain
# version in its reduction order (tests/test_pairwise_kernels.py:41)
PAIR_ATOL = 1e-5
# pooled minimap fractions may round differently between the CPU and GPU
# reductions; every other view value is a copy
VIEW_ATOL = 1e-6

# the fewest (int32, float32) instructions each pair kernel's formula needs
# per (query, slot) pair: a compare sets a predicate (a second compare ANDs
# into it), a select-and-add is one predicated add, a select-and-min one
# predicated min; shared-memory loads are not counted.
#   occupant      cell == q; for a query that found a slot: cnt += 1, ssum
#                 += i | hsum += hp, charged once per such query (the warp
#                 updates its queries only where a lane matched; in the
#                 engine a query matches at most one slot)
#   rank_prefix   tgt == t; AND rank < r                  | p += dmg
#   move_resolve  i = i0 + k; same; AND i < j; cnt += ; head = min(head, i);
#                 cell == t; AND i != j; ocnt += ; osum += i
#   move_claims   over the pairs i < j alone (head <= j: a slot matches
#                 itself): same; cnt += ; head = min(head, i)
# rank_prefix_hp is rank_prefix's sweep; its hp_t is one load per query,
# charged as bytes (hp read, hp_t written).
#   occupant_rect       four edge compares; best = i (i = i0 + k)  | hsum += hp
#                       (exclude_self: its compare only on the pairs of a
#                       query tile's own slots, A per call)
#   rect_first_overlap  four edge compares that AND into one predicate (an
#                       empty rect's edge moved out of reach when staged);
#                       key = max(X - qX, 0) + max(Y - qY, i) from per-body
#                       and per-query terms formed once (X = x * MB *
#                       stride, Y = y * stride + i): two add-max, one add;
#                       a predicated min (lower_only: only the pairs i < j;
#                       the gate compare, as above, on the tile's own slots)
# rect_first_overlap_seg and rank_prefix_seg need the same per pair over
# the pairs of each segment's window.
#   occupant_rect_seg   four edge compares per pair; a matching pair also
#                       takes a max of the slot id and an f32 add (the
#                       window is not in slot order; the warp updates its
#                       queries only where a lane matched), charged once
#                       per query that found a body (the engine's bodies
#                       never overlap: one match each)
PAIR_OPS = {"occupant": (1, 0), "rank_prefix": (2, 1), "move_resolve": (9, 0),
            "rank_prefix_hp": (2, 1), "move_claims": (3, 0),
            "occupant_rect": (5, 1), "rect_first_overlap": (8, 0),
            "occupant_rect_seg": (4, 0), "rect_first_overlap_seg": (8, 0),
            "rank_prefix_seg": (2, 1)}
SEG_SWEEPS = ("occupant_rect_seg", "rect_first_overlap_seg",
              "rank_prefix_seg")
REPLACES = {
    "window_gather": "magent_tpu/ops/window_gather.py:167",
    "occupant": "magent_tpu/ops/attack_prefix.py:99 (occupant_tpu :285-322)",
    "rank_prefix": "magent_tpu/ops/attack_prefix.py:99 "
                   "(rank_prefix_tpu no-hp form :184-199)",
    "move_resolve": "magent_tpu/ops/attack_prefix.py:99 "
                    "(move_resolve_tpu :346-393)",
    "rank_prefix_hp": "magent_tpu/ops/attack_prefix.py:99 "
                      "(rank_prefix_tpu hp form :152-182)",
    "move_claims": "magent_tpu/ops/attack_prefix.py:99 "
                   "(move_claims_tpu :223-256)",
    "occupant_rect": "magent_tpu/ops/attack_prefix.py:99 "
                     "(occupant_rect_tpu :430-501)",
    "rect_first_overlap": "magent_tpu/ops/attack_prefix.py:99 "
                          "(rect_first_overlap_tpu :586-675)",
    "window_gather4": "magent_tpu/ops/window_gather.py:334, :370 "
                      "(window_gather4 :187-387)",
    "occupant_rect_seg": "magent_tpu/ops/attack_prefix.py:901 "
                         "(_occupant_rect_core :864-912, occupant_rect_seg "
                         ":915-942)",
    "rect_first_overlap_seg": "magent_tpu/ops/attack_prefix.py:735 "
                              "(_rect_overlap_core :678-748, "
                              "rect_first_overlap_seg :814-861)",
    "rank_prefix_seg": "magent_tpu/ops/attack_prefix.py:971 "
                       "(_rank_prefix_core :945-980, rank_prefix_seg "
                       ":983-1007)",
    "window_gather_banded": "magent_tpu/ops/window_gather.py:543 "
                            "(window_gather_banded :477-590)",
    "window_ladder": "scripts/profile_window.py:159 (ladder :111-174)",
    "window_shared_tile": "scripts/profile_window.py:214 "
                          "(shared_tile :178-229)",
    "window_gather_bf16": "magent_tpu/ops/window_gather.py:167 "
                          "(window_gather, out_dtype=bfloat16: store :154)",
    "window_gather4_bf16": "magent_tpu/ops/window_gather.py:334, :370 "
                           "(window_gather4, out_dtype=bfloat16: stores "
                           ":329, :365)",
    "window_gather_banded_bf16": "magent_tpu/ops/window_gather.py:543 "
                                 "(window_gather_banded, out_dtype="
                                 "bfloat16: store :538)",
}
# the kernels' device symbols, as the profiler names them
SYMBOLS = {
    "window_gather": "window_gather_kernel<float, 0, 0>",
    "window_gather_bf16": "window_gather_kernel<__nv_bfloat16, 0, 0>",
    "occupant": "occupant_kernel",
    "rank_prefix": "rank_prefix_kernel<false>",
    "rank_prefix_hp": "rank_prefix_kernel<true>",
    "move_resolve": "move_resolve_kernel", "move_claims": "move_claims_kernel",
    "occupant_rect": "occupant_rect_kernel",
    "rect_first_overlap": "rect_first_overlap_kernel",
    "window_gather4": "window_gather_kernel<float, 1,",
    "window_gather4_bf16": "window_gather_kernel<__nv_bfloat16, 1,",
    "occupant_rect_seg": "occupant_rect_seg_kernel",
    "rect_first_overlap_seg": "rect_first_overlap_seg_kernel",
    "rank_prefix_seg": "rank_prefix_seg_kernel",
    "window_gather_banded": "window_gather_kernel<float, 2,",
    "window_gather_banded_bf16": "window_gather_kernel<__nv_bfloat16, 2,",
    "window_ladder": "window_ladder_kernel",
    "window_shared_tile": "window_shared_tile_kernel",
    "threefry": "threefry_kernel",
    "gru_cell": "gru_cell_kernel<",
    "gru_cell_backward": "gru_cell_backward_kernel<",
}
SOURCES = {
    "window_gather": "magent_tpu_torch/csrc/window_gather.cu",
    "occupant": "magent_tpu_torch/csrc/pair_kernels.cu",
    "rank_prefix": "magent_tpu_torch/csrc/pair_kernels.cu",
    "move_resolve": "magent_tpu_torch/csrc/pair_kernels.cu",
    "rank_prefix_hp": "magent_tpu_torch/csrc/pair_kernels.cu",
    "move_claims": "magent_tpu_torch/csrc/pair_kernels.cu",
    "occupant_rect": "magent_tpu_torch/csrc/pair_kernels.cu",
    "rect_first_overlap": "magent_tpu_torch/csrc/pair_kernels.cu",
    "window_gather4": "magent_tpu_torch/csrc/window_gather.cu",
    "occupant_rect_seg": "magent_tpu_torch/csrc/pair_kernels.cu",
    "rect_first_overlap_seg": "magent_tpu_torch/csrc/seg_kernels.cu",
    "rank_prefix_seg": "magent_tpu_torch/csrc/pair_kernels.cu",
    "window_gather_banded": "magent_tpu_torch/csrc/window_gather.cu",
    "window_ladder": "magent_tpu_torch/csrc/window_ladder.cu",
    "window_shared_tile": "magent_tpu_torch/csrc/window_ladder.cu",
    "window_gather_bf16": "magent_tpu_torch/csrc/window_gather.cu",
    "window_gather4_bf16": "magent_tpu_torch/csrc/window_gather.cu",
    "window_gather_banded_bf16": "magent_tpu_torch/csrc/window_gather.cu",
}
WINDOW_KERNELS = ("window_gather", "window_gather4", "window_gather_banded",
                  "window_gather_bf16", "window_gather4_bf16",
                  "window_gather_banded_bf16")
# the draws' kernel (magent_tpu_torch/random.py on CUDA keys): phase 2b
# holds and times it, the lockstep and snake phases count its launches per
# step; every other launch check covers the path kernels, PATH_KERNELS
RNG_KERNEL = "threefry"
# the GRU cell's kernels (the nets' gates, on no env path): phase 2c holds,
# times and counts them
GRU_KERNELS = ("gru_cell", "gru_cell_backward")
PATH_KERNELS = tuple(k for k in KERNELS
                     if k != RNG_KERNEL and k not in GRU_KERNELS)
# threefry launches per step of the main lockstep loop (random_actions'
# uniform and the engine's attack-order split; its own key lives on the
# host, so that key's split runs the plain version) and of the fast snake
# (its key's split, the food key's split, two randint)
LOCKSTEP_DRAWS, SNAKE_DRAWS = 2, 4
# kernels whose float results equal their plain versions exactly: window
# copies (the epilogue rounds each operation as the plain version does) and
# the rect occupants' hp (bodies are disjoint: one non-zero term)
EXACT = WINDOW_KERNELS + ("occupant_rect", "occupant_rect_seg")


def launch_counts():
    """``ops.launch_counts()`` of the path kernels (PATH_KERNELS)."""
    from magent_tpu_torch import ops

    counts = ops.launch_counts()
    return {k: counts[k] for k in PATH_KERNELS}


def cuda_ms(fn, reps: int) -> float:
    """Time per call of ``fn`` in ms: CUDA events around ``reps``
    back-to-back calls (the host's launch work overlaps the device's, and
    bounds calls shorter than it), median of 3 such batches, after a
    warm-up.  Repeated calls find their inputs in the 50 MB L2, as the main
    path's kernels mostly do."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def band_order_kernel_call(args, kwargs):
    """A call of the banded kernel alone on the band table that
    ``window_gather_banded(*args, **kwargs, unsort=False)`` makes."""
    from magent_tpu_torch.ops import window_gather as wg

    gfull, pos, mask = args
    geo = {n: kwargs[n] for n in ("vh", "vw", "C", "Wp")}
    geo["out_dtype"] = kwargs.get("out_dtype", torch.float32)
    n_bands, _ = wg._band_geometry(gfull.shape[1], geo["vh"],
                                   kwargs["band_rows"])
    pos_pad, _, _ = wg.banded_tables(pos, Wp=geo["Wp"],
                                     band_rows=kwargs["band_rows"],
                                     n_bands=n_bands, chunk=kwargs["chunk"])
    return lambda: wg._banded_launch(gfull, pos_pad, mask, **geo)


def window_split(name, args, kwargs):
    """(vectors per span, spans) of the window kernel's launch for one call
    of entry point ``name`` (``gather_split``; the band-order form over its
    band table)."""
    from magent_tpu_torch.ops import window_gather as wg

    gfull, pos, _ = args
    B, N = pos.shape
    vh, E = kwargs["vh"], kwargs["vh"] * kwargs["vw"] * kwargs["C"]
    if not kwargs.get("unsort", True):
        n_bands, _ = wg._band_geometry(gfull.shape[1], vh,
                                       kwargs["band_rows"])
        N = wg._ceil_to(N, kwargs["chunk"]) + n_bands * kwargs["chunk"]
    out_dtype = kwargs.get("out_dtype", torch.float32)
    per = wg.gather_split(B, N, E, out_dtype, torch.cuda.get_device_properties(
        gfull.device).multi_processor_count)
    return per, len(wg.gather_spans(B, N, E, out_dtype, per))


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def peak_rates():
    """(float32, int32) instructions per second of device 0 at its max SM
    clock; also returns the clock in MHz."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.split()[0])
    sm_clk = torch.cuda.get_device_properties(0).multi_processor_count * \
        mhz * 1e6
    return F32_PER_SM_CLK * sm_clk, INT32_PER_SM_CLK * sm_clk, mhz


def record_operands(step_fn, wrappers):
    """Run ``step_fn`` with each ``(module, name)`` wrapper recording a copy
    of its operands; returns ``{name: [(args, kwargs) per call]}``."""
    captured = collections.defaultdict(list)
    originals = {}
    for module, name in wrappers:
        fn = getattr(module, name)
        originals[(module, name)] = fn

        def rec(*args, _fn=fn, _name=name, **kwargs):
            captured[_name].append((
                [a.clone() for a in args],
                {k: v.clone() if isinstance(v, torch.Tensor) else v
                 for k, v in kwargs.items()}))
            return _fn(*args, **kwargs)

        setattr(module, name, rec)
    try:
        step_fn()
    finally:
        for (module, name), fn in originals.items():
            setattr(module, name, fn)
    return captured


def assert_state_equal(a, b, tag):
    from magent_tpu_torch.core.state import FIELDS

    for name in FIELDS:
        x, y = getattr(a, name).cpu(), getattr(b, name).cpu()
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError("%s: state field %s differs between GPU and "
                                 "CPU" % (tag, name))


def kernel_fns():
    """{name: (kernel wrapper, plain version)} of every entry point."""
    from magent_tpu_torch.ops import attack_prefix as ap
    from magent_tpu_torch.ops import window_gather as wg

    return {
        "window_gather": (wg.window_gather, wg.window_gather_ref),
        "occupant": (ap.occupant, ap.occupant_ref),
        "rank_prefix": (ap.rank_prefix, ap.rank_prefix_ref),
        "rank_prefix_hp": (ap.rank_prefix, ap.rank_prefix_ref),
        "move_resolve": (ap.move_resolve, ap.move_resolve_ref),
        "move_claims": (ap.move_claims, ap.move_claims_ref),
        "occupant_rect": (ap.occupant_rect, ap.occupant_rect_ref),
        "rect_first_overlap": (ap.rect_first_overlap,
                               ap.rect_first_overlap_ref),
        "window_gather4": (wg.window_gather4, wg.window_gather4_ref),
        "occupant_rect_seg": (ap.occupant_rect_seg, ap.occupant_rect_seg_ref),
        "rect_first_overlap_seg": (ap.rect_first_overlap_seg,
                                   ap.rect_first_overlap_seg_ref),
        "rank_prefix_seg": (ap.rank_prefix_seg, ap.rank_prefix_seg_ref),
        "window_gather_banded": (wg.window_gather_banded,
                                 wg.window_gather_banded_ref),
        # the bf16 stores: the same entry points, called with
        # out_dtype=torch.bfloat16 in their operands' kwargs
        "window_gather_bf16": (wg.window_gather, wg.window_gather_ref),
        "window_gather4_bf16": (wg.window_gather4, wg.window_gather4_ref),
        "window_gather_banded_bf16": (wg.window_gather_banded,
                                      wg.window_gather_banded_ref),
    }


def seg_plan(name, args, kwargs):
    """The plan a segmented sweep's call runs on: (S, P, start,
    overflow)."""
    from magent_tpu_torch.ops import attack_prefix as ap

    sort_y = args[-1] if name == "rank_prefix_seg" else args[-2]
    return kwargs.get("plan") or ap._seg_plan(sort_y, kwargs["margin"],
                                              kwargs.get("seg_win"))


def seg_pairs(name, args, kwargs) -> int:
    """The pairs a segmented sweep's call needs on this data: each
    segment's real rows times its window's real rows, or A^2 when the plan
    overflows (every pair is examined: the gates compare slot ids)."""
    from magent_tpu_torch.ops import attack_prefix as ap

    S, P, start, overflow = seg_plan(name, args, kwargs)
    A = args[0].shape[0]
    if bool(overflow):
        return A * A
    first = torch.arange(S, device=start.device) * ap.SEG_ROWS
    rows = (A - first).clamp(max=ap.SEG_ROWS)
    width = (start.long() + P).clamp(max=A) - start.long()
    return int((rows * width).sum())


def pair_work(name, args, kwargs):
    """(pairs, int32 and f32 instructions per pair) of a pair-kernel call:
    the pairs this call's sweep needs (``lower_only`` and ``move_claims``:
    i < j only; the segmented sweeps: :func:`seg_pairs`)."""
    n_int, n_f32 = PAIR_OPS[name]
    if name in SEG_SWEEPS:
        return seg_pairs(name, args, kwargs), n_int, n_f32
    B, A = args[0].shape
    pairs = B * A * A
    if kwargs.get("gate") == "lower_only" or name == "move_claims":
        pairs = B * A * (A - 1) // 2
    return pairs, n_int, n_f32


def hold_call(name, args, kwargs, form, nonzero=False):
    """Hold kernel ``name`` against its plain version on one call's operands
    (ints exact; floats exact for EXACT kernels and the hp form's hp_t, else
    within PAIR_ATOL; with ``nonzero``, the plain version's floats must not
    all be zero) -> (kernel's results, plain results, max abs error)."""
    kernel, plain = kernel_fns()[name]
    got = kernel(*args, **kwargs)
    want = plain(*args, **kwargs)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if len(got) != len(want):
        raise AssertionError("%s: %d results vs plain %d" % (
            name, len(got), len(want)))
    err = 0.0
    n_nonzero = sum(int((w != 0).sum()) for w in want
                    if w.dtype.is_floating_point)
    if nonzero and not n_nonzero:
        raise AssertionError("%s (%s): the plain version's floats are all "
                             "zero; the check would hold any kernel" % (
                                 name, form))
    for k, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError("%s: %s %s vs plain %s %s" % (
                name, tuple(g.shape), g.dtype, tuple(w.shape), w.dtype))
        if g.dtype.is_floating_point:
            e = float((g - w).abs().max()) if g.numel() else 0.0
            exact = name in EXACT or (name == "rank_prefix_hp" and k == 1)
            tol = 0.0 if exact else PAIR_ATOL
            if not e <= tol:
                raise AssertionError("%s (%s): max |kernel - plain| = %g > %g"
                                     % (name, form, e, tol))
            bits = torch.int32 if g.dtype == torch.float32 else torch.int16
            if name in WINDOW_KERNELS and not torch.equal(g.view(bits),
                                                          w.view(bits)):
                raise AssertionError("%s (%s): the windows' bits differ from "
                                     "the plain version's (sign of zero)"
                                     % (name, form))
            err = max(err, e)
        elif not torch.equal(g, w):
            raise AssertionError("%s (%s): integer outputs differ from the "
                                 "plain version" % (name, form))
    return got, want, err


def call_stats(name, args, kwargs, f32_rate, int32_rate, form,
               nonzero=False):
    """:func:`hold_call`, then check that the call launches its kernel
    once, time both, and compute the bound: instructions at ``f32_rate`` /
    ``int32_rate`` per second against bytes at HBM_BYTES_PER_S."""
    kernel, plain = kernel_fns()[name]
    got, want, err = hold_call(name, args, kwargs, form, nonzero)
    n_nonzero = sum(int((w != 0).sum()) for w in want
                    if w.dtype.is_floating_point)
    before = launch_counts()[name]
    kernel(*args, **kwargs)
    if launch_counts()[name] != before + 1:
        raise AssertionError("%s: a call did not launch its kernel once"
                             % name)
    if name.startswith("window_gather_banded") and not kwargs.get("unsort",
                                                                  True):
        # the band-order form: the kernel alone on the call's band table;
        # the entry point's ~53 launches per call (the band tables) would
        # overrun the device's queue of pending launches behind
        # device_ms's spin at 50 calls
        ms = device_ms(band_order_kernel_call(args, kwargs), 50)
        call_ms = device_ms(lambda: kernel(*args, **kwargs), 10)
        call_what = "the entry point's device ops"
    else:
        ms = device_ms(lambda: kernel(*args, **kwargs), 50)
        call_ms = cuda_ms(lambda: kernel(*args, **kwargs), 50)
        call_what = "a call back to back"
    # the segmented sweeps' plain versions read the plan's overflow flag
    # on the host, which device_ms's queued spin cannot outlast
    plain_ms = (cuda_ms if name in SEG_SWEEPS else device_ms)(
        lambda: plain(*args, **kwargs), 5)
    if name in WINDOW_KERNELS:
        io_bytes = window_bytes(name, args, kwargs, got)
        # f32 operations per output element: the mask multiply, the two
        # minimap adds, the liveness multiply
        minimap = any(kwargs.get(n) is not None for n in ("mm_img", "mm"))
        n_f32 = 1 + (2 if minimap else 0) + (
            1 if kwargs.get("act") is not None else 0)
        ops_ms = got[0].numel() * n_f32 / f32_rate * 1e3
    else:
        io_bytes = nbytes(args) + nbytes(got)
        pairs, n_int, n_f32 = pair_work(name, args, kwargs)
        ops_ms = pairs * max(n_int / int32_rate, n_f32 / f32_rate) * 1e3
        if name == "occupant_rect_seg":  # the matches' max and add
            ops_ms += int((want[0] >= 0).sum()) * max(
                1 / int32_rate, 1 / f32_rate) * 1e3
        if name == "occupant":  # the matches' count, slot and hp adds
            ops_ms += int((want[0] >= 0).sum()) * max(
                2 / int32_rate, 1 / f32_rate) * 1e3
    bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
    stats = dict(form=form, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    stats["call_ms"], stats["call_what"] = call_ms, call_what
    if name in WINDOW_KERNELS:
        stats["per"], stats["spans"] = window_split(name, args, kwargs)
    print("kernel %-18s %-34s max_abs_err=%g (%d non-zero floats)  kernel "
          "%.4f ms device (%.4f ms %s)  plain %.4f ms device  bound %.6f ms "
          "(%s; %.4f MB -> %.6f ms, ops -> %.6f ms)  shapes %s" % (
              name, form, err, n_nonzero, ms, call_ms, call_what, plain_ms,
              stats["bound_ms"],
              stats["bound_by"], io_bytes / 1e6, bytes_ms, ops_ms,
              [tuple(a.shape) for a in args]), flush=True)
    return stats


def kernel_row(name, calls, f32_rate, int32_rate, extra=()):
    """The ``kernels`` line's row of entry point ``name``: ``calls`` are the
    ``(args, kwargs, form[, nonzero])`` of one main-path step's calls, whose
    numbers are averaged per launch; ``extra`` are further checked forms
    (other options, other shapes, other values), listed under ``per_call``
    with those of the path (``nonzero``: see :func:`call_stats`)."""
    path = [call_stats(name, a, k, f32_rate, int32_rate, *form)
            for a, k, *form in calls]
    more = [call_stats(name, a, k, f32_rate, int32_rate, *form)
            for a, k, *form in extra]
    top = max(path, key=lambda st: st["bound_ms"])
    row = dict(
        name=name, route="cuda", source=SOURCES[name],
        replaces=REPLACES[name], launches=None,
        max_abs_err=max(st["max_abs_err"] for st in path + more),
        ms=statistics.mean(st["ms"] for st in path),
        plain_ms=statistics.mean(st["plain_ms"] for st in path),
        bound_ms=statistics.mean(st["bound_ms"] for st in path),
        bound_by=top["bound_by"], library_ms=None, per_call=path + more)
    return row


def check_kernels(venv, state, key, f32_rate, int32_rate):
    """Phase 2: each lockstep-path kernel against its plain version on the
    operands the main path gave it."""
    from magent_tpu_torch.ops import attack_prefix as ap
    from magent_tpu_torch.ops import window_gather as wg

    def one_step():
        venv.observe_all(state)
        venv.transition(state, venv.random_actions(key))

    split = ("occupant", "rank_prefix")
    before = launch_counts()
    rec = record_operands(one_step, [
        (wg, "window_gather"), (ap, "occupant"), (ap, "rank_prefix"),
        (ap, "move_resolve")])
    per_step = {n: launch_counts()[n] - before[n] for n in split}
    rows = {}
    form = "battle 2x1000, B=16"
    for name in ("window_gather", "occupant", "rank_prefix", "move_resolve"):
        args, kwargs = rec[name][0]
        rows[name] = kernel_row(name, [(args, kwargs, form)], f32_rate,
                                int32_rate)
    print_split_forms(
        {n: [(rec[n][0][0], {}, per_step[n])] for n in split},
        {n: rows[n]["per_call"] for n in split})
    check_cell_splits("occupant", rec["occupant"][0][0], form)
    del rec
    torch.cuda.empty_cache()
    return rows


# phase 2b: the draws at the benchmark's shapes (h100bench battle_dqn: 64
# battles of 2 x 1600 in the train cell, 256 in the env cell; the
# learner's minibatch of 16,384 rows of 7 x 64 x 1600) and the snake's
# food draw: (form, draw, key shape, arguments)
THREEFRY_FORMS = (
    ("split, one key", "split", (), ()),
    ("split, 64 env keys", "split", (64,), ()),
    ("split, 256 env keys", "split", (256,), ()),
    ("fold_in, one key", "fold_in", (), (1001,)),
    ("randint (64, 1600) over 21, e-greedy", "randint", (),
     ((64, 1600), 0, 21)),
    ("uniform (64, 1600), e-greedy", "uniform", (), ((64, 1600),)),
    ("randint (16384,) over 716,800, learner", "randint", (),
     ((16384,), 0, 716800)),
    ("uniform (256, 3200), random actions", "uniform", (), ((256, 3200),)),
    ("uniform (256, 3200) in [tiny, 1), gumbel's", "uniform", (),
     ((256, 3200), float(np.finfo(np.float32).tiny), 1.0)),
    ("randint (64,) over 100, snake food", "randint", (), ((64,), 0, 100)),
)
# int32 instructions per threefry evaluation, from csrc/threefry.cu: 20
# rounds of an add, a funnel-shift rotation and a xor, 2 + 10 adds of the
# key injections, the parity's 2 xors
THREEFRY_OPS = 74
# evaluations per counter: randint draws hi and lo
THREEFRY_EVALS = {"split": 1, "fold_in": 1, "uniform": 1, "randint": 2}


def check_threefry(int32_rate):
    """Phase 2b: each form of THREEFRY_FORMS on a CUDA key, one launch,
    equal bit for bit to the plain version on the card (the route set to
    the plain version) and on the CPU; the kernel's device ms per launch
    (CUDA events behind a spin), its host us per draw (the call's enqueue
    alone), the plain version's ms on the card (calls back to back), and
    the bound:
    THREEFRY_OPS int32 instructions per evaluation at ``int32_rate``
    against the key and output bytes at HBM_BYTES_PER_S.  Returns the
    ``kernels`` line's row."""
    from magent_tpu_torch import ops
    from magent_tpu_torch import random as rnd
    from magent_tpu_torch.ops import _build

    rng = np.random.default_rng(26)
    per_call = []
    for form, name, key_shape, args in THREEFRY_FORMS:
        draw = getattr(rnd, name)
        key = torch.from_numpy(rng.integers(
            0, 2**32, size=key_shape + (2,), dtype=np.uint64).astype(
                np.int64))
        want = draw(key, *args)
        card = key.cuda()
        route = _build.route
        _build.route = lambda *t: "cpu"
        try:
            plain_card = draw(card, *args)
            plain_ms = cuda_ms(lambda: draw(card, *args), 5)
        finally:
            _build.route = route
        before = ops.launch_counts()[RNG_KERNEL]
        got = draw(card, *args)
        torch.cuda.synchronize()
        if ops.launch_counts()[RNG_KERNEL] != before + 1:
            raise AssertionError("threefry %s: not one launch" % form)
        for other, where in ((plain_card, "the card"), (want, "the CPU")):
            a, b = got.cpu(), other.cpu()
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(
                    a, b):
                raise AssertionError("threefry %s differs from the plain "
                                     "version on %s" % (form, where))
        ms = device_ms(lambda: draw(card, *args), 50)
        t0 = time.perf_counter()
        for _ in range(200):
            draw(card, *args)
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        counters = got.numel() // (2 if name in ("split", "fold_in") else 1)
        ops_ms = counters * THREEFRY_EVALS[name] * THREEFRY_OPS / \
            int32_rate * 1e3
        bytes_ms = (card.numel() * 8 + got.numel() * got.element_size()) / \
            HBM_BYTES_PER_S * 1e3
        st = dict(form=form, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                  host_us=host_us, bound_ms=max(ops_ms, bytes_ms),
                  bound_by="operations" if ops_ms >= bytes_ms else "bytes")
        per_call.append(st)
        print("rng form %-44s kernel %.4f ms device (host %.1f us per draw)"
              "  plain %.4f ms on the card  bound %.6f ms (%s; ops -> %.6f "
              "ms, bytes -> %.6f ms)  share %.3f" % (
                  form, ms, host_us, plain_ms, st["bound_ms"],
                  st["bound_by"], ops_ms, bytes_ms, st["bound_ms"] / ms),
              flush=True)
    return dict(
        name=RNG_KERNEL, route="cuda",
        source="magent_tpu_torch/csrc/threefry.cu",
        replaces="none: magent_tpu_torch/random.py's eager threefry "
                 "(jax.random inside XLA's programs in the JAX package)",
        launches=None, max_abs_err=0.0,
        ms=statistics.mean(st["ms"] for st in per_call),
        plain_ms=statistics.mean(st["plain_ms"] for st in per_call),
        bound_ms=statistics.mean(st["bound_ms"] for st in per_call),
        bound_by=max(per_call, key=lambda st: st["bound_ms"])["bound_by"],
        library_ms=None, per_call=per_call)


# phase 2c: the GRU cell at battle_drqn's shape (h100bench/configs/
# battle_drqn.json: 64 worlds x a group's 1600 agents, state 512, bf16
# projections, f32 state) and its train loop (h100bench/traffic/
# train_drqn.json)
DRQN_MAP, DRQN_GROUP, DRQN_ENVS, DRQN_ROLLOUT = 200, 1600, 64, 8
GRU_ROWS, GRU_WIDTH = DRQN_ENVS * DRQN_GROUP, 512


def _gru_close(got, want, what):
    """f32 within rtol 1e-5 / atol 1e-6 (gradients rtol 1e-4), bf16 within
    one ulp of the plain version -> the largest absolute difference."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError("%s: %s %s, the plain version %s %s" % (
            what, got.dtype, tuple(got.shape), want.dtype, tuple(want.shape)))
    a, b = got.float(), want.float()
    diff = (a - b).abs()
    if want.dtype == torch.float32:
        rtol = 1e-4 if "gradient" in what else 1e-5
        bad = diff > 1e-6 + rtol * b.abs()
    else:
        mag = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
        bad = diff > torch.exp2(torch.floor(torch.log2(mag)) - 7)
    if bool(bad.any()):
        raise AssertionError("%s: %d of %d values differ from the plain "
                             "version beyond the tolerance (max %.3g)"
                             % (what, int(bad.sum()), bad.numel(),
                                float(diff.max())))
    return float(diff.max())


def check_gru_cell(card):
    """Phase 2c: each form of the GRU cell's two kernels at GRU_ROWS x
    GRU_WIDTH against its plain version on the card (``_gru_close``), one
    launch per call; device ms per launch (CUDA events behind a spin), the
    plain version's ms, and the bound: the bytes a launch must move (each
    operand read once, each result written once) at HBM_BYTES_PER_S.  Then
    the launches of one train step of battle_drqn's loop
    (:func:`drqn_cell_launches`).  Returns the ``kernels`` line's two
    rows."""
    from magent_tpu_torch import ops
    from magent_tpu_torch.ops import gru_cell as gc

    dev, N, H = torch.device("cuda"), GRU_ROWS, GRU_WIDTH
    gen = torch.Generator(device=dev).manual_seed(29)

    def normal(scale, dtype=torch.float32):
        return (scale * torch.randn((N, H), generator=gen, device=dev)).to(
            dtype)

    h = normal(0.7)
    proj = [normal(1.5, torch.bfloat16) for _ in range(6)]
    bias = 0.2 * torch.randn((H,), generator=gen, device=dev)
    keep = torch.rand((N, 1), generator=gen, device=dev) > 0.1
    g32, g_out, g_dt = normal(1.0), normal(1.0), normal(1.0, torch.bfloat16)
    # (kernel, form, kernel call, plain call, result names, bytes per
    # element: state 4 and six bf16 projections 12 read, then as named)
    forms = (
        ("gru_cell", "acting, f32 state out (DRQNNet's cell and recompute)",
         lambda: (gc.gru_cell(h, *proj),),
         lambda: (gc.gru_cell_ref(gc.ACT, h, *proj),),
         ("state",), 16 + 4),
        ("gru_cell", "carry with resets (split_unroll's step)",
         lambda: gc.gru_carry(h, *proj, bias, keep),
         lambda: gc.gru_cell_ref(gc.CARRY, h, *proj, bias, keep),
         ("carry", "output", "carry bf16"), 16 + 1 / H + 4 + 4 + 2),
        ("gru_cell_backward", "acting, f32 gradient (BPTT, the acting cells)",
         lambda: gc.gru_cell_backward(gc.ACT, h, *proj, None, None, g32,
                                      None, None, False)[:5],
         lambda: gc.gru_cell_backward_ref(gc.ACT, h, *proj, None, None,
                                          g32)[:5],
         ("r gradient", "z gradient", "in gradient", "hn gradient",
          "state gradient"), 16 + 4 + 8 + 4),
        ("gru_cell_backward", "carry with resets, three gradients in, hn's "
         "f32 out",
         lambda: gc.gru_cell_backward(gc.CARRY, h, *proj, bias, keep, g32,
                                      g_out, g_dt, True),
         lambda: gc.gru_cell_backward_ref(gc.CARRY, h, *proj, bias, keep, g32,
                                          g_out, g_dt),
         ("r gradient", "z gradient", "in gradient", "hn gradient",
          "state gradient", "hn f32 gradient"),
         16 + 1 / H + 4 + 4 + 2 + 8 + 4 + 4),
    )
    per_call = {name: [] for name in GRU_KERNELS}
    for name, form, kernel, plain, results, per_elem in forms:
        before = ops.launch_counts()[name]
        got = kernel()
        torch.cuda.synchronize()
        if ops.launch_counts()[name] != before + 1:
            raise AssertionError("%s %s: not one launch" % (name, form))
        want = plain()
        err = max(_gru_close(a, b, "%s %s %s" % (name, form, what))
                  for a, b, what in zip(got, want, results))
        del got, want
        ms = device_ms(kernel, 20)
        plain_ms = cuda_ms(plain, 3)
        bound_ms = N * H * per_elem / HBM_BYTES_PER_S * 1e3
        per_call[name].append(dict(form=form, max_abs_err=err, ms=ms,
                                   plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by="bytes"))
        print("gru form %-18s %-62s kernel %.4f ms  plain %.4f ms on the "
              "card  bound %.4f ms (bytes, %.2f per value)  share %.3f  "
              "max abs err %.3g  (%s)" % (
                  name, form, ms, plain_ms, bound_ms, per_elem,
                  bound_ms / ms, err, card), flush=True)
    del h, proj, g32, g_out, g_dt
    torch.cuda.empty_cache()

    launched = drqn_cell_launches(dev)
    rows = {}
    for name in GRU_KERNELS:
        calls = per_call[name]
        rows[name] = dict(
            name=name, route="cuda",
            source="magent_tpu_torch/csrc/gru_cell.cu",
            replaces="none: flax's GRUCell, which XLA fuses in the JAX "
                     "package",
            launches=launched[name],
            path="one train step of battle_drqn's loop: battle map %d, %d "
                 "worlds of 2x%d, GRU %d in bf16, rollout %d" % (
                     DRQN_MAP, DRQN_ENVS, DRQN_GROUP, GRU_WIDTH,
                     DRQN_ROLLOUT),
            max_abs_err=max(st["max_abs_err"] for st in calls),
            ms=statistics.mean(st["ms"] for st in calls),
            plain_ms=statistics.mean(st["plain_ms"] for st in calls),
            bound_ms=statistics.mean(st["bound_ms"] for st in calls),
            bound_by="bytes", library_ms=None, per_call=calls)
    return rows


def drqn_cell_launches(dev):
    """The GRU kernels' launches over one train step of battle_drqn's own
    loop (``make_drqn_train_loop`` at battle map DRQN_MAP, DRQN_ENVS worlds
    of 2 x DRQN_GROUP, bf16 views, ``DRQNNet`` with dueling heads and a GRU
    of GRU_WIDTH in bf16, a window of DRQN_ROLLOUT, ``share_acting``,
    ``unroll_remat`` "all", as h100bench's battle_drqn.train runs it):
    asserts 3 forwards (the acting cell, its recompute in the backward,
    the target re-unroll's carry step) and one backward per acting step and
    group, and a finite loss; returns the counts."""
    from magent_tpu_torch import ops
    from magent_tpu_torch import random as rnd
    from magent_tpu_torch.builtin.config import battle
    from magent_tpu_torch.builtin.torch_model import DRQNNet
    from magent_tpu_torch.parallel import (ClipAdam, VecGridWorld,
                                           init_drqn_hiddens,
                                           make_drqn_train_loop)

    T = DRQN_ROLLOUT
    venv = VecGridWorld(battle.get_config(DRQN_MAP), [DRQN_GROUP] * 2,
                        DRQN_ENVS, obs_dtype=torch.bfloat16, device=dev)
    spec, G = venv.spec, venv.spec.n_groups

    def nets(seed):
        return tuple(DRQNNet(spec.view_space(g), spec.feature_size(g),
                             spec.groups[g].type.n_action, use_dueling=True,
                             state_size=GRU_WIDTH, dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(seed + g)
                             ).to(dev) for g in range(G))

    tx = ClipAdam(1e-4, 5.0)
    loop = make_drqn_train_loop(venv, tx, steps_per_call=1, target_update=40,
                                rollout_len=T, gamma=0.99, use_double=True,
                                unroll_remat="all", share_acting=True)
    online = nets(0)
    torch.cuda.reset_peak_memory_stats(dev)
    before = ops.launch_counts()
    t0 = time.perf_counter()
    out = loop(online, nets(9), tuple(tx.init(n) for n in online),
               venv.reset(rnd.PRNGKey(0, dev)),
               init_drqn_hiddens(venv, online), rnd.PRNGKey(2, dev), 0.3, 0)
    loss = out[-1]["loss"]
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    after = ops.launch_counts()
    launched = {k: after[k] - before[k] for k in GRU_KERNELS}
    want = {"gru_cell": 3 * T * G, "gru_cell_backward": T * G}
    if launched != want:
        raise AssertionError("one train step of battle_drqn's loop launched "
                             "%s, expected %s" % (launched, want))
    if not bool(torch.isfinite(loss).all()):
        raise AssertionError("battle_drqn's train step: loss %s" % loss)
    print("gru launches over one train step of battle_drqn's loop (map %d, "
          "%d worlds of 2x%d, GRU %d bf16, rollout %d, %d groups, "
          "share_acting, unroll_remat all): %s = 4 per acting step and "
          "group; the step's first call %.3f s, peak %.1f GB" % (
              DRQN_MAP, DRQN_ENVS, DRQN_GROUP, GRU_WIDTH, T, G, launched,
              wall_s, torch.cuda.max_memory_allocated(dev) / 1e9),
          flush=True)
    del venv, out, online, loss
    torch.cuda.empty_cache()
    return launched


def lockstep_step(venv, carry):
    """One ``observe_all -> random_actions -> transition`` step on
    ``carry = [state, key]``; returns a scalar of the outputs to sum."""
    from magent_tpu_torch import random as rnd

    keys = rnd.split(carry[1])
    carry[1], akey = keys[0], keys[1]
    sink = 0.0
    for view, feat in venv.observe_all(carry[0]):
        sink = sink + view[:, :, 0, 0, 0].sum() + feat[:, 0, 0].sum()
    carry[0], rewards, _, _ = venv.transition(carry[0],
                                              venv.random_actions(akey))
    return sink + rewards[:, 0].sum()


def assert_bodies_disjoint(venv, state):
    """No two live bodies (each its facing's footprint) share a cell, and
    none stands on a wall."""
    from magent_tpu_torch.core import geometry as geo

    spec = venv.spec
    H, W, MB = spec.height, spec.width, spec.max_body_w
    dev = state.x.device
    alive = state.active & ~state.dead
    bw, bh = geo.size_for_dir(state.dir,
                              torch.as_tensor(spec.s_width, device=dev),
                              torch.as_tensor(spec.s_length, device=dev))
    count = torch.zeros((state.x.shape[0], H * W + 1), dtype=torch.int32,
                        device=dev)
    for i in range(MB):
        for j in range(MB):
            ok = alive & (i < bw) & (j < bh)
            cell = torch.where(ok, (state.y + j) * W + state.x + i, H * W)
            count.scatter_add_(1, cell.long(), ok.to(torch.int32))
    count = count[:, :H * W]
    if bool((count > 1).any()):
        raise AssertionError("two live bodies share a cell")
    if bool(((count > 0) & state.cell_wall.reshape(count.shape)).any()):
        raise AssertionError("a live body stands on a wall")


def run_lockstep(label, venv, state, key, per_step, device_name,
                 timed=contextlib.nullcontext, draws=None):
    """The timed lockstep loop: warm-up, launch counters set to 0, TIMED_STEPS
    unsynchronized steps (inside the context ``timed()``) ending in a
    synchronize, then the counts checked against ``per_step`` launches of
    each path kernel per step (and the threefry kernel's against ``draws``
    per step, where given: an auto-reset draws more); host syncs per step,
    synchronized phase times, output shapes and finiteness, disjoint bodies.
    Returns (launch counts, state, key, ms per step, host syncs per
    step)."""
    from magent_tpu_torch import ops
    from magent_tpu_torch import random as rnd

    carry = [state, key]
    for _ in range(WARMUP_STEPS):
        lockstep_step(venv, carry)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sink = torch.zeros((), device=venv.device)
    with timed():
        for _ in range(TIMED_STEPS):
            sink = sink + lockstep_step(venv, carry)
    float(sink)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    rng = ops.launch_counts()[RNG_KERNEL]
    agent_steps = venv.spec.n_agents_cap * venv.n_envs * TIMED_STEPS
    print("%s: %s slots, B=%d, %d timed steps in %.4f s: %.1f agent-steps/s, "
          "%.3f ms/step on %s; %.2f threefry launches per step" % (
              label, [g.cap for g in venv.spec.groups], venv.n_envs,
              TIMED_STEPS, dt, agent_steps / dt, dt / TIMED_STEPS * 1e3,
              device_name, rng / TIMED_STEPS), flush=True)
    if not np.isfinite(float(sink)):
        raise AssertionError("%s produced non-finite values" % label)
    expected = {name: per_step.get(name, 0) * TIMED_STEPS
                for name in PATH_KERNELS}
    if counts != expected:
        raise AssertionError("%s: launch counts %s, expected %s" % (
            label, counts, expected))
    if draws is not None and rng != draws * TIMED_STEPS:
        raise AssertionError("%s: %d threefry launches, expected %d per "
                             "step" % (label, rng, draws))

    syncs, sites = count_host_syncs(lambda: lockstep_step(venv, carry),
                                    PROFILE_STEPS)
    print("%s: %.1f host syncs per step (torch.cuda sync debug mode, %d "
          "steps); per step by call site: %s" % (
              label, syncs, PROFILE_STEPS, json.dumps(
                  {k: v / PROFILE_STEPS for k, v in sites.most_common()})),
          flush=True)
    state, key = carry

    # per-phase wall time (host clock around synchronized phases)
    phase = {"observe_all": [], "random_actions": [], "transition": []}
    for _ in range(5):
        keys = rnd.split(key)
        key, akey = keys[0], keys[1]
        t = time.perf_counter()
        obs = venv.observe_all(state)
        torch.cuda.synchronize()
        phase["observe_all"].append(time.perf_counter() - t)
        t = time.perf_counter()
        actions = venv.random_actions(akey)
        torch.cuda.synchronize()
        phase["random_actions"].append(time.perf_counter() - t)
        t = time.perf_counter()
        state, _, _, _ = venv.transition(state, actions)
        torch.cuda.synchronize()
        phase["transition"].append(time.perf_counter() - t)
    print("%s phases (median of 5 synchronized steps, ms): %s" % (
        label, json.dumps({k: statistics.median(v) * 1e3
                           for k, v in phase.items()})), flush=True)
    for g, (view, feat) in enumerate(obs):
        cap = venv.spec.groups[g].cap
        if tuple(view.shape) != (venv.n_envs, cap) + venv.view_spaces()[g] or \
                tuple(feat.shape) != (venv.n_envs, cap) + venv.feature_spaces()[g]:
            raise AssertionError("group %d observation shapes %s %s" % (
                g, tuple(view.shape), tuple(feat.shape)))
        if not (bool(torch.isfinite(view).all())
                and bool(torch.isfinite(feat).all())):
            raise AssertionError("group %d observations not finite" % g)
    assert_bodies_disjoint(venv, state)
    return counts, state, key, dt / TIMED_STEPS * 1e3, syncs


def profile_steps(label, step, n_steps, ms_per_step):
    """torch.profiler over ``n_steps`` more calls of ``step()``: device ops
    per step, device time per step, and the device's busy share (measured
    with the profiler on, and estimated against the unprofiled
    ``ms_per_step``) -> (device ops, device ms) per step, or None when the
    profiler saw no device event."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for e in prof.key_averages():
        # device-side events only (kernels, memcpy, memset): host ops carry
        # their kernels' time too and would count it twice
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels.append((e.self_device_time_total / 1e3, e.count, e.key))
    if not kernels:
        print("%s profiler: no device events captured; device time not "
              "measured" % label, flush=True)
        return None
    kernels.sort(reverse=True)
    device_ms = sum(k[0] for k in kernels) / n_steps
    own = {name: sum(k[0] for k in kernels if sym in k[2]) / n_steps
           for name, sym in SYMBOLS.items()}
    own_ms = sum(own.values())
    print("%s profiler: the hand-written kernels take %.4f ms/step of device "
          "time, %.4f of the device time and %.4f of the unprofiled step "
          "(%s)" % (label, own_ms, own_ms / device_ms if device_ms else 0.0,
                    own_ms / ms_per_step, json.dumps(
                        {k: v for k, v in own.items() if v})), flush=True)
    print("%s profiler, %d steps: %.1f device ops/step, %.4f ms device "
          "time/step in %.4f ms wall/step (busy share %.4f with the profiler "
          "on; estimated %.4f against the unprofiled %.4f ms/step); peak "
          "device memory %.3f GB" % (
              label, n_steps, sum(k[1] for k in kernels) / n_steps,
              device_ms, wall_ms / n_steps, device_ms * n_steps / wall_ms,
              device_ms / ms_per_step, ms_per_step,
              torch.cuda.max_memory_allocated() / 1e9),
          flush=True)
    for dev_ms, calls, name in kernels[:15]:
        print("  %9.4f ms/step  %6.1f calls/step  %s" % (
            dev_ms / n_steps, calls / n_steps, name[:90]))
    return sum(k[1] for k in kernels) / n_steps, device_ms


def profile_lockstep(label, venv, state, key, ms_per_step):
    """The profiler over PROFILE_STEPS more lockstep steps."""
    carry = [state, key]
    profile_steps(label, lambda: lockstep_step(venv, carry), PROFILE_STEPS,
                  ms_per_step)


def check_gpu_matches_cpu(label, make_env, n_steps, view_atol):
    """The port on the GPU and on the CPU from the same keys:
    ``make_env(device)`` builds each side; states, transition outputs and
    features exactly equal, views within ``view_atol``."""
    from magent_tpu_torch import random as rnd

    envs = {d: make_env(d) for d in ("cuda", "cpu")}
    states = {d: envs[d].reset(rnd.PRNGKey(5)) for d in envs}
    assert_state_equal(states["cuda"], states["cpu"], "%s reset" % label)
    key = rnd.PRNGKey(6)
    for step in range(n_steps):
        keys = rnd.split(key)
        key, akey = keys[0], keys[1]
        obs = {d: envs[d].observe_all(states[d]) for d in envs}
        for (gv, gf), (cv, cf) in zip(obs["cuda"], obs["cpu"]):
            torch.testing.assert_close(gv.cpu(), cv, atol=view_atol, rtol=0)
            torch.testing.assert_close(gf.cpu(), cf, atol=0, rtol=0)
        acts = {d: envs[d].random_actions(akey) for d in envs}
        if not torch.equal(acts["cuda"].cpu(), acts["cpu"]):
            raise AssertionError("%s: random actions differ at step %d"
                                 % (label, step))
        out = {d: envs[d].transition(states[d], acts[d]) for d in envs}
        states = {d: out[d][0] for d in envs}
        assert_state_equal(states["cuda"], states["cpu"],
                           "%s step %d" % (label, step))
        for a, b in zip(out["cuda"][1:], out["cpu"][1:]):
            if not torch.equal(a.cpu(), b):
                raise AssertionError("%s: transition outputs differ at step "
                                     "%d" % (label, step))
    spec = envs["cpu"].spec
    print("GPU vs CPU: %s, %s slots, B=%d, %d steps: states, views (atol %g) "
          "and features equal" % (label, [g.cap for g in spec.groups],
                                  envs["cpu"].n_envs, n_steps, view_atol),
          flush=True)


def place_armies(env, handles):
    """``examples/train_battle.py:25-42`` ``generate_map`` in its first
    round (flipped: the first army on the right): two squares of
    (map^2 * 0.04) agents at stride 2, 3 cells either side of the middle."""
    map_size = env.spec.width
    side_len = int(math.sqrt(int(map_size * map_size * 0.04))) * 2
    gap = 3
    y0 = (map_size - side_len) // 2

    def square(x0):
        return [[x, y, 0] for x in range(x0, x0 + side_len, 2)
                for y in range(y0, y0 + side_len, 2)]

    env.add_agents(handles[0], method="custom", pos=square(map_size // 2 + gap))
    env.add_agents(handles[1], method="custom",
                   pos=square(map_size // 2 - gap - side_len))


def place_interleaved(env, handles):
    """The armies of :func:`place_armies` (2 x 625 at map 125, 2 x 64 at
    map 40) as one square, the second army one column right of the first:
    every agent has enemies in reach."""
    map_size = env.spec.width
    side_len = int(math.sqrt(int(map_size * map_size * 0.04))) * 2
    x0 = y0 = (map_size - side_len) // 2
    for k, h in enumerate(handles):
        env.add_agents(h, method="custom", pos=[
            [x + k, y, 0] for x in range(x0, x0 + side_len, 2)
            for y in range(y0, y0 + side_len, 2)])


def gridworld_step(env, handles, rng, place=place_armies):
    """One step of the stateful loop with uniform random actions; re-places
    the armies when the episode ends.  -> (live agents stepped, last group's
    (view, feature), rewards per group)."""
    live = 0
    for h in handles:
        view, feat = env.get_observation(h)
        live += len(view)
        env.set_action(h, rng.randint(0, env.get_action_space(h)[0],
                                      len(view)).astype(np.int32))
    done = env.step()
    rewards = [env.get_reward(h) for h in handles]
    env.clear_dead()
    if done:
        env.reset()
        place(env, handles)
    return live, (view, feat), rewards


def count_host_syncs(step, n_steps):
    """Synchronizing CUDA calls per ``step()``, counted by PyTorch's sync
    debug mode (one warning per call that waits for the device)."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(n_steps):
                step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sites = collections.Counter(
        "%s:%d" % (os.path.relpath(w.filename), w.lineno) for w in caught
        if "synchroniz" in str(w.message))
    return sum(sites.values()) / n_steps, sites


def run_gridworld_path(f32_rate, int32_rate, device_name):
    """Phase 4: the stateful GridWorld at train_battle's full width; returns
    the launch counts of the timed run and the grid path's kernel rows."""
    from magent_tpu_torch import GridWorld, ops
    from magent_tpu_torch.ops import attack_prefix as ap
    from magent_tpu_torch.ops import window_gather as wg

    env = GridWorld("battle", map_size=GW_MAP)
    handles = env.get_handles()
    env.reset()
    place_armies(env, handles)
    rng = np.random.RandomState(0)
    n0 = [env.get_num(h) for h in handles]
    for _ in range(GW_WARMUP):
        gridworld_step(env, handles, rng)
    torch.cuda.synchronize()
    A = env.spec.n_agents_cap
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    live = 0
    for _ in range(GW_TIMED):
        n, (view, feat), rewards = gridworld_step(env, handles, rng)
        live += n
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    ms_per_step = dt / GW_TIMED * 1e3
    print("GridWorld path: battle map %d, %s agents placed, A=%d slots, %d "
          "timed steps in %.4f s: %.4f ms/step, %.1f agent-steps/s (%d live "
          "agent-steps) on %s" % (
              GW_MAP, n0, A, GW_TIMED, dt, ms_per_step, live / dt, live,
              device_name), flush=True)
    per_step = {"window_gather": 2, "rank_prefix_hp": 1, "move_claims": 1}
    expected = {name: per_step.get(name, 0) * GW_TIMED
                for name in PATH_KERNELS}
    if counts != expected:
        raise AssertionError("GridWorld launch counts %s, expected %s" % (
            counts, expected))
    vs = env.get_view_space(handles[-1])
    fs = env.get_feature_space(handles[-1])
    if view.shape[1:] != vs or feat.shape[1:] != fs or \
            view.dtype != np.float32 or not (
            np.isfinite(view).all() and np.isfinite(feat).all()
            and all(np.isfinite(r).all() for r in rewards)):
        raise AssertionError("GridWorld outputs: shapes %s %s, want %s %s, "
                             "or not finite" % (view.shape, feat.shape, vs, fs))
    syncs, sites = count_host_syncs(
        lambda: gridworld_step(env, handles, rng), GW_SYNC_STEPS)
    print("GridWorld path: %.1f host syncs per step (torch.cuda sync debug "
          "mode, %d steps); per step by call site: %s" % (
              syncs, GW_SYNC_STEPS, json.dumps(
                  {k: v / GW_SYNC_STEPS for k, v in sites.most_common()})),
          flush=True)
    profile_steps("GridWorld", lambda: gridworld_step(env, handles, rng),
                  PROFILE_STEPS, ms_per_step)

    # the grid path's kernels against their plain versions at the same
    # widths (A=2048, B=1), on the operands of one step of the same armies
    # placed interleaved, so that every agent has enemies in reach and the
    # sweeps see shared targets and contested cells
    env.reset()
    place_interleaved(env, handles)
    split = ("rank_prefix_hp", "move_claims")
    before = launch_counts()
    rec = record_operands(lambda: gridworld_step(env, handles, rng),
                          [(ap, "rank_prefix"), (ap, "move_claims"),
                           (wg, "window_gather")])
    per_step = {n: launch_counts()[n] - before[n] for n in split}
    (rp_args, rp_kw), = rec["rank_prefix"]
    (mc_args, mc_kw), = rec["move_claims"]
    tgt, tcell = rp_args[0], mc_args[0]
    HW = env.spec.height * env.spec.width
    print("recorded step: %d attackers with a target, %d movers with a "
          "blank cell" % (int((tgt < A).sum()), int((tcell < HW).sum())),
          flush=True)
    form = "battle map %d, A=%d, B=1" % (GW_MAP, A)
    rows = {"rank_prefix_hp": kernel_row("rank_prefix_hp",
                                         [(rp_args, rp_kw, form)], f32_rate,
                                         int32_rate),
            "move_claims": kernel_row("move_claims", [(mc_args, mc_kw, form)],
                                      f32_rate, int32_rate)}
    print_split_forms(
        {"rank_prefix_hp": [(rp_args, rp_kw, per_step["rank_prefix_hp"])],
         "move_claims": [(mc_args, mc_kw, per_step["move_claims"])]},
        {n: rows[n]["per_call"] for n in split})
    check_cell_splits("move_claims", mc_args, form)
    # the GridWorld's window calls (B=1): forms of phase 2's row
    gw_views = [call_stats("window_gather", a, k, f32_rate, int32_rate,
                           "%s, group %d" % (form, g))
                for g, (a, k) in enumerate(rec["window_gather"])]
    del rec, env
    torch.cuda.empty_cache()
    return counts, rows, gw_views


# train_tiger (examples/train_tiger.py:20-28): map 500, walls, deer and
# tigers on 4%, 5% and 1% of the cells; its 12,500 + 2,500 agents grow the
# caps to 16,384 + 4,096 slots, past QUAD_MAX_SINGLE: the grid path's sort
# branches.  Map 400 (8,000 + 1,600 agents, 10,240 slots) stays on the
# pair kernels.  Launches per step of each (the rest 0): at map 500 each
# group's padded image (536 rows x 2,945 lanes, 6.31 MB) is above the
# 6 MiB image budget, so both take the banded gather, as in the JAX
# package
TIGER_MAPS = {500: {"window_gather_banded": 2},
              400: {"rank_prefix_hp": 1, "move_claims": 1,
                    "window_gather": 2}}
TIGER_WARMUP, TIGER_TIMED, TIGER_SYNC_STEPS = 3, 20, 3
# the GPU-vs-CPU runs: train_tiger's layout at map 60 (quad route), the
# golden scenario's (tests/golden/scenarios.py double_attack: map 20, a 3x3
# deer grid at stride 3, a 4x4 tiger grid at stride 2, 15 random walls) on
# the sort branches forced, and a few steps at map 500 (sort branches)
TIGER_SMALL_MAP, TIGER_SMALL_STEPS, TIGER_BIG_STEPS = 60, 8, 3


def place_tiger_world(env, handles):
    """``examples/train_tiger.py:20-23`` ``generate_map``."""
    cells = env.spec.width * env.spec.height
    env.add_walls(method="random", n=int(cells * 0.04))
    env.add_agents(handles[0], method="random", n=int(cells * 0.05))
    env.add_agents(handles[1], method="random", n=int(cells * 0.01))


def place_golden_tigers(env, handles):
    """The golden double_attack scenario's layout with 15 random walls."""
    def grid(x0, y0, n, stride):
        return [[x0 + i * stride, y0 + j * stride, 0] for i in range(n)
                for j in range(n)]

    env.add_agents(handles[0], method="custom", pos=grid(6, 6, 3, 3))
    env.add_agents(handles[1], method="custom", pos=grid(5, 5, 4, 2))
    env.add_walls(method="random", n=15)


def tiger_actions(env, tigers, deer, view, rng):
    """Each tiger with a deer in its attack range attacks the first one
    (row-major in its view) through the ``view2attack`` table, as trained
    tigers do; the others act at random."""
    base, v2a = env.get_view2attack(tigers)
    sp = env.spec
    ch = int(sp.channel_perm(tigers.value)[sp.group2channel(deer.value)])
    flat = ((view[..., ch] > 0.5) & (v2a[None] != -1)).reshape(len(view), -1)
    acts = rng.randint(0, env.get_action_space(tigers)[0], len(view))
    found = flat.any(1)
    acts[found] = base + v2a.reshape(-1)[flat.argmax(1)[found]]
    return acts.astype(np.int32)


def tiger_step(env, handles, rng, place=place_tiger_world):
    """One step of train_tiger's loop with drawn actions (deer at random,
    tigers by :func:`tiger_actions`); re-places the world when the episode
    ends.  -> (live agents stepped, the tigers' rewards, the state after
    the step, before clear_dead)."""
    deer, tigers = handles
    view, _ = env.get_observation(deer)
    live = len(view)
    env.set_action(deer, rng.randint(0, env.get_action_space(deer)[0],
                                     len(view)).astype(np.int32))
    view, _ = env.get_observation(tigers)
    live += len(view)
    env.set_action(tigers, tiger_actions(env, tigers, deer, view, rng))
    done = env.step()
    stepped = env.state
    env.get_reward(deer)
    paid = env.get_reward(tigers)
    env.clear_dead()
    if done:
        env.reset()
        place(env, handles)
    return live, paid, stepped


def tiger_pairs(paid):
    """Ordered tiger pairs the double-attack rule paid: the tigers earn
    nothing else, and each pair pays each of its two tigers 1."""
    return int(round(float(paid.sum()))) // 2


def tiger_world(map_size, device=None, place=place_tiger_world):
    from magent_tpu_torch import GridWorld

    env = GridWorld("double_attack", map_size=map_size, device=device)
    handles = env.get_handles()
    env.reset()
    place(env, handles)
    return env, handles


def profiled_device_ms(fn):
    """(device ms, device ops) of one call of ``fn``, by torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in dev) / 1e3,
            sum(e.count for e in dev))


def check_general_rule_on_card(env, state):
    """The double-attack rule as ``GeneralRule`` (the join over two 'any'
    axes of 4,096 tiger slots: 4 blocks of 2,048 x 2,048 under
    ``MAX_TENSOR``) against the compiled ``PairSharedObjectRule`` on one
    step's state: exactly equal (both count integer pairs of value 1)."""
    from magent_tpu_torch.core import rules

    spec = env.spec
    pair, = spec.compiled_rules()
    if not isinstance(pair, rules.PairSharedObjectRule):
        raise AssertionError("double_attack compiled to %s" % type(pair))
    on, recv, vals, term = spec.reward_rules[0]
    order = rules._symbol_order(spec.reward_rules)
    general = rules.GeneralRule(spec, on, recv, vals, term, order.index)
    n_blocks = len(general.blocks(spec))
    tiger_cap = spec.groups[1].cap
    if general.chunk_sizes != [tiger_cap // 2] * 2 or n_blocks != 4:
        raise AssertionError("GeneralRule blocks %s x %d, expected 4 of "
                             "%d x %d" % (general.chunk_sizes, n_blocks,
                                          tiger_cap // 2, tiger_cap // 2))
    nr = torch.zeros_like(state.next_reward)
    gr = torch.zeros_like(state.group_reward)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = general.apply(spec, state, nr, gr)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    want = pair.apply(spec, state, nr, gr)
    for name, g, w in zip(("rewards", "group rewards", "triggered"), got,
                          want):
        if not torch.equal(g, w):
            raise AssertionError("GeneralRule's %s differ from "
                                 "PairSharedObjectRule's" % name)
    pairs = tiger_pairs(want[0])
    if not (bool(want[2].all()) and pairs > 0):
        raise AssertionError("the checked state triggers no double attack")
    g_ms, g_ops = profiled_device_ms(
        lambda: general.apply(spec, state, nr, gr))
    p_ms, p_ops = profiled_device_ms(lambda: pair.apply(spec, state, nr, gr))
    print("GeneralRule on the card: double_attack's rule over %d tiger slots "
          "per axis, %d blocks of %d x %d: rewards, group rewards and "
          "triggered equal to PairSharedObjectRule's exactly (%d ordered "
          "pairs); %.4f ms device time in %d device ops per apply, %.4f ms "
          "a call back to back, peak memory %.4f GB above the %.3f GB held "
          "(PairSharedObjectRule: %.4f ms device time in %d device ops, "
          "%.4f ms a call back to back)" % (
              tiger_cap, n_blocks, *general.chunk_sizes, pairs, g_ms, g_ops,
              cuda_ms(lambda: general.apply(spec, state, nr, gr), 5),
              peak / 1e9, held / 1e9, p_ms, p_ops,
              cuda_ms(lambda: pair.apply(spec, state, nr, gr), 20)),
          flush=True)


def run_tiger_path(map_size, f32_rate, int32_rate, device_name):
    """Phase 4b at one map: train_tiger's loop, timed; launch counts, host
    syncs, the profiler and the double-attack triggers; at map 500 the
    rule's general join on the card; the path's kernels against their
    plain versions on one step's operands.  -> ({kernel: launches in the
    timed run}, {kernel: [call_stats of the step's calls]})."""
    from magent_tpu_torch import ops
    from magent_tpu_torch.core import engine
    from magent_tpu_torch.ops import attack_prefix as ap
    from magent_tpu_torch.ops import window_gather as wg

    per_step = TIGER_MAPS[map_size]
    env, handles = tiger_world(map_size)
    spec = env.spec
    A = spec.n_agents_cap
    sort = "move_claims" not in per_step
    route = engine._Route(grid=True, quad=not sort)
    obs_route, = (n for n in per_step if n.startswith("window"))
    if env._step_fn.route != route or [
            f.route for f in env._observe_fns] != [obs_route] * 2:
        raise AssertionError("double_attack map %d: route %s, observation "
                             "routes %s" % (map_size, env._step_fn.route,
                                            [f.route for f in
                                             env._observe_fns]))
    label = "double_attack map %d" % map_size
    n0 = [env.get_num(h) for h in handles]
    rng = np.random.RandomState(map_size)
    for _ in range(TIGER_WARMUP):
        tiger_step(env, handles, rng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    live = pairs = fired = 0
    fired_state = None
    for _ in range(TIGER_TIMED):
        n, paid, stepped = tiger_step(env, handles, rng)
        live += n
        k = tiger_pairs(paid)
        pairs += k
        fired += k > 0
        if k and fired_state is None:
            fired_state = stepped
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    ms_per_step = dt / TIGER_TIMED * 1e3
    print("%s: %s agents placed, A=%d slots (caps %s), %s route, "
          "observation by %s; %d timed steps in %.4f s: %.4f ms/step, %.1f "
          "agent-steps/s (%d live agent-steps) on %s; double-attack "
          "triggers: %d ordered tiger pairs paid in %d of %d steps" % (
              label, n0, A, [g.cap for g in spec.groups],
              "sort" if sort else "pair-kernel", obs_route, TIGER_TIMED, dt,
              ms_per_step, live / dt, live, device_name, pairs, fired,
              TIGER_TIMED), flush=True)
    expected = {name: per_step.get(name, 0) * TIGER_TIMED
                for name in PATH_KERNELS}
    if counts != expected:
        raise AssertionError("%s launch counts %s, expected %s" % (
            label, counts, expected))
    if not pairs:
        raise AssertionError("%s: the double-attack rule never fired" % label)
    syncs, sites = count_host_syncs(lambda: tiger_step(env, handles, rng),
                                    TIGER_SYNC_STEPS)
    print("%s: %.1f host syncs per step (torch.cuda sync debug mode, %d "
          "steps); per step by call site: %s" % (
              label, syncs, TIGER_SYNC_STEPS, json.dumps(
                  {k: v / TIGER_SYNC_STEPS for k, v in sites.most_common()})),
          flush=True)
    profile_steps(label, lambda: tiger_step(env, handles, rng),
                  PROFILE_STEPS, ms_per_step)
    if sort:
        check_general_rule_on_card(env, fired_state)
    del fired_state

    # the path's kernels against their plain versions on one more step
    wrappers = [(wg, obs_route)] if sort else [
        (ap, "rank_prefix"), (ap, "move_claims"), (wg, obs_route)]
    before = launch_counts()
    rec = record_operands(lambda: tiger_step(env, handles, rng), wrappers)
    launched = {n: c - before[n] for n, c in launch_counts().items()}
    if launched != {n: per_step.get(n, 0) for n in PATH_KERNELS}:
        raise AssertionError("%s: the recorded step launched %s" % (
            label, launched))
    form = "%s, A=%d, B=1" % (label, A)
    stats = {}
    if not sort:
        (rp_args, rp_kw), = rec["rank_prefix"]
        (mc_args, mc_kw), = rec["move_claims"]
        stats["rank_prefix_hp"] = [call_stats(
            "rank_prefix_hp", rp_args, rp_kw, f32_rate, int32_rate, form)]
        stats["move_claims"] = [call_stats(
            "move_claims", mc_args, mc_kw, f32_rate, int32_rate, form)]
        print_split_forms(
            {"rank_prefix_hp": [(rp_args, rp_kw, 1)],
             "move_claims": [(mc_args, mc_kw, 1)]}, stats)
        check_cell_splits("move_claims", mc_args, form, random_a=())
    stats[obs_route] = [call_stats(obs_route, a, k, f32_rate, int32_rate,
                                   "%s, %s" % (form, name))
                        for (a, k), name in zip(rec[obs_route],
                                                ("deer", "tigers"))]
    print_window_forms(obs_route, [per_step[obs_route]] * 2, stats[obs_route])
    del rec, env
    torch.cuda.empty_cache()
    return counts, stats


def check_tiger_gpu_matches_cpu(label, map_size, place, n_steps,
                                sort=False):
    """The double_attack GridWorld on the GPU and on the CPU
    (:func:`check_grid_world_gpu_matches_cpu`), each tiger with a deer in
    reach attacking it (from the CPU's views, which must equal the GPU's).
    ``sort`` builds the step on the sort branches whatever the slot count.
    -> ordered pairs paid."""
    def act(env, h, view, rng):
        deer, tigers = env.get_handles()
        return (tiger_actions(env, tigers, deer, view, rng)
                if h.value == tigers.value else None)

    seen = check_grid_world_gpu_matches_cpu(
        label, lambda d: tiger_world(map_size, d, place), n_steps, sort,
        act=act, seed=map_size)
    pairs = sum(tiger_pairs(r[1]) for r in seen["rewards"])
    print("GridWorld GPU vs CPU: %s: %d ordered tiger pairs paid" % (
        label, pairs), flush=True)
    return pairs


def check_gridworld_gpu_matches_cpu():
    """Phase 7 (GridWorld): the stateful API on the GPU and on the CPU, same
    placements and actions, with clear_dead every step."""
    from magent_tpu_torch import GridWorld
    from magent_tpu_torch.core.state import FIELDS

    envs = {d: GridWorld("battle", map_size=GW_SMALL_MAP, device=d)
            for d in ("cuda", "cpu")}
    rngs = {d: np.random.RandomState(7) for d in envs}
    for d, env in envs.items():
        env.reset()
        # two interleaved 8x8 squares: attacks, kills and collisions at once
        place_interleaved(env, env.get_handles())
    spec = envs["cpu"].spec
    for step in range(GW_SMALL_STEPS):
        for g, h in enumerate(envs["cpu"].get_handles()):
            (gv, gf), (cv, cf) = (envs[d].get_observation(h) for d in envs)
            perm = spec.channel_perm(g)
            mm = sorted(int(perm[spec.group2channel(k)]) + 2
                        for k in range(spec.n_groups))
            rest = [c for c in range(gv.shape[-1]) if c not in mm]
            if gv.shape != cv.shape or not np.array_equal(
                    gv[..., rest], cv[..., rest]) or not np.array_equal(gf, cf) \
                    or not np.abs(gv[..., mm] - cv[..., mm]).max(
                        initial=0.0) <= VIEW_ATOL:
                raise AssertionError("GridWorld observations differ at step "
                                     "%d, group %d" % (step, g))
        outs = {}
        for d, env in envs.items():
            handles = env.get_handles()
            acts = []
            for h in handles:
                a = rngs[d].randint(0, env.get_action_space(h)[0],
                                    env.get_num(h)).astype(np.int32)
                env.set_action(h, a)
                acts.append(a)
            done = env.step()
            outs[d] = (done, [env.get_reward(h) for h in handles],
                       [env.get_pos(h) for h in handles],
                       [env.get_alive(h) for h in handles],
                       [env.get_agent_id(h) for h in handles], acts)
            env.clear_dead()
        if not all(np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(_flat(outs["cuda"]), _flat(outs["cpu"]))):
            raise AssertionError("GridWorld done/rewards/positions/alive/ids "
                                 "differ at step %d" % step)
        for name in FIELDS:
            x = getattr(envs["cuda"].state, name).cpu()
            if not torch.equal(x, getattr(envs["cpu"].state, name)):
                raise AssertionError("GridWorld state field %s differs at "
                                     "step %d" % (name, step))
    print("GridWorld GPU vs CPU: battle map %d, %s agents, %d steps with "
          "clear_dead: observations, rewards, positions, hp, alive, ids and "
          "done equal" % (GW_SMALL_MAP, [len(p) for p in outs["cpu"][2]],
                          GW_SMALL_STEPS), flush=True)


# train_pursuit (examples/train_pursuit.py:16-27): GridWorld("pursuit")
# with 3% walls, 1.25% 2x2 predators and 2.5% prey.  At map 1000 its
# 12,500 + 25,000 agents grow the caps to 16,384 + 32,768 slots (A =
# 49,152, past QUAD_MAX_SINGLE): the grid path's sort branches, no pair
# kernel.  At map 500 (3,125 + 6,250 agents, 4,096 + 8,192 slots) the step
# takes rank_prefix_hp; multi-cell claims go through a scatter-min, not
# move_claims.  Both maps' padded images ([1,1048,5380], 22.6 MB, and
# [1,544,2945], 6.41 MB) are above the 6 MiB image budget: the banded
# gather.  Launches per step of each (the rest 0):
PURSUIT_WORLD_MAPS = {1000: {"window_gather_banded": 2},
                      500: {"rank_prefix_hp": 1, "window_gather_banded": 2}}
PW_WARMUP, PW_TIMED, PW_SYNC_STEPS = 3, 20, 3
# the GPU-vs-CPU runs of the grid path's new mechanics: pursuit GridWorlds
# at map 64 (pair kernels) and 1000 (sort branches), the golden food,
# food_crumb and absorb layouts (tests/golden/scenarios.py) and absorb at
# examples/train_arrange.py's map 100 (its config; goals and seekers on 3%
# and 2% of the cells, at random)
PW_SMALL_MAP, PW_SMALL_STEPS, PW_BIG_STEPS, FOOD_STEPS = 64, 6, 3, 10
ARRANGE_MAP, ARRANGE_STEPS = 100, 10


def place_pursuit_world(env, handles):
    """``examples/train_pursuit.py:16-20`` ``generate_map``."""
    n = env.spec.width * env.spec.height
    env.add_walls(method="random", n=n * 0.03)
    env.add_agents(handles[0], method="random", n=n * 0.0125)
    env.add_agents(handles[1], method="random", n=n * 0.025)


def pursuit_world(map_size, device=None):
    from magent_tpu_torch import GridWorld

    env = GridWorld("pursuit", map_size=map_size, device=device)
    handles = env.get_handles()
    env.reset()
    place_pursuit_world(env, handles)
    return env, handles


def run_pursuit_world_path(map_size, f32_rate, int32_rate, device_name):
    """Phase 4c at one map: train_pursuit's loop (gridworld_step with
    random actions), timed; launch counts, host syncs, the profiler and
    peak memory; the grid after the timed steps equal to a rebuild from
    the positions; the path's kernels against their plain versions on one
    more step's operands.  -> ({kernel: launches in the timed run},
    {kernel: [call_stats of the step's calls]})."""
    from magent_tpu_torch import ops
    from magent_tpu_torch.core import engine
    from magent_tpu_torch.ops import attack_prefix as ap
    from magent_tpu_torch.ops import window_gather as wg

    per_step = PURSUIT_WORLD_MAPS[map_size]
    label = "pursuit GridWorld map %d" % map_size
    t0 = time.perf_counter()
    env, handles = pursuit_world(map_size)
    place_s = time.perf_counter() - t0
    spec = env.spec
    A = spec.n_agents_cap
    quad = "rank_prefix_hp" in per_step
    if env._step_fn.route != engine._Route(grid=True, quad=quad) or [
            f.route for f in env._observe_fns] != ["window_gather_banded"] * 2:
        raise AssertionError("%s: route %s, observation routes %s" % (
            label, env._step_fn.route, [f.route for f in env._observe_fns]))
    n0 = [env.get_num(h) for h in handles]
    rng = np.random.RandomState(map_size)
    place = place_pursuit_world
    for _ in range(PW_WARMUP):
        gridworld_step(env, handles, rng, place)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    live = 0
    for _ in range(PW_TIMED):
        n, (view, feat), rewards = gridworld_step(env, handles, rng, place)
        live += n
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    ms_per_step = dt / PW_TIMED * 1e3
    print("%s: %s agents placed in %.2f s, A=%d slots (caps %s), %s route, "
          "observation by window_gather_banded; %d timed steps in %.4f s: "
          "%.4f ms/step, %.1f agent-steps/s (%d live agent-steps) on %s; "
          "loop peak device memory %.3f GB" % (
              label, n0, place_s, A, [g.cap for g in spec.groups],
              "pair-kernel" if quad else "sort", PW_TIMED, dt, ms_per_step,
              live / dt, live, device_name,
              torch.cuda.max_memory_allocated() / 1e9), flush=True)
    expected = {name: per_step.get(name, 0) * PW_TIMED
                for name in PATH_KERNELS}
    if counts != expected:
        raise AssertionError("%s launch counts %s, expected %s" % (
            label, counts, expected))
    vs = env.get_view_space(handles[-1])
    finite = (np.isfinite(view).all() and np.isfinite(feat).all()
              and all(np.isfinite(r).all() for r in rewards))
    if view.shape[1:] != vs or not finite:
        raise AssertionError("%s outputs: view shape %s, want %s, or not "
                             "finite" % (label, view.shape, vs))
    grid = env.state.cell_slot
    if not torch.equal(grid, env._rebuild_grid(env.state)):
        raise AssertionError("%s: cell_slot differs from a rebuild from the "
                             "positions after the timed steps" % label)
    print("%s: cell_slot after the timed steps equals its rebuild from the "
          "positions (%d occupied cells)" % (label, int((grid >= 0).sum())),
          flush=True)
    syncs, sites = count_host_syncs(
        lambda: gridworld_step(env, handles, rng, place), PW_SYNC_STEPS)
    print("%s: %.1f host syncs per step (torch.cuda sync debug mode, %d "
          "steps); per step by call site: %s" % (
              label, syncs, PW_SYNC_STEPS, json.dumps(
                  {k: v / PW_SYNC_STEPS for k, v in sites.most_common()})),
          flush=True)
    profile_steps(label, lambda: gridworld_step(env, handles, rng, place),
                  PROFILE_STEPS, ms_per_step)

    # the path's kernels against their plain versions on one more step
    wrappers = [(wg, "window_gather_banded")] + (
        [(ap, "rank_prefix")] if quad else [])
    before = launch_counts()
    rec = record_operands(lambda: gridworld_step(env, handles, rng, place),
                          wrappers)
    launched = {n: c - before[n] for n, c in launch_counts().items()}
    if launched != {n: per_step.get(n, 0) for n in PATH_KERNELS}:
        raise AssertionError("%s: the recorded step launched %s" % (
            label, launched))
    form = "%s, A=%d, B=1" % (label, A)
    stats = {}
    if quad:
        (rp_args, rp_kw), = rec["rank_prefix"]
        print("recorded step: %d attackers with a target" % int(
            (rp_args[0] < A).sum()), flush=True)
        stats["rank_prefix_hp"] = [call_stats(
            "rank_prefix_hp", rp_args, rp_kw, f32_rate, int32_rate, form)]
        print_split_forms({"rank_prefix_hp": [(rp_args, rp_kw, 1)]}, stats)
    stats["window_gather_banded"] = [
        call_stats("window_gather_banded", a, k, f32_rate, int32_rate,
                   "%s, %s" % (form, name))
        for (a, k), name in zip(rec["window_gather_banded"],
                                ("predators", "prey"))]
    print_window_forms("window_gather_banded",
                       [per_step["window_gather_banded"]] * 2,
                       stats["window_gather_banded"])
    del rec, env
    torch.cuda.empty_cache()
    return counts, stats


def golden_world(name, device):
    """A golden scenario's GridWorld (tests/golden/scenarios.py: its config,
    map and placements)."""
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "golden")
    if golden not in sys.path:
        sys.path.insert(0, golden)
    from scenarios import SCENARIOS
    from magent_tpu_torch import GridWorld, gridworld

    sc = SCENARIOS[name]
    env = GridWorld(sc["cfg"](gridworld, sc["map_size"]), device=device)
    handles = env.get_handles()
    env.reset()
    for h, pos in zip(handles, sc["placements"]):
        env.add_agents(h, method="custom", pos=pos)
    return env, handles


def arrange_world(device):
    """examples/train_arrange.py's config (magent_tpu/renderer/server/
    arrange_server.py:25-49) at its map 100, goals and seekers placed at
    random on 3% and 2% of the cells."""
    from magent_tpu_torch import GridWorld, gridworld as gw

    cfg = gw.Config()
    cfg.set({"map_width": ARRANGE_MAP, "map_height": ARRANGE_MAP,
             "minimap_mode": True, "embedding_size": 12})
    goal = cfg.register_agent_type(
        "goal", {'width': 1, 'length': 1, 'can_absorb': True})
    agent = cfg.register_agent_type(
        "agent", {'width': 1, 'length': 1, 'hp': 10, 'speed': 2,
                  'view_range': gw.CircleRange(6), 'damage': 2,
                  'step_recover': -10.0 / 400, 'step_reward': 0})
    g_goal = cfg.add_group(goal)
    g_agent = cfg.add_group(agent)
    seeker = gw.AgentSymbol(g_agent, 'any')
    marker = gw.AgentSymbol(g_goal, 'any')
    cfg.add_reward_rule(gw.Event(seeker, 'collide', marker), receiver=seeker,
                        value=10)
    env = GridWorld(cfg, device=device)
    handles = env.get_handles()
    env.reset()
    n = ARRANGE_MAP * ARRANGE_MAP
    env.add_agents(handles[0], method="random", n=int(n * 0.03))
    env.add_agents(handles[1], method="random", n=int(n * 0.02))
    return env, handles


def check_grid_world_gpu_matches_cpu(label, build, n_steps, sort=False,
                                     act=None, seed=13):
    """A GridWorld on the GPU and on the CPU: ``build(device) -> (env,
    handles)``, the same actions (``act(env, handle, view, rng)`` on the
    CPU's env and view, or uniform random where it is None or gives None),
    clear_dead every step; views, features, rewards, done and every state
    field (``cell_slot``, ``cell_food``, ``absorbed`` included) exactly
    equal.  ``sort`` builds the step on the sort branches.  -> what the
    run reached: kills, collides, food (cells with food, summed over the
    steps), absorbed (the most at once) and each step's rewards."""
    from magent_tpu_torch.core import engine
    from magent_tpu_torch.core.state import FIELDS
    from magent_tpu_torch.spec import OP_COLLIDE, OP_KILL

    make_step = engine.make_step
    if sort:
        engine.make_step = lambda sp: engine._build_step(
            sp, engine._Route(grid=True, quad=False))
    try:
        worlds = {d: build(d) for d in ("cuda", "cpu")}
    finally:
        engine.make_step = make_step
    routes = {d: env._step_fn.route for d, (env, _) in worlds.items()}
    if routes["cuda"] != routes["cpu"] or (sort and routes["cpu"].quad):
        raise AssertionError("%s: routes %s" % (label, routes))
    env_c, handles = worlds["cpu"]
    rng = np.random.RandomState(seed)
    seen = dict(kills=0, collides=0, food=0, absorbed=0, rewards=[])
    for step in range(n_steps):
        for h in handles:
            (gv, gf), (cv, cf) = (worlds[d][0].get_observation(h)
                                  for d in ("cuda", "cpu"))
            if not (np.array_equal(gv, cv) and np.array_equal(gf, cf)):
                raise AssertionError("%s: observations of group %d differ "
                                     "at step %d" % (label, h.value, step))
            acts = act(env_c, h, cv, rng) if act else None
            if acts is None:
                acts = rng.randint(0, env_c.get_action_space(h)[0],
                                   len(cv)).astype(np.int32)
            for env, _ in worlds.values():
                env.set_action(h, acts)
        out = {}
        for d, (env, _) in worlds.items():
            done = env.step()
            out[d] = (done, [env.get_reward(h) for h in handles])
        if not (out["cuda"][0] == out["cpu"][0] and all(
                np.array_equal(a, b) for a, b in zip(out["cuda"][1],
                                                     out["cpu"][1]))):
            raise AssertionError("%s: done or rewards differ at step %d"
                                 % (label, step))
        st = env_c.state
        seen["kills"] += int((st.last_op == OP_KILL).sum())
        seen["collides"] += int((st.last_op == OP_COLLIDE).sum())
        seen["food"] += int((st.cell_food >= 0).sum())
        seen["absorbed"] = max(seen["absorbed"], int(st.absorbed.sum()))
        seen["rewards"].append(out["cpu"][1])
        for env, _ in worlds.values():
            env.clear_dead()
        for name in FIELDS:
            x = getattr(worlds["cuda"][0].state, name).cpu()
            if not torch.equal(x, getattr(env_c.state, name)):
                raise AssertionError("%s: state field %s differs at step %d"
                                     % (label, name, step))
    route = "sort" if not routes["cpu"].quad else "pair-kernel"
    if env_c._engine_mode == "sequential":
        route = "sequential (host)"
    print("GridWorld GPU vs CPU: %s, %s agents, A=%d, %s route, %d steps "
          "with clear_dead: observations, rewards and states equal (%d "
          "kills, %d collisions, %d food cell-steps, %d absorbed)" % (
              label, [env_c.get_num(h) for h in handles],
              env_c.spec.n_agents_cap, route, n_steps,
              seen["kills"], seen["collides"], seen["food"],
              seen["absorbed"]), flush=True)
    return seen


def check_new_grid_paths_gpu_match_cpu():
    """Phase 10's runs of the grid path's multi-cell bodies, food and
    absorb, each reaching the mechanics it is named for."""
    for m, steps in ((PW_SMALL_MAP, PW_SMALL_STEPS), (1000, PW_BIG_STEPS)):
        seen = check_grid_world_gpu_matches_cpu(
            "pursuit map %d, train_pursuit's layout" % m,
            functools.partial(pursuit_world, m), steps)
        if not seen["collides"]:
            raise AssertionError("pursuit map %d: no collision" % m)
    for name, sort in (("food", False), ("food_crumb", False),
                       ("food_crumb", True)):
        seen = check_grid_world_gpu_matches_cpu(
            "golden %s layout%s" % (name, ", sort branches forced" * sort),
            functools.partial(golden_world, name), FOOD_STEPS, sort)
        if not (seen["kills"] and seen["food"]):
            raise AssertionError("%s: no kill or no food" % name)
    for label, build, steps in (
            ("golden absorb layout", functools.partial(golden_world,
                                                       "absorb"), FOOD_STEPS),
            ("absorb, train_arrange's map %d, random placement"
             % ARRANGE_MAP, arrange_world, ARRANGE_STEPS)):
        if not check_grid_world_gpu_matches_cpu(label, build,
                                                steps)["absorbed"]:
            raise AssertionError("%s: nothing absorbed" % label)


# turn mode (phase 4d): scripts/bench_pursuit.py --turn, pursuit's config
# with turn_mode on and its placements (predators facing at random, seed
# 5).  At its defaults, map 1000 and one world (12,500 + 25,000 agents, A =
# 37,500, past QUAD_MAX_SINGLE), the grid path's sort branches and the turn
# phase; each group's four-band stacked image ([1, 4 * 1048, 5380] and
# [1, 4 * 1040, 5380] f32, 90 MB) is past the 6 MiB image budget: the
# banded gather.  At map 64 with B=16 (phase 5's caps [51, 102]), the pair
# kernels (rank_prefix_hp) and the stacked route ([16, 4 * 112, 770] and
# [16, 4 * 104, 770], 1.4 MB per env): window_gather.  Launches per step
# (the rest 0), and the GPU-vs-CPU steps of each:
TURN_MAPS = {1000: (1, {"window_gather_banded": 2}),
             64: (16, {"window_gather": 2, "rank_prefix_hp": 1})}
TURN_SEED, TURN_GPU_CPU_STEPS, TURN_GOLDEN_STEPS = 5, {64: 3, 1000: 2}, 12


def turn_env(map_size, device=None):
    """bench_pursuit --turn's world at ``map_size`` (1.25% predators, 2.5%
    prey) as a ``VecGridWorld`` of ``TURN_MAPS[map_size]``'s B."""
    from magent_tpu_torch.parallel import VecGridWorld

    n = map_size * map_size
    counts = [int(n * 0.0125), int(n * 0.025)]
    return VecGridWorld(pursuit_config(map_size, True), counts,
                        TURN_MAPS[map_size][0],
                        placements=pursuit_placements(
                            map_size, *counts, True, seed=TURN_SEED),
                        device=device)


def rebuilt_cells(venv, state):
    """``cell_slot`` rebuilt from the live agents' positions, facings and
    body sizes (each body's rect in its facing's footprint)."""
    from magent_tpu_torch.core import geometry as geo

    spec = venv.spec
    B, A = state.x.shape
    H, W, MB = spec.height, spec.width, spec.max_body_w
    dev = state.x.device
    bw, bh = geo.size_for_dir(state.dir,
                              torch.as_tensor(spec.s_width, device=dev),
                              torch.as_tensor(spec.s_length, device=dev))
    alive = state.active & ~state.dead
    slots = torch.arange(A, dtype=torch.int32, device=dev).expand(B, A)
    flat = torch.full((B, H * W + 1), -1, dtype=torch.int32, device=dev)
    for i in range(MB):
        for j in range(MB):
            ok = alive & (i < bw) & (j < bh)
            cell = torch.where(ok, (state.y + j) * W + state.x + i, H * W)
            flat = flat.scatter(1, cell.long(), slots)
    return flat[:, :H * W].reshape(B, H, W)


def run_turn_path(map_size, f32_rate, int32_rate, device_name):
    """Phase 4d at one map: bench_pursuit --turn's lockstep loop, timed
    (launch counts, host syncs, phases, the profiler, peak memory); the
    grid after the timed steps equal to its rebuild, all four facings
    among the live agents; the path's kernels against their plain
    versions on one more step's operands (the window kernels on the
    stacked images in f32 and in bf16).  -> ({kernel: launches in the
    timed run}, {kernel: [call_stats of the step's calls]})."""
    from magent_tpu_torch import random as rnd
    from magent_tpu_torch.core import engine
    from magent_tpu_torch.ops import attack_prefix as ap
    from magent_tpu_torch.ops import window_gather as wg

    n_envs, per_step = TURN_MAPS[map_size]
    label = "turn mode (bench_pursuit --turn) map %d, B=%d" % (map_size,
                                                                n_envs)
    window = [n for n in per_step if n.startswith("window")][0]
    t0 = time.perf_counter()
    venv = turn_env(map_size)
    state = venv.reset(rnd.PRNGKey(0))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    spec = venv.spec
    quad = "rank_prefix_hp" in per_step
    if venv._step.route != engine._Route(grid=True, quad=quad) or [
            o.route for o in venv._observe] != [window] * 2:
        raise AssertionError("%s: route %s, observation routes %s" % (
            label, venv._step.route, [o.route for o in venv._observe]))
    print("%s: %s agents, A=%d, built and reset in %.2f s; %s route and "
          "the turn phase; stacked images %s f32 (%s MB per env), %s" % (
              label, [g.cap for g in spec.groups], spec.n_agents_cap,
              setup_s, "pair-kernel" if quad else "sort",
              [[n_envs, 4 * o.geometry[0], o.geometry[2]]
               for o in venv._observe],
              ["%.2f" % (16 * o.geometry[0] * o.geometry[2] / 1e6)
               for o in venv._observe], window), flush=True)
    torch.cuda.reset_peak_memory_stats()
    counts, state, key, ms_per_step, _ = run_lockstep(
        label, venv, state, rnd.PRNGKey(1), per_step, device_name)
    print("%s: loop peak device memory %.3f GB" % (
        label, torch.cuda.max_memory_allocated() / 1e9), flush=True)
    if not torch.equal(state.cell_slot, rebuilt_cells(venv, state)):
        raise AssertionError("%s: cell_slot differs from its rebuild from "
                             "positions, facings and body sizes" % label)
    alive = state.active & ~state.dead
    facings = torch.bincount(state.dir[alive].long(), minlength=4).tolist()
    if min(facings) == 0:
        raise AssertionError("%s: live agents by facing %s" % (label,
                                                              facings))
    print("%s: cell_slot after the timed steps equals its rebuild (%d "
          "occupied cells); live agents by facing (E, S, W, N) %s" % (
              label, int((state.cell_slot >= 0).sum()), facings), flush=True)
    profile_lockstep(label, venv, state, key, ms_per_step)

    # the path's kernels against their plain versions on one more step
    wrappers = [(wg, window)] + ([(ap, "rank_prefix")] if quad else [])
    carry = [state, key]
    before = launch_counts()
    rec = record_operands(lambda: lockstep_step(venv, carry), wrappers)
    launched = {n: c - before[n] for n, c in launch_counts().items()}
    if launched != {n: per_step.get(n, 0) for n in PATH_KERNELS}:
        raise AssertionError("%s: the recorded step launched %s" % (
            label, launched))
    form = "turn map %d, A=%d, B=%d" % (map_size, spec.n_agents_cap, n_envs)
    stats = {}
    if quad:
        (rp_args, rp_kw), = rec["rank_prefix"]
        stats["rank_prefix_hp"] = [call_stats(
            "rank_prefix_hp", rp_args, rp_kw, f32_rate, int32_rate, form)]
        print_split_forms({"rank_prefix_hp": [(rp_args, rp_kw, 1)]}, stats)
    calls = [(a, k, "%s, %s, stacked %s, liveness" % (form, name, list(
        a[0].shape))) for (a, k), name in zip(rec[window],
                                               ("predators", "prey"))]
    # the banded gather's forms off the path on the stacked images: no
    # epilogue, a seeded minimap, and band order, whose band table mixes
    # the four facings' agents
    off = banded_off_path(calls) if window == "window_gather_banded" else []
    for suffix, dtype in (("", torch.float32), ("_bf16", torch.bfloat16)):
        forms = calls + (off if not suffix else [])
        stats[window + suffix] = [
            call_stats(window + suffix, a, dict(k, out_dtype=dtype),
                       f32_rate, int32_rate, f)
            for a, k, f in forms]
        print_window_forms(
            window + suffix, [per_step[window] if not suffix else 0] * 2
            + [0] * (len(forms) - 2), stats[window + suffix])
    del rec, calls, off, venv, state, carry
    torch.cuda.empty_cache()
    return counts, stats


def check_turn_gpu_matches_cpu():
    """Phase 4d's GPU-vs-CPU runs: bench_pursuit --turn at map 64, B=16
    and at map 1000, and the golden turn_bodies layout through GridWorld
    on both grid routes."""
    for m, steps in TURN_GPU_CPU_STEPS.items():
        check_gpu_matches_cpu(
            "turn mode (bench_pursuit --turn) map %d" % m,
            functools.partial(turn_env, m), steps, 0.0)
    for sort in (False, True):
        seen = check_grid_world_gpu_matches_cpu(
            "golden turn_bodies layout%s" % (", sort branches forced"
                                             * sort),
            functools.partial(golden_world, "turn_bodies"),
            TURN_GOLDEN_STEPS, sort)
        if not seen["collides"]:
            raise AssertionError("turn_bodies: no collision")


# the reference-order engines and the snake (phase 4e).  The sequential
# GridWorld at train_battle's width (map 125, the 2x625 armies of phase 4):
# the step runs on the host (core/seq_engine.py), the observation on the
# card, so a step launches window_gather twice and no pair kernel.  The
# snake at the JAX package's defaults (magent_tpu/discrete_snake.py:88-105:
# map 100, view 21 x 21, 256 slots, rings of 48), walls, food and snakes
# placed as add_walls(100), add_food(500), add_agent(256) with seed 0: one
# window_gather per observation on its 5-channel image.
SEQ_PER_STEP = {"window_gather": 2}
SEQ_WARMUP, SEQ_TIMED, SEQ_GPU_CPU_STEPS = 3, 20, 5
SNAKE_CAPS, SNAKE_MAX_LENGTH, SNAKE_SEED = 256, 48, 0
SNAKE_WALLS, SNAKE_FOOD, SNAKE_AGENTS = 100, 500, 256
SNAKE_WARMUP, SNAKE_TIMED, SNAKE_GPU_CPU_STEPS = 3, 50, 20


def golden_module():
    """``tests/golden/scenarios.py`` (numpy only)."""
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "golden")
    if golden not in sys.path:
        sys.path.insert(0, golden)
    import scenarios

    return scenarios, golden


def assert_golden(name, trace, golden, keys):
    """``tests/test_reference_parity.py``'s and
    ``tests/test_snake_parity.py``'s assertions: ``keys`` maps each trace
    key to its tolerance (None: exact)."""
    if int(trace["steps"]) != int(golden["steps"]):
        raise AssertionError("%s: %d steps, the golden %d" % (
            name, int(trace["steps"]), int(golden["steps"])))
    for key, atol in keys.items():
        if key not in golden:
            continue
        got, want = np.asarray(trace[key]), np.asarray(golden[key])
        ok = got.shape == want.shape and (
            np.array_equal(got.astype(np.int64), want.astype(np.int64))
            if atol is None else bool(np.all(np.abs(got - want) <= atol)))
        if not ok:
            raise AssertionError("%s: %s differs from the C++ golden" % (
                name, key))


def check_goldens_on_card():
    """Phase 4e (1): every GridWorld golden through ``run_scenario`` with
    ``engine_mode="sequential"`` on the card; ``snake_basic`` through
    ``run_snake_scenario`` by the port's sequential snake (host NumPy)."""
    import magent_tpu_torch
    from magent_tpu_torch import GridWorld, gridworld

    sc, golden_dir = golden_module()
    envs = []

    def on_card(cfg, **kwargs):
        envs.append(GridWorld(cfg, device="cuda", **kwargs))
        return envs[-1]

    shim = types.SimpleNamespace(gridworld=gridworld, GridWorld=on_card)
    exact = {k % g: None for g in range(2) for k in (
        "num_%d", "ids_%d_data", "pos_%d_data", "alive_%d_data")}
    close = {k % g: 1e-5 for g in range(2) for k in (
        "rew_%d_data", "views_%d_data", "view0_%d", "feat0_%d")}
    before = launch_counts()
    t0 = time.perf_counter()
    matched = []
    for name in sorted(sc.SCENARIOS):
        golden = dict(np.load(os.path.join(golden_dir,
                                           "golden_%s.npz" % name)))
        trace = sc.flatten_trace(sc.run_scenario(
            shim, name, engine_mode="sequential"), 2)
        if envs[-1].device.type != "cuda" or \
                envs[-1]._engine_mode != "sequential":
            raise AssertionError("%s: ran on %s, %s mode" % (
                name, envs[-1].device, envs[-1]._engine_mode))
        assert_golden(name, trace, golden, dict(done=None, **exact, **close))
        matched.append(name)
    launched = {k: v - before[k] for k, v in launch_counts().items()
                if v != before[k]}
    if not launched or any(not k.startswith("window") for k in launched):
        raise AssertionError("the goldens on the card launched %s" % launched)
    print("phase 4e: %d of %d C++ GridWorld goldens matched on %s by "
          "GridWorld(engine_mode='sequential') (test_reference_parity's "
          "assertions) in %.2f s; launches %s" % (
              len(matched), len(sc.SCENARIOS), torch.cuda.get_device_name(0),
              time.perf_counter() - t0, json.dumps(launched)), flush=True)
    golden = dict(np.load(os.path.join(golden_dir, "golden_snake_basic.npz")))
    trace = sc.flatten_snake_trace(sc.run_snake_scenario(
        magent_tpu_torch, "snake_basic", engine_mode="sequential"))
    assert_golden("snake_basic", trace, golden, {
        "num": None, "food_num": None, "ids_data": None, "head_data": None,
        "length_data": None, "alive_data": None, "rew_data": 1e-5,
        "view0": 1e-5, "feat0": 1e-5})
    print("phase 4e: the C++ golden snake_basic matched by the port's "
          "sequential snake (host NumPy, test_snake_parity's assertions)",
          flush=True)
    return len(matched) + 1


def sequential_world(device, place=place_armies):
    from magent_tpu_torch import GridWorld

    env = GridWorld("battle", map_size=GW_MAP, engine_mode="sequential",
                    device=device)
    handles = env.get_handles()
    env.reset()
    place(env, handles)
    return env, handles


def run_sequential_path(f32_rate, int32_rate, device_name):
    """Phase 4e (2): the sequential GridWorld at train_battle's width,
    timed: wall ms per step, host ms in ``SequentialEngine.step`` and in the
    whole ``_step_sequential`` (the rest is the state's round trip),
    launches per step, host syncs, the profiler; ``window_gather`` against
    its plain version on one more step's operands; then GPU = CPU.  ->
    ({kernel: launches in the timed run}, {kernel: [call_stats]})."""
    from magent_tpu_torch import ops
    from magent_tpu_torch.ops import window_gather as wg

    label = "sequential GridWorld battle map %d" % GW_MAP
    env, handles = sequential_world(None)
    if env.device.type != "cuda":
        raise AssertionError("%s: on %s by default" % (label, env.device))
    rng = np.random.RandomState(0)
    n0 = [env.get_num(h) for h in handles]
    for _ in range(SEQ_WARMUP):
        gridworld_step(env, handles, rng)
    host = {"engine": [], "step": []}
    engine, seq_step = env._seq, env._step_sequential

    def engine_step(S, lcg, _f=engine.step):
        t = time.perf_counter()
        out = _f(S, lcg)
        host["engine"].append(time.perf_counter() - t)
        return out

    def step_sequential():
        t = time.perf_counter()
        out = seq_step()
        host["step"].append(time.perf_counter() - t)
        return out

    engine.step, env._step_sequential = engine_step, step_sequential
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    live = 0
    for _ in range(SEQ_TIMED):
        n, (view, feat), rewards = gridworld_step(env, handles, rng)
        live += n
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    if env._seq is not engine:
        raise AssertionError("%s: the engine was rebuilt" % label)
    ms_per_step = dt / SEQ_TIMED * 1e3
    eng_ms = statistics.mean(host["engine"]) * 1e3
    step_ms = statistics.mean(host["step"]) * 1e3
    print("%s: %s agents placed, A=%d slots, %d timed steps in %.4f s: %.4f "
          "ms/step wall, %.1f agent-steps/s on %s; host ms per step in "
          "SequentialEngine.step %.4f, in _step_sequential %.4f (the state's "
          "round trip %.4f)" % (
              label, n0, env.spec.n_agents_cap, SEQ_TIMED, dt, ms_per_step,
              live / dt, device_name, eng_ms, step_ms, step_ms - eng_ms),
          flush=True)
    expected = {k: SEQ_PER_STEP.get(k, 0) * SEQ_TIMED for k in PATH_KERNELS}
    if counts != expected:
        raise AssertionError("%s: launch counts %s, expected %s" % (
            label, counts, expected))
    vs, fs = env.get_view_space(handles[-1]), env.get_feature_space(
        handles[-1])
    if view.shape[1:] != vs or feat.shape[1:] != fs or not (
            np.isfinite(view).all() and np.isfinite(feat).all()
            and all(np.isfinite(r).all() for r in rewards)):
        raise AssertionError("%s outputs: shapes %s %s, want %s %s, or not "
                             "finite" % (label, view.shape, feat.shape, vs,
                                         fs))
    syncs, sites = count_host_syncs(
        lambda: gridworld_step(env, handles, rng), GW_SYNC_STEPS)
    print("%s: %.1f host syncs per step (torch.cuda sync debug mode, %d "
          "steps); per step by call site: %s" % (
              label, syncs, GW_SYNC_STEPS, json.dumps(
                  {k: v / GW_SYNC_STEPS for k, v in sites.most_common()})),
          flush=True)
    profile_steps(label, lambda: gridworld_step(env, handles, rng),
                  PROFILE_STEPS, ms_per_step)
    rec = record_operands(lambda: gridworld_step(env, handles, rng),
                          [(wg, "window_gather")])
    form = "sequential battle map %d, A=%d, B=1" % (GW_MAP,
                                                    env.spec.n_agents_cap)
    stats = {"window_gather": [
        call_stats("window_gather", a, k, f32_rate, int32_rate,
                   "%s, group %d" % (form, g))
        for g, (a, k) in enumerate(rec["window_gather"])]}
    del rec, env
    torch.cuda.empty_cache()
    # the armies interleaved, so that attacks land from the first step (a
    # landed attack pays 0.2 - 0.1 - 0.005 > 0)
    seen = check_grid_world_gpu_matches_cpu(
        "%s, 2x625 interleaved" % label,
        functools.partial(sequential_world, place=place_interleaved),
        SEQ_GPU_CPU_STEPS)
    if not any((r > 0).any() for rs in seen["rewards"] for r in rs):
        raise AssertionError("%s: the GPU-vs-CPU run landed no attack"
                             % label)
    return counts, stats


def snake_world(device):
    from magent_tpu_torch import discrete_snake as ds

    cfg = ds.Config()
    cfg.set({"seed": SNAKE_SEED})
    env = ds.DiscreteSnake(cfg, caps=SNAKE_CAPS, max_length=SNAKE_MAX_LENGTH,
                           device=device)
    env.add_walls(method="random", n=SNAKE_WALLS)
    env.add_food(method="random", n=SNAKE_FOOD)
    env.add_agent(method="random", n=SNAKE_AGENTS)
    return env


def snake_step(env, rng):
    """``get_observation -> set_action -> step -> get_reward ->
    clear_dead`` with uniform random actions."""
    view, feat = env.get_observation()
    env.set_action(0, rng.randint(0, 5, len(view)).astype(np.int32))
    env.step()
    reward = env.get_reward()
    env.clear_dead()
    return view, feat, reward


def check_snake_gpu_matches_cpu(n_steps):
    from magent_tpu_torch.discrete_snake import SNAKE_FIELDS

    envs = {d: snake_world(d) for d in ("cuda", "cpu")}
    rngs = {d: np.random.RandomState(7) for d in envs}
    died = ate = 0
    for step in range(n_steps):
        out = {d: snake_step(envs[d], rngs[d]) for d in envs}
        for k, what in enumerate(("views", "features", "rewards")):
            a, b = out["cuda"][k], out["cpu"][k]
            if a.shape != b.shape or a.dtype != b.dtype or not np.array_equal(
                    a.view(np.int32), b.view(np.int32)):
                raise AssertionError("snake: %s differ between GPU and CPU "
                                     "at step %d" % (what, step))
        for name in SNAKE_FIELDS:
            if not torch.equal(getattr(envs["cuda"].state, name).cpu(),
                               getattr(envs["cpu"].state, name)):
                raise AssertionError("snake: state field %s differs at step "
                                     "%d" % (name, step))
        died += int((out["cpu"][2] > 1).sum())
        ate += int(((out["cpu"][2] > 0) & (out["cpu"][2] <= 1)).sum())
    if not (died and ate):
        raise AssertionError("snake GPU vs CPU: %d deaths, %d eats" % (died,
                                                                       ate))
    print("snake GPU vs CPU: map %d, %d slots, %d steps: views, features, "
          "rewards and every state field (the threefry key included) equal "
          "(%d deaths, %d eats; %d snakes left)" % (
              envs["cpu"].width, SNAKE_CAPS, n_steps, died, ate,
              envs["cpu"].get_num()), flush=True)


def run_snake_path(f32_rate, int32_rate, device_name):
    """Phase 4e (3): the fast DiscreteSnake at the JAX package's defaults,
    timed (launches, host syncs, the profiler, also with the draws on their
    plain version on the card); ``window_gather`` against its plain version
    on one observation's operands; then GPU = CPU.  -> ({kernel: launches
    in the timed run}, {kernel: [call_stats]})."""
    from magent_tpu_torch import ops
    from magent_tpu_torch import random as rnd
    from magent_tpu_torch.ops import window_gather as wg

    label = "DiscreteSnake map 100"
    env = snake_world(None)
    if env.device.type != "cuda":
        raise AssertionError("%s: on %s by default" % (label, env.device))
    rng = np.random.RandomState(0)
    n0 = env.get_num()
    for _ in range(SNAKE_WARMUP):
        snake_step(env, rng)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    live = 0
    for _ in range(SNAKE_TIMED):
        view, feat, reward = snake_step(env, rng)
        live += len(view)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    ms_per_step = dt / SNAKE_TIMED * 1e3
    print("%s: %d snakes placed in %d slots, %d left after %d timed steps "
          "in %.4f s: %.4f ms/step wall, %.1f snake-steps/s on %s" % (
              label, n0, SNAKE_CAPS, env.get_num(), SNAKE_TIMED, dt,
              ms_per_step, live / dt, device_name), flush=True)
    expected = {k: SNAKE_TIMED * (k == "window_gather") for k in PATH_KERNELS}
    if counts != expected:
        raise AssertionError("%s: launch counts %s, expected %s" % (
            label, counts, expected))
    draws = ops.launch_counts()[RNG_KERNEL]
    if draws != SNAKE_DRAWS * SNAKE_TIMED:
        raise AssertionError("%s: %d threefry launches, expected %d per step"
                             % (label, draws, SNAKE_DRAWS))
    if view.shape[1:] != env.get_view_space() or \
            feat.shape[1:] != env.get_feature_space() or not (
                np.isfinite(view).all() and np.isfinite(feat).all()
                and np.isfinite(reward).all()) or env.get_food_num() <= 0:
        raise AssertionError("%s outputs: shapes %s %s, not finite, or no "
                             "food" % (label, view.shape, feat.shape))
    syncs, sites = count_host_syncs(lambda: snake_step(env, rng),
                                    GW_SYNC_STEPS)
    print("%s: %.1f host syncs per step (torch.cuda sync debug mode, %d "
          "steps); per step by call site: %s" % (
              label, syncs, GW_SYNC_STEPS, json.dumps(
                  {k: v / GW_SYNC_STEPS for k, v in sites.most_common()})),
          flush=True)
    kernel = profile_steps(label, lambda: snake_step(env, rng),
                           PROFILE_STEPS, ms_per_step)
    on_card = rnd._on_card
    rnd._on_card = lambda key: False  # the draws' plain version on the card
    try:
        plain = profile_steps(label + ", plain draws",
                              lambda: snake_step(env, rng), PROFILE_STEPS,
                              ms_per_step)
    finally:
        rnd._on_card = on_card
    if kernel and plain:
        print("phase 4e: the snake's device ops per step: %.1f with the "
              "threefry kernel, %.1f with the plain draws on the card "
              "(%.4f and %.4f device ms per step)" % (
                  kernel[0], plain[0], kernel[1], plain[1]), flush=True)
        if not kernel[0] < plain[0]:
            raise AssertionError("%s: the threefry kernel did not cut the "
                                 "device ops per step" % label)
    rec = record_operands(lambda: snake_step(env, rng),
                          [(wg, "window_gather")])
    (args, kwargs), = rec["window_gather"]
    stats = {"window_gather": [call_stats(
        "window_gather", args, kwargs, f32_rate, int32_rate,
        "snake map 100, view 21x21, A=%d, image %s" % (
            SNAKE_CAPS, list(args[0].shape)))]}
    del rec, env
    torch.cuda.empty_cache()
    check_snake_gpu_matches_cpu(SNAKE_GPU_CPU_STEPS)
    return counts, stats


# launches per step of pursuit's gridless rect path (the rest 0): at map 64
# (B=16), at map 500 (one world, a 6.41 MB image: the banded gather) and at
# map 1000 (one world of 37,500 slots: the segmented sweeps)
PURSUIT_PER_STEP = {"occupant_rect": 1, "rect_first_overlap": 2,
                    "rank_prefix": 1, "window_gather4": 2}
PURSUIT_BIG_PER_STEP = {"occupant_rect": 1, "rect_first_overlap": 2,
                        "rank_prefix": 1, "window_gather_banded": 2}
SEG_PER_STEP = {"occupant_rect_seg": 1, "rect_first_overlap_seg": 2,
                "rank_prefix_seg": 1, "window_gather_banded": 2}
RECT_KERNELS = ("occupant_rect", "rect_first_overlap", "window_gather4")


def pursuit_env(map_size, n_envs, seed, wall_frac=0.0, device=None):
    """``VecGridWorld`` of pursuit with the port's copy of the scripts'
    placements (and interior walls when ``wall_frac`` > 0)."""
    from magent_tpu_torch.builtin.config import pursuit
    from magent_tpu_torch.parallel import VecGridWorld

    placements, walls = pursuit.layout(map_size, seed, wall_frac)
    return VecGridWorld(pursuit.get_config(map_size),
                        [len(p) for p in placements], n_envs,
                        placements=placements, walls=walls or None,
                        device=device)


def record_step(venv, state, key, per_call):
    """One lockstep step with the wrappers named in ``per_call`` recording
    their operands; checks that the step calls each as often as
    ``per_call`` says -> ({name: [(args, kwargs, form)]}, carry [state,
    key], the step's launches by kernel from the launch counters)."""
    from magent_tpu_torch.ops import attack_prefix as ap
    from magent_tpu_torch.ops import window_gather as wg

    carry = [state, key]
    before = launch_counts()
    rec = record_operands(lambda: lockstep_step(venv, carry), [
        (wg if name.startswith("window") else ap, name) for name in per_call])
    launched = {n: c - before[n] for n, c in launch_counts().items()}
    shape = "map %d, A=%d, B=%d" % (venv.spec.width, venv.spec.n_agents_cap,
                                    venv.n_envs)

    def form(name, k, i):
        if "gate" in k:
            return "%s, %s" % (shape, k["gate"])
        if name.startswith("window"):
            return "%s, group %d%s" % (shape, i,
                                       ", liveness" if "act" in k else "")
        return shape + ", attack"

    calls = {name: [(a, k, form(name, k, i))
                     for i, (a, k) in enumerate(rec[name])]
             for name in per_call}
    got = {name: len(c) for name, c in calls.items()}
    if got != per_call or any(launched[n] != c for n, c in per_call.items()):
        raise AssertionError("a pursuit step made the calls %s and launches "
                             "%s, expected %s" % (got, launched, per_call))
    return calls, carry, launched


def off_path_forms(calls):
    """The forms the step does not launch, on its operands: occupant_rect
    with exclude_self, window_gather4 without an epilogue, and with a
    (seeded random) pooled minimap, self cells and liveness."""
    (a, k, form), = calls["occupant_rect"]
    extra = {"occupant_rect": [(a, dict(k, exclude_self=True),
                                form.replace("attack", "exclude_self"))],
             "rect_first_overlap": [], "window_gather4": []}
    gen = torch.Generator(device="cpu").manual_seed(0)
    for a, k, form in calls["window_gather4"]:
        extra["window_gather4"].append((
            a, {n: v for n, v in k.items() if n != "act"},
            form.replace("liveness", "no epilogue")))
        img, pos, mask = a
        vh, vw, C = k["vh"], k["vw"], k["C"]
        ch = torch.zeros(C)
        ch[[2, C - 1]] = 1.0
        mm_mask = ch.repeat(vh, vw)
        mm_img = torch.rand((img.shape[0], vh, vw * C), generator=gen) * mm_mask
        self_cell = torch.randint(0, vh * vw, tuple(pos.shape), generator=gen,
                                  dtype=torch.int32)
        extra["window_gather4"].append((
            [img, pos + self_cell.to(pos.device), mask],
            dict(k, mm_img=mm_img.to(img.device), mm_mask=mm_mask.to(
                img.device)),
            form.replace("liveness", "minimap + self mark + liveness")))
    return extra


# the banded gather's forms off the path, as tools/profile_gather.py names
# them, with their labels here
BANDED_OFF_PATH = {"no epilogue": "no epilogue",
                   "minimap": "minimap + self mark + liveness",
                   "band order": "band order (unsort=False)"}


def banded_off_path(calls):
    """The banded gather's forms the step does not launch, on its operands
    (``tools/profile_gather.py`` ``banded_forms``): slot order without an
    epilogue and with a seeded pooled minimap, self cells and liveness,
    and band order."""
    from magent_tpu_torch.tools import profile_gather as pg

    forms = pg.banded_forms([(a, k) for a, k, *_ in calls])
    return [(list(a), k, call[2].replace("liveness", label))
            for name, label in BANDED_OFF_PATH.items()
            for (a, k), call in zip(forms[name], calls)]


def print_window_forms(name, per_step, stats):
    """One ``window form`` line per form of window kernel ``name``:
    ``stats`` its call_stats dicts, ``per_step`` the entry point's
    launches per step on the path each form's operands come from (0 for
    a form off the path); device ms, the call's time, bound, share of
    bound and the launch split."""
    for n, st in zip(per_step, stats):
        print("window form %s, %-58s %.4f ms (%.4f ms %s), bound %.6f ms "
              "(%s), share of bound %.3f; spans of %d vectors (%d spans); "
              "%d launch(es) per step" % (
                  name, st["form"], st["ms"], st["call_ms"], st["call_what"],
                  st["bound_ms"], st["bound_by"], st["bound_ms"] / st["ms"],
                  st["per"], st["spans"], n), flush=True)


def window_gather4_calls(banded_calls):
    """``window_gather4`` on the images and positions of the banded
    gather's calls (a direct call: the path observes these images with the
    banded gather), with every agent live."""
    out = []
    for (img, pos, mask), k, form in banded_calls:
        geo = {n: k[n] for n in ("vh", "vw", "C", "Wp")}
        out.append(([img, pos * 1024, mask],
                    dict(geo, act=torch.ones_like(pos)),
                    form + ", direct call"))  # the banded form's liveness
    return out


# the kernels on the split template (ops/attack_prefix.py rect_split;
# the segmented two seg_split)
SPLIT_KERNELS = ("occupant", "move_claims", "occupant_rect",
                 "rect_first_overlap", "rank_prefix", "rank_prefix_hp",
                 "occupant_rect_seg", "rank_prefix_seg")


def print_split_forms(calls, stats):
    """One line per form of the split template's kernels (``pair form``,
    ``rect form``, ``rank form``, ``seg form``): ``calls`` {name: [(args,
    kwargs, launches per step)]} of a step's calls and the forms off the
    path (0 per step), ``stats`` {name: [call_stats dicts]} in the same
    order; device ms,
    bound, share of bound, the launch split (for a segmented sweep, the
    one its call's window gives), and launches per step."""
    from magent_tpu_torch.ops import attack_prefix as ap

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name in SPLIT_KERNELS:
        for (args, kw, on_path), st in zip(calls.get(name, ()),
                                           stats.get(name, ())):
            if name.endswith("_seg"):
                P = seg_plan(name, args, kw)[1]
                cluster, warps = ap.seg_split(args[0].shape[0], P, n_sms)
                kind, window = "seg", "window %d rows, " % P
            else:
                B, A = args[0].shape
                cluster, warps = ap.rect_split(B, A, n_sms)
                kind = ("rank" if name.startswith("rank") else "pair"
                        if name in CELL_SWEEPS else "rect")
                window = ""
            print("%s form %s, %-36s %.4f ms, bound %.6f ms (%s), share "
                  "of bound %.3f; %scluster of %d CTA(s) x %d warps (%d "
                  "partner ranges per query tile); %d launch(es) per step" % (
                      kind, name, st["form"], st["ms"], st["bound_ms"],
                      st["bound_by"], st["bound_ms"] / st["ms"], window,
                      cluster, warps, cluster * warps, on_path), flush=True)


# the one-cell sweeps on the split template, held in every split on the
# path's operands and on random operands at these sizes (around the
# 128-slot query tile, battle's 2000 slots, the GridWorld's 2048), B = 1
# and 16; move_claims' non-movers share the grid path's sentinel H * W
CELL_SWEEPS = ("occupant", "move_claims")
CELL_A = (1, 2, 127, 128, 129, 777, 2000, 2048)
CLAIM_SENTINEL = GW_MAP * GW_MAP


def assert_cell_equal(got, want, args, tag):
    """Ints exact; the occupant's hp bit for bit wherever a query matches
    at most two slots, else within PAIR_ATOL (the kernel sums range by
    range).  Returns the max abs error of the floats."""
    from magent_tpu_torch.tools import profile_rect as pr

    err = 0.0
    for g, w in zip(got, want):
        if not g.dtype.is_floating_point:
            if not torch.equal(g, w):
                raise AssertionError("%s: integer outputs differ from the "
                                     "plain version" % tag)
            continue
        few = pr.occupant_matches(args[0], args[1]) <= 2
        e = float((g - w).abs().max()) if g.numel() else 0.0
        if not (torch.equal(g[few], w[few]) and e <= PAIR_ATOL):
            raise AssertionError("%s: hp differs from the plain version "
                                 "(max abs %g)" % (tag, e))
        err = max(err, e)
    return err


def check_cell_splits(name, path_args, path_form, random_a=CELL_A):
    """``occupant`` or ``move_claims`` in every (cluster, warps) split of
    ``tools/profile_rect.py``'s table against its plain version: on the
    main path's operands, then on random operands at ``random_a``, B = 1
    and 16 (the occupant on unique cells, then on duplicate cells;
    move_claims with a third of the slots at one shared sentinel), the
    entry point also called once on each (one launch)."""
    from magent_tpu_torch.tools import profile_rect as pr

    dev = torch.device("cuda", torch.cuda.current_device())
    kernel, plain = kernel_fns()[name]
    forms = [(path_args, path_form)]
    for A in random_a:
        for B in (1, 16):
            if name == "occupant":
                forms += [([t.to(dev) for t in pr.cell_operands(
                    A, B, 11 * A + B + dup, dup)],
                    "random, A=%d, B=%d, %s cells" % (
                        A, B, "duplicate" if dup else "unique"))
                    for dup in (False, True)]
            else:
                forms.append(([pr.claim_operands(
                    A, B, 13 * A + B, CLAIM_SENTINEL).to(dev)],
                    "random, A=%d, B=%d, shared sentinel" % (A, B)))
    n, err = 0, 0.0
    for args, form in forms:
        want = plain(*args)
        for split in pr.SPLITS:
            err = max(err, assert_cell_equal(
                pr.launch(name, args, {}, split), want, args,
                "%s (%s) split %s" % (name, form, split)))
            n += 1
        before = launch_counts()[name]
        err = max(err, assert_cell_equal(kernel(*args), want, args,
                                         "%s (%s)" % (name, form)))
        if launch_counts()[name] != before + 1:
            raise AssertionError("%s: a call did not launch its kernel once"
                                 % name)
    torch.cuda.empty_cache()
    print("%s on the split template: %d launches (%d forms, %d splits each: "
          "the path's operands (%s), random at A in %s, B in (1, 16)) "
          "equal to the plain version, max abs err %g" % (
              name, n, len(forms), len(pr.SPLITS), path_form,
              list(random_a), err),
          flush=True)


def check_rect_ragged():
    """Both forms of occupant_rect and rect_first_overlap against their
    plain versions, exactly, at the ragged sizes of
    ``tools/profile_rect.py`` (B=16 up to A=1000, else B=1; at A=16384
    ``lower_only``'s plain version holds ~2 GB of int64 keys), on random
    bodies and on the two adversarial inputs: every query identical (keys
    tie, the slot decides), and the one body at the last slot of the last
    range."""
    from magent_tpu_torch.ops import attack_prefix as ap
    from magent_tpu_torch.tools import profile_rect as pr

    dev = torch.device("cuda", torch.cuda.current_device())
    n = 0

    def check(name, args, **kw):
        nonlocal n
        args = [a.to(dev) for a in args]
        fn, ref = ((ap.occupant_rect, ap.occupant_rect_ref)
                   if name == "occupant_rect" else
                   (ap.rect_first_overlap, ap.rect_first_overlap_ref))
        got, want = fn(*args, **kw), ref(*args, **kw)
        for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (got, want))):
            if not torch.equal(g, w):
                raise AssertionError("%s %s at A=%d, B=%d: differs from the "
                                     "plain version" % (name, kw,
                                                        *args[0].shape[::-1]))
        n += 1

    for A in pr.RAGGED_A:
        B = 16 if A <= 1000 else 1
        occ, excl, low = pr.ragged_operands(A, B, A)
        for es in (False, True):
            check("occupant_rect", occ, exclude_self=es)
        check("rect_first_overlap", excl, max_body=2, gate="exclude_self")
        check("rect_first_overlap", low, max_body=2, gate="lower_only")
        for case in ("ties", "last"):
            for lower in (False, True):
                if case == "last" and A < 2 and lower:
                    continue
                occ, rect = pr.adversarial_operands(A, B, case, lower)
                check("occupant_rect", occ, exclude_self=lower)
                check("rect_first_overlap", rect, max_body=2,
                      gate="lower_only" if lower else "exclude_self")
        torch.cuda.empty_cache()
    print("rect sweeps on ragged operands: %d calls at A in %s, each equal "
          "to its plain version" % (n, list(pr.RAGGED_A)), flush=True)


def shared_target_form(calls):
    """``rank_prefix``'s form with values that can show a wrong sum, on the
    step's ranks: each run of SEG_SHARE slots shares a target, and every
    slot deals seeded random damage (pursuit deals none, and its attackers
    rarely share a target).  Marked: its sums must not all be zero."""
    (a, k, form), = calls["rank_prefix"]
    tgt, rank, _ = a
    B, A = tgt.shape
    gen = torch.Generator(device="cpu").manual_seed(P_BIG_SEED)
    shared = (torch.arange(A) // SEG_SHARE).to(torch.int32).expand(B, A)
    dmg = 0.1 + 0.9 * torch.rand((B, A), generator=gen)
    return ([shared.contiguous().to(tgt.device), rank, dmg.to(tgt.device)],
            k, form.replace("attack", "runs of %d slots share a target, "
                            "random damage" % SEG_SHARE), True)


def run_rank_forms(calls, rank_row, f32_rate, int32_rate):
    """``rank_prefix`` on a pursuit step's operands and on
    :func:`shared_target_form`, against its plain version; the forms join
    ``rank_row``'s ``per_call`` and print their ``rank form`` lines."""
    forms = calls["rank_prefix"] + [shared_target_form(calls)]
    stats = [call_stats("rank_prefix", a, k, f32_rate, int32_rate, *form)
             for a, k, *form in forms]
    rank_row["per_call"] += stats
    print_split_forms({"rank_prefix": [(forms[0][0], {}, 1),
                                       (forms[1][0], {}, 0)]},
                      {"rank_prefix": stats})


def run_pursuit_paths(f32_rate, int32_rate, device_name, rank_row):
    """Phases 5 and 6: pursuit's gridless rect path at map 64, B=16 and on
    one world at map 500; returns the rect kernels' rows, the map-500
    banded gather's forms (the step's calls, then the forms off the path)
    with their launches per step, the map-500 loop's host syncs per step
    and the map-64 ``window_gather4`` forms; ``rank_prefix``'s forms join
    ``rank_row``."""
    from magent_tpu_torch import random as rnd

    venv = pursuit_env(P_MAP, P_ENVS, P_SEED)
    calls, carry, launched = record_step(venv, venv.reset(rnd.PRNGKey(0)),
                               rnd.PRNGKey(1), {"occupant_rect": 1,
                                                "rect_first_overlap": 2,
                                                "rank_prefix": 1,
                                                "window_gather4": 2})
    extra = off_path_forms(calls)
    rows = {name: kernel_row(name, calls[name], f32_rate, int32_rate,
                             extra[name]) for name in RECT_KERNELS}
    print_split_forms(
        {name: [(a, k, 1) for a, k, _ in calls[name]] +
         [(a, k, 0) for a, k, _ in extra[name]] for name in RECT_KERNELS},
        {name: rows[name]["per_call"] for name in RECT_KERNELS})
    print_window_forms(
        "window_gather4", [launched["window_gather4"]] * len(
            calls["window_gather4"]) + [0] * len(extra["window_gather4"]),
        rows["window_gather4"]["per_call"])
    run_rank_forms(calls, rank_row, f32_rate, int32_rate)
    # window_gather4's map-64 forms, for phase 9's bf16 store
    g4_forms = calls["window_gather4"] + extra["window_gather4"]
    del calls, extra
    counts, state, key, ms_per_step, _ = run_lockstep(
        "pursuit lockstep, map %d" % P_MAP, venv, *carry, PURSUIT_PER_STEP,
        device_name)
    for name in RECT_KERNELS:
        rows[name]["launches"] = counts[name]
    profile_lockstep("pursuit lockstep", venv, state, key, ms_per_step)
    del venv, state, carry
    torch.cuda.empty_cache()

    big = pursuit_env(P_BIG_MAP, 1, P_BIG_SEED)
    calls, carry, launched = record_step(big, big.reset(rnd.PRNGKey(2)),
                               rnd.PRNGKey(3), {"occupant_rect": 1,
                                                "rect_first_overlap": 2,
                                                "rank_prefix": 1,
                                                "window_gather_banded": 2})
    banded = calls.pop("window_gather_banded")
    off = banded_off_path(banded)
    banded_500 = (banded + off, [launched["window_gather_banded"]] * len(
        banded) + [0] * len(off))
    calls["window_gather4"] = window_gather4_calls(banded)
    extra = off_path_forms(calls)
    big_stats = {name: [call_stats(name, a, k, f32_rate, int32_rate, form)
                        for a, k, form in calls[name] + extra[name]]
                 for name in RECT_KERNELS}
    for name in RECT_KERNELS:
        rows[name]["per_call"] = rows[name].get("per_call", []) + \
            big_stats[name]
    print_split_forms(
        {name: [(a, k, 1) for a, k, _ in calls[name]] +
         [(a, k, 0) for a, k, _ in extra[name]] for name in RECT_KERNELS},
        big_stats)
    print_window_forms("window_gather4",
                       [0] * len(big_stats["window_gather4"]),
                       big_stats["window_gather4"])
    run_rank_forms(calls, rank_row, f32_rate, int32_rate)
    del calls, extra, banded, off
    torch.cuda.empty_cache()
    _, state, key, ms_per_step, syncs = run_lockstep(
        "pursuit one world, map %d" % P_BIG_MAP, big, *carry,
        PURSUIT_BIG_PER_STEP, device_name)
    profile_lockstep("pursuit one world", big, state, key, ms_per_step)
    del big, state, carry
    torch.cuda.empty_cache()
    return rows, banded_500, syncs, g4_forms


def valued_seg_forms(calls):
    """Give the step's occupant and rank sweeps values that can show a
    wrong row: pursuit's hp is 1 everywhere and it deals no damage, so
    ``calls``' occupant form takes seeded random hp and its rank form
    seeded random damage on the valid rows (targets below A), in place;
    returns the rank sweep's dense form, in which each run of SEG_SHARE
    sorted rows shares a target (the step's attackers rarely share one).
    The occupant form and the dense form are marked: their float results
    must not all be zero."""
    gen = torch.Generator(device="cpu").manual_seed(P_SEG_SEED)

    def uniform(like):
        return (0.1 + 0.9 * torch.rand(like.shape[0], generator=gen)).to(
            like.device)

    (a, k, form), = calls["occupant_rect_seg"]
    calls["occupant_rect_seg"] = [(a[:6] + [uniform(a[6])] + a[7:], k,
                                   form + ", random hp", True)]
    (a, k, form), = calls["rank_prefix_seg"]
    tgt, rank, _, sort_y = a
    A = tgt.shape[0]
    calls["rank_prefix_seg"] = [([tgt, rank, torch.where(
        tgt < A, uniform(tgt), 0.0), sort_y], k, form + ", random damage")]
    shared = (torch.arange(A, device=tgt.device) // SEG_SHARE).to(torch.int32)
    return {"rank_prefix_seg": [(
        [shared, rank, uniform(tgt), sort_y], k,
        form + ", runs of %d rows share a target, random damage" % SEG_SHARE,
        True)]}


def seg_overflow_forms(name, forms):
    """The segmented sweeps' overflow branch on the card: each form on its
    first SEG_OVERFLOW_ROWS sorted rows with a window of SEG_OVERFLOW_WIN
    rows, narrower than a 1024-row segment, so that the plan overflows and
    every row sweeps all rows (the plain version's full sweep with
    explicit slot ids)."""
    out = []
    for args, kw, form, *nonzero in forms:
        cut = [a[:SEG_OVERFLOW_ROWS] for a in args]
        k = {n: v for n, v in kw.items() if n != "plan"}
        k["seg_win"] = SEG_OVERFLOW_WIN
        k["plan"] = seg_plan(name, cut, k)
        if not bool(k["plan"][3]):
            raise AssertionError("%s: the narrow window did not overflow"
                                 % name)
        out.append((cut, k, "%s; overflow: first %d sorted rows, window %d"
                    % (form, SEG_OVERFLOW_ROWS, SEG_OVERFLOW_WIN), *nonzero))
    return out


def check_seg_splits(forms):
    """``occupant_rect_seg`` and ``rank_prefix_seg`` on each of their
    ``forms`` ({name: [(args, kwargs, form, ...)]}) in every split of
    ``tools/profile_rect.py``'s table against the plain version: ints and
    the occupant's hp exact (pursuit's bodies never overlap), rank sums
    within PAIR_ATOL (the kernel sums range by range)."""
    from magent_tpu_torch.tools import profile_rect as pr

    n, err = 0, 0.0
    for name in pr.SEG_SPLIT_SWEEPS:
        plain = kernel_fns()[name][1]
        for args, kw, form, *_ in forms[name]:
            want = plain(*args, **kw)
            want = want if isinstance(want, tuple) else (want,)
            for split in pr.SPLITS:
                got = pr.launch(name, args, kw, split)
                got = got if isinstance(got, tuple) else (got,)
                for g, w in zip(got, want):
                    e = float((g - w).abs().max()) if g.numel() else 0.0
                    exact = name in EXACT or not g.dtype.is_floating_point
                    if not (torch.equal(g, w) if exact else e <= PAIR_ATOL):
                        raise AssertionError(
                            "%s (%s) split %s: differs from the plain "
                            "version (max abs %g)" % (name, form, split, e))
                    err = max(err, e)
                n += 1
    print("seg sweeps on the split template: %d launches (%d splits per "
          "form) equal to their plain versions, max abs err %g" % (
              n, len(pr.SPLITS), err), flush=True)


def run_seg_path(f32_rate, int32_rate, device_name, banded_500, syncs_500):
    """Phase 7: pursuit on one world at map 1000 through the segmented
    sweeps and the banded gather; ``banded_500`` are phase 6's banded
    forms and their launches per step; returns the four kernels' rows and
    the banded gather's map-1000 forms: the step's calls and the forms off
    the path."""
    from magent_tpu_torch import random as rnd
    from magent_tpu_torch.ops import attack_prefix as ap
    from magent_tpu_torch.tools import profile_rect as pr

    big = pursuit_env(P_SEG_MAP, 1, P_SEG_SEED)
    if not big._step.route.seg or [o.route for o in big._observe] != [
            "window_gather_banded"] * 2:
        raise AssertionError("map %d: route %s, observation routes %s" % (
            P_SEG_MAP, big._step.route, [o.route for o in big._observe]))
    calls, carry, launched = record_step(big, big.reset(rnd.PRNGKey(4)),
                                         rnd.PRNGKey(5), SEG_PER_STEP)
    extra = valued_seg_forms(calls)
    for name in SEG_SWEEPS:
        forms = extra.get(name, [])
        extra[name] = forms + seg_overflow_forms(name, calls[name] + forms)
    banded = calls["window_gather_banded"]
    off = banded_off_path(banded)
    extra["window_gather_banded"] = off + banded_500[0]
    rows = {name: kernel_row(name, calls[name], f32_rate, int32_rate,
                             extra[name]) for name in SEG_PER_STEP}
    split_seg = pr.SEG_SPLIT_SWEEPS
    check_seg_splits({name: calls[name] + extra[name] for name in split_seg})
    print_split_forms(
        {name: [(a, k, SEG_PER_STEP[name]) for a, k, *_ in calls[name]] +
         [(a, k, 0) for a, k, *_ in extra[name]] for name in split_seg},
        {name: rows[name]["per_call"] for name in split_seg})
    print_window_forms(
        "window_gather_banded", [launched["window_gather_banded"]] * len(
            banded) + [0] * len(off) + banded_500[1],
        rows["window_gather_banded"]["per_call"])
    banded_1000 = (banded, off)
    del calls, extra, banded, off
    torch.cuda.empty_cache()

    # every plan of the timed steps, its overflow flag kept on the device
    # and read after the run
    flags = []

    @contextlib.contextmanager
    def recording_plans():
        plan = ap._seg_plan

        def recording_plan(*args, **kwargs):
            out = plan(*args, **kwargs)
            flags.append(out[3])
            return out

        ap._seg_plan = recording_plan
        try:
            yield
        finally:
            ap._seg_plan = plan

    counts, state, key, ms_per_step, syncs = run_lockstep(
        "pursuit one world, map %d" % P_SEG_MAP, big, *carry, SEG_PER_STEP,
        device_name, timed=recording_plans)
    if len(flags) != SEG_PLANS_PER_STEP * TIMED_STEPS:
        raise AssertionError("map %d: %d plans in %d timed steps, expected "
                             "%d per step" % (P_SEG_MAP, len(flags),
                                              TIMED_STEPS, SEG_PLANS_PER_STEP))
    timed = torch.stack(flags).reshape(TIMED_STEPS, SEG_PLANS_PER_STEP)
    n_over = int(timed.any(1).sum())
    print("pursuit one world, map %d: %d of %d timed steps had a plan that "
          "overflowed (%d of %d plans)" % (
              P_SEG_MAP, n_over, TIMED_STEPS, int(timed.sum()),
              timed.numel()), flush=True)
    if syncs > syncs_500:
        raise AssertionError("map %d: %.1f host syncs per step, more than "
                             "the map-%d loop's %.1f" % (
                                 P_SEG_MAP, syncs, P_BIG_MAP, syncs_500))
    for name in SEG_PER_STEP:
        rows[name]["launches"] = counts[name]
    profile_lockstep("pursuit map %d" % P_SEG_MAP, big, state, key,
                     ms_per_step)
    del big, state, carry
    torch.cuda.empty_cache()
    return rows, banded_1000


def ladder_bounds(inp, f32_rate):
    """{variant: (bound ms, "bytes" or "operations", bytes)} of the cost
    ladder's variants on ``inp``: every output written once; each input the
    variant reads, read once (the packed words from ``smem`` up, the whole
    image from ``load`` up, the mask from ``mask`` up; ``window_gather4``
    its packed positions, and with the epilogue its operands); one f32
    operation per output element from ``mask`` up (``prod_mm``: 4, the
    mask and liveness multiplies and the two minimap adds)."""
    pos = inp["pos"]
    n_out = pos.numel() * inp["mask"].numel()
    out = n_out * 4
    words = 2 * nbytes([pos])  # word and aux, int32 [B, N] each
    image, mask = nbytes([inp["gfull"]]), nbytes([inp["mask"]])
    epilogue = nbytes([inp["mm_img"], inp["mm_mask"], inp["act"]])
    need = {"floor": (out, 0), "smem": (out + words, 0),
            "load": (out + words + image, 0),
            "roll1": (out + words + image, 0),
            "roll2": (out + words + image, 0),
            "mask": (out + words + image + mask, 1),
            "shared": (out + words + image + mask, 1),
            "prod": (out + nbytes([pos]) + image + mask, 1),
            "prod_mm": (out + nbytes([pos]) + image + mask + epilogue, 4)}
    bounds = {}
    for name, (n_bytes, n_f32) in need.items():
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_f32 * n_out / f32_rate * 1e3
        bounds[name] = (max(bytes_ms, ops_ms),
                        "bytes" if bytes_ms >= ops_ms else "operations",
                        n_bytes)
    return bounds


def run_window_ladder(f32_rate):
    """Phase 8: the window-gather cost ladder at the script's geometry;
    returns the rows of ``window_ladder`` and ``window_shared_tile``."""
    from magent_tpu_torch import ops
    from magent_tpu_torch.ops import window_ladder as wl
    from magent_tpu_torch.tools import profile_window as pw

    B, N, chunk = pw.CARD
    inp = pw.make_inputs(pw.SEED, B=B, N=N, device="cuda")
    g, pos, mask = inp["gfull"], inp["pos"], inp["mask"]
    kw = dict(pw.geometry(inp), chunk=chunk)
    forms = {level: ("window_ladder",
                     functools.partial(wl.ladder, level=level),
                     functools.partial(wl.ladder_ref, level=level))
             for level in wl.LEVELS}
    forms["shared"] = ("window_shared_tile", wl.shared_tile,
                       wl.shared_tile_ref)
    checked = {}
    for name, (counter, kernel, plain) in forms.items():
        before = launch_counts()[counter]
        got = kernel(g, pos, mask, **kw)
        if launch_counts()[counter] != before + 1:
            raise AssertionError("ladder %s: a call did not launch its "
                                 "kernel once" % name)
        want = plain(g, pos, mask, **kw)
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError("ladder %s: max |kernel - plain| = %g" % (
                name, float((got - want).abs().max())))
        checked[name] = dict(
            max_abs_err=0.0, n_nonzero=int((want != 0).sum()),
            plain_ms=device_ms(lambda: plain(g, pos, mask, **kw), 5))
        del got, want
    pw.check(inp, chunk)
    print("ladder: every level and shared equal their plain versions "
          "(max abs error 0; non-zero values %s), ladder(mask) equals "
          "window_gather4; B=%d, N=%d, chunks of %d, image %s" % (
              json.dumps({k: v["n_nonzero"] for k, v in checked.items()}),
              B, N, chunk, tuple(g.shape)), flush=True)
    torch.cuda.empty_cache()

    ops.reset_launch_counts()
    ms = pw.profile(pw.VARIANTS, inp, chunk)
    torch.cuda.synchronize()
    counts = launch_counts()
    ran = {k for k, v in counts.items() if v}
    if ran != {"window_ladder", "window_shared_tile", "window_gather4"}:
        raise AssertionError("the ladder's run launched %s" % counts)
    bounds = ladder_bounds(inp, f32_rate)
    steps = pw.increments(ms)
    for name in pw.VARIANTS:
        b_ms, by, n_bytes = bounds[name]
        step = (" (%+.4f over %s)" % steps[name] if name in steps else "")
        print("ladder %-8s %.4f ms device%s  bound %.6f ms (%s; %.3f MB)  "
              "%.3f of bound" % (name, ms[name], step, b_ms, by,
                                 n_bytes / 1e6, b_ms / ms[name]), flush=True)
    top = max(wl.LEVELS, key=lambda level: steps[level][0])
    print("ladder: the largest increment is %s, +%.4f ms: %s; mask %.4f ms "
          "vs window_gather4 %.4f ms, shared %.4f ms; launches %s" % (
              top, steps[top][0], pw.COMPONENTS[top], ms["mask"], ms["prod"],
              ms["shared"], json.dumps({k: counts[k] for k in sorted(ran)})),
          flush=True)

    rows = {}
    for counter, names in (("window_ladder", wl.LEVELS),
                           ("window_shared_tile", ("shared",))):
        per = [dict(form="level %s" % name, max_abs_err=0.0, ms=ms[name],
                    plain_ms=checked[name]["plain_ms"],
                    bound_ms=bounds[name][0], bound_by=bounds[name][1])
               for name in names]
        # the row's numbers are those of the whole kernel: the mask level
        top = per[-1]
        rows[counter] = dict(
            name=counter, route="cuda", source=SOURCES[counter],
            replaces=REPLACES[counter], launches=counts[counter],
            max_abs_err=0.0, ms=top["ms"], plain_ms=top["plain_ms"],
            bound_ms=top["bound_ms"], bound_by=top["bound_by"],
            library_ms=None,
            path="measurement only: tools/profile_window.py, B=%d, N=%d, "
                 "chunks of %d" % (B, N, chunk))
        if len(per) > 1:
            rows[counter]["per_call"] = per
    del inp, g, pos, mask
    torch.cuda.empty_cache()
    return rows


def trusty_nets(spec, device, dtype=torch.float32):
    """One ``DQNNet`` per group from the trusty battle checkpoints (read
    with numpy: flax is not needed), on ``device``."""
    from magent_tpu_torch.builtin.torch_model import DQNNet, params_from_flax

    nets = []
    for g, path in enumerate(TRUSTY):
        net = DQNNet(spec.view_space(g), spec.feature_size(g),
                     spec.groups[g].type.n_action, dtype=dtype)
        net.load_state_dict(params_from_flax(dict(np.load(path))))
        nets.append(net.to(device))
    return tuple(nets)


def check_bf16_views(label, venv, state):
    """Every group's bf16 views (``make_observe(..., obs_dtype=bf16)``) are
    its f32 views rounded, and its features equal; where a view differs,
    the count is printed and the bf16 views are held to the plain versions
    (the same observation of the state moved to the CPU) instead."""
    from magent_tpu_torch.core import observe
    from magent_tpu_torch.core.state import FIELDS, State

    bf16 = torch.bfloat16
    grids = venv._grids(state)
    n_diff = n_all = 0
    for g in range(venv.spec.n_groups):
        v32, f32 = observe.make_observe(venv.spec, g)(state, grids)
        obs16 = observe.make_observe(venv.spec, g, obs_dtype=bf16)
        v16, f16 = obs16(state, grids)
        if v16.dtype != bf16 or not torch.equal(f16, f32):
            raise AssertionError("%s group %d: bf16 views %s, features "
                                 "changed" % (label, g, v16.dtype))
        diff = int((v16 != v32.to(bf16)).sum())
        n_diff += diff
        n_all += v16.numel()
        if diff:
            cpu = State(**{f: getattr(state, f).cpu() for f in FIELDS})
            if not torch.equal(v16.cpu(), obs16(cpu)[0]):
                raise AssertionError("%s group %d: bf16 views differ from "
                                     "the plain versions" % (label, g))
    print("bf16 views, %s: %d of %d values differ from the f32 views rounded "
          "(%s); features equal" % (
              label, n_diff, n_all, "held to the plain versions instead"
              if n_diff else "all equal"), flush=True)


def trainer_loop(alg, venv, tx, dtype):
    """``tools.bench_train``'s loop of trainer ``alg`` on ``venv`` and its
    first carry: ``dqn``, ``dqn_remat`` from the trusty weights, ``a2c``,
    ``drqn`` fresh from seeded generators."""
    nets = (trusty_nets(venv.spec, venv.device, dtype)
            if alg in ("dqn", "dqn_remat") else None)
    return bench_train.trainer_loop(alg, venv, tx, dtype, nets)


def train_split_ms(alg, step, carry, key, n=3):
    """Median ms of the rollout and of the learner of ``n`` more train
    steps of trainer ``alg`` (synchronized host clock around each half);
    ``carry`` advances in place."""
    from magent_tpu_torch import random as rnd

    roll, learn = [], []
    for i in range(n):
        rkey, lkey = rnd.split(rnd.fold_in(key, i)).unbind(-2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if alg == "a2c":
            nets, opts, state = carry
            state, traj = step.rollout(nets, state, rkey)
        elif alg == "drqn":
            nets, tnets, opts, h0_state, h0 = carry
            state, hiddens, traj = step.rollout(nets, h0_state, h0, rkey,
                                                TRAIN_EPS)
        else:
            nets, tnets, opts, state = carry
            state, traj = step.rollout(nets, state, rkey, TRAIN_EPS)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if alg == "a2c":
            opts, _ = step.learn(nets, opts, state, traj)
            carry[:] = nets, opts, state
        elif alg == "drqn":
            opts, _ = step.learn(nets, tnets, opts, h0, traj)
            carry[:] = (nets, tnets, opts, state,
                        tuple(h.detach() for h in hiddens))
        else:
            opts, _ = step.learn(nets, tnets, opts, traj, lkey)
            carry[:] = nets, tnets, opts, state
        torch.cuda.synchronize()
        roll.append((t1 - t0) * 1e3)
        learn.append((time.perf_counter() - t1) * 1e3)
        del traj
    return statistics.median(roll), statistics.median(learn)


def run_trainer(alg, venv, tx, device_name):
    """Phase 9, one trainer at scripts/bench_train.py's geometry on
    ``venv`` (bf16 views and trunk): a warm call, TRAIN_CALLS timed calls
    of TRAIN_SPC steps (trained agent-steps/s, peak memory, the launch
    counts asserted), the rollout/learner split, host syncs and the
    profiler over one train step -> the timed calls' launch counts."""
    from magent_tpu_torch import ops
    from magent_tpu_torch import random as rnd
    from magent_tpu_torch.builtin.torch_model import params_to_flax

    dev = venv.device
    n_env = TRAIN_ROLLOUT * TRAIN_SPC * TRAIN_CALLS
    n_train = TRAIN_SPC * TRAIN_CALLS
    loop, carry = trainer_loop(alg, venv, tx, torch.bfloat16)
    lk = rnd.PRNGKey(2, dev)
    before = [params_to_flax(n) for n in carry[0]]

    def call(c):
        out = loop(*carry, *trainer_args(alg, rnd.fold_in(lk, c), c))
        carry[:] = out[:-1]
        return out[-1]

    float(call(0)["loss"].sum())  # the warm call
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = [call(c) for c in range(1, TRAIN_CALLS + 1)]
    loss = torch.stack([m["loss"] for m in metrics]).cpu()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    agent_steps = 2 * N_PER_GROUP * N_ENVS * n_env
    ms_step = dt / n_train * 1e3
    extra = ("; mean values %s" % torch.stack(
        [m["mean_value"] for m in metrics]).cpu()[-1].tolist()
        if alg == "a2c" else "")
    print("trainer %s: battle 2x%d, map %d, B=%d, rollout %d, %d steps "
          "per call, bf16 views and trunk, %s: %d timed calls in %.4f s: "
          "%.1f trained agent-steps/s, %.3f ms per train step on %s; "
          "losses %s%s; peak device memory %.3f GB" % (
              alg, N_PER_GROUP, MAP_SIZE, N_ENVS, TRAIN_ROLLOUT,
              TRAIN_SPC, TRAINER_NETS[alg], TRAIN_CALLS, dt,
              agent_steps / dt, ms_step, device_name, loss[-1].tolist(),
              extra, peak / 1e9), flush=True)
    expected = {name: 0 for name in PATH_KERNELS}
    expected.update(
        window_gather_bf16=2 * n_env + LEARNER_VIEWS[alg] * n_train,
        occupant=n_env, rank_prefix=n_env, move_resolve=n_env)
    if counts != expected:
        raise AssertionError("trainer %s: launch counts %s, expected %s"
                             % (alg, counts, expected))
    print("trainer %s: launches per train step %s" % (alg, json.dumps(
        {k: v / n_train for k, v in counts.items() if v})), flush=True)
    if not bool(torch.isfinite(loss).all()):
        raise AssertionError("trainer %s: losses not finite" % alg)
    for g, flat in enumerate(before):
        now = params_to_flax(carry[0][g])
        if all(np.array_equal(now[k], flat[k]) for k in flat):
            raise AssertionError("trainer %s: group %d's params did not "
                                 "change" % (alg, g))
    if alg == "drqn" and any(h.requires_grad for h in carry[4]):
        raise AssertionError("trainer drqn: the hiddens carry a graph")

    step = loop.train_step
    roll_ms, learn_ms = train_split_ms(alg, step, carry,
                                       rnd.PRNGKey(3, dev))
    print("trainer %s: a train step is %.3f ms of rollout (%d env steps) "
          "and %.3f ms of learner (median of 3 synchronized steps)" % (
              alg, roll_ms, TRAIN_ROLLOUT, learn_ms), flush=True)
    args = trainer_args(alg, rnd.PRNGKey(4, dev), step=True)

    def one_step():
        step(*carry, *args)

    syncs, sites = count_host_syncs(one_step, 1)
    print("trainer %s: %.1f host syncs per train step (torch.cuda sync "
          "debug mode); by call site: %s" % (
              alg, syncs, json.dumps(dict(sites.most_common()))),
          flush=True)
    profile_steps("trainer %s, per train step" % alg, one_step, 1,
                  ms_step)
    del loop, step, carry, metrics, one_step, call
    torch.cuda.empty_cache()
    return counts


def run_trainers(f32_rate, int32_rate, device_name, g4_forms, banded_1000):
    """Phase 9: the fused trainers at scripts/bench_train.py's geometry
    with bf16 views and trunk -> (the bf16 window kernels' rows
    (``window_gather4`` on phase 5's forms, ``window_gather_banded`` on
    phase 7's: the step's calls, the forms off the path), each trainer's
    launch counts)."""
    from magent_tpu_torch import random as rnd
    from magent_tpu_torch.builtin.config import battle
    from magent_tpu_torch.ops import window_gather as wg
    from magent_tpu_torch.parallel import ClipAdam, VecGridWorld

    bf16 = torch.bfloat16
    venv = VecGridWorld(battle.get_config(MAP_SIZE),
                        [N_PER_GROUP, N_PER_GROUP], N_ENVS, obs_dtype=bf16)
    dev = venv.device
    state = venv.reset(rnd.PRNGKey(1, dev))

    # the bf16 stores against their plain versions: window_gather on the
    # trainer's operands, window_gather4 at pursuit map 64, the banded
    # gather on the map-1000 band table
    rec = record_operands(lambda: venv.observe_all(state),
                          [(wg, "window_gather")])
    if [k.get("out_dtype") for _, k in rec["window_gather"]] != [bf16] * 2:
        raise AssertionError("the bf16 observation made the window calls %s"
                             % [k.get("out_dtype") for _, k in
                                rec["window_gather"]])
    (img, pos, mask), kw = rec["window_gather"][0]
    rows = {"window_gather_bf16": kernel_row(
        "window_gather_bf16",
        [(a, k, "battle 2x1000, B=16, group %d" % g)
         for g, (a, k) in enumerate(rec["window_gather"])],
        f32_rate, int32_rate,
        [([img[:1].contiguous(), pos[:1].contiguous(), mask], kw,
          "battle 2x1000, B=1 (env 0), group 0")])}
    del rec

    def as_bf16(forms):
        return [(a, dict(k, out_dtype=bf16), form + ", bf16")
                for a, k, form, *_ in forms]

    rows["window_gather4_bf16"] = kernel_row(
        "window_gather4_bf16", as_bf16(g4_forms[:2]), f32_rate, int32_rate,
        as_bf16(g4_forms[2:]))
    rows["window_gather_banded_bf16"] = kernel_row(
        "window_gather_banded_bf16", as_bf16(banded_1000[0]), f32_rate,
        int32_rate, as_bf16(banded_1000[1]))
    # bf16 views are on no path of pursuit, which trains in f32
    for name in ("window_gather4_bf16", "window_gather_banded_bf16"):
        print_window_forms(name, [0] * len(rows[name]["per_call"]),
                           rows[name]["per_call"])
    torch.cuda.empty_cache()

    check_bf16_views("battle 2x1000, B=16", venv, state)
    p64 = pursuit_env(P_MAP, P_ENVS, P_SEED)
    check_bf16_views("pursuit map 64, B=16", p64, p64.reset(rnd.PRNGKey(0)))
    del p64

    tx = ClipAdam(TRAIN_LR, bench_train.CLIP)
    by_alg = {alg: run_trainer(alg, venv, tx, device_name)
              for alg in TRAINERS}
    launches = sum(map(collections.Counter, by_alg.values()),
                   collections.Counter())

    for name, row in rows.items():
        row["launches"] = launches[name]
    rows["window_gather_bf16"]["path"] = (
        "the fused trainers %s, %d timed calls each" % (
            ", ".join(TRAINERS), TRAIN_CALLS))
    for name in ("window_gather4_bf16", "window_gather_banded_bf16"):
        rows[name]["path"] = "on no trainer path (pursuit trains in f32)"
    del venv
    torch.cuda.empty_cache()
    return rows, by_alg


def small_train_step(alg, device, **kw):
    """One step of trainer ``alg`` at the GPU-vs-CPU size, f32, eps 1.0
    for the Q trainers (the actions do not read the Q values), from the
    trusty weights (``a2c``, ``drqn``: fresh nets from fixed seeds;
    ``kw``: A2C's net keywords, DRQN's step keywords over its default
    ``share_acting``, ``unroll_remat="all"``) ->
    (the step's rollout or, for the DQN forms, a rollout from another key;
    end state; metrics; per group (params, mu, nu) as flat flax dicts;
    the returned hiddens (``drqn``) or the top-two Gumbel score gaps of
    the rollout's draws (``a2c``))."""
    from magent_tpu_torch import random as rnd
    from magent_tpu_torch import parallel as par
    from magent_tpu_torch.builtin.config import battle
    from magent_tpu_torch.builtin.torch_model import (params_to_flax,
                                                      tensors_to_flax)

    venv = par.VecGridWorld(battle.get_config(TRAIN_SMALL_MAP),
                            TRAIN_SMALL_CAPS, TRAIN_SMALL_ENVS, device=device)
    dev = venv.device
    tx = par.ClipAdam(TRAIN_LR, bench_train.CLIP)
    T = TRAIN_SMALL_T
    state = venv.reset(rnd.PRNGKey(0, dev))
    key = rnd.PRNGKey(2, dev)
    rkey = rnd.split(key)[1]  # the step's rollout key
    extra = None
    if alg in ("dqn", "dqn_remat"):
        step = (par.make_dqn_train_step(venv, tx, rollout_len=T,
                                        train_minibatch=32)
                if alg == "dqn" else par.make_dqn_train_step_remat(
                    venv, tx, rollout_len=T,
                    sample_steps=TRAIN_SAMPLE_STEPS))
        nets = trusty_nets(venv.spec, dev)
        _, traj = step.rollout(nets, state, rnd.PRNGKey(1, dev), 1.0)
        nets, opts, state, m = step(nets, trusty_nets(venv.spec, dev),
                                    tuple(tx.init(n) for n in nets), state,
                                    key, 1.0)
    elif alg == "a2c":
        step = par.make_a2c_train_step(venv, tx, rollout_len=T)
        nets = fresh_nets(alg, venv.spec, dev, torch.float32, **kw)
        _, traj = step.rollout(nets, state, rkey)
        extra = a2c_margins(venv, nets, traj, rkey)
        nets, opts, state, m = step(nets, tuple(tx.init(n) for n in nets),
                                    state, key)
    else:
        step = par.make_drqn_train_step(venv, tx, rollout_len=T, **dict(
            dict(share_acting=True, unroll_remat="all"), **kw))
        nets = fresh_nets(alg, venv.spec, dev, torch.float32)
        hiddens = par.init_drqn_hiddens(venv, nets)
        with torch.no_grad():
            _, _, traj = step.rollout(nets, state, hiddens, rkey, 1.0)
        nets, opts, state, extra, m = step(
            nets, fresh_nets(alg, venv.spec, dev, torch.float32),
            tuple(tx.init(n) for n in nets), state, hiddens, key, 1.0)
    flat = []
    for net, st in zip(nets, opts):
        names = [n for n, _ in net.named_parameters()]
        flat.append((params_to_flax(net),
                     tensors_to_flax(dict(zip(names, st.mu))),
                     tensors_to_flax(dict(zip(names, st.nu)))))
    return traj, state, m, flat, extra


def a2c_margins(venv, nets, traj, rkey):
    """The gap between the top two ``log(policy) + gumbel`` scores of every
    draw of an A2C rollout made with ``nets`` from ``rkey``
    (parallel/train.py's key walk), checking that each draw took the top
    score."""
    from magent_tpu_torch import random as rnd

    key, gaps = rkey, []
    with torch.no_grad():
        for t in range(traj["actions"].shape[0]):
            key, akey = rnd.split(key).unbind(-2)
            for g, gs in enumerate(venv.spec.groups):
                sl = slice(gs.offset, gs.offset + gs.cap)
                policy, _ = nets[g](traj["views"][g][t], traj["feats"][g][t],
                                    traj["alive_in"][t][:, sl].float())
                scores = (rnd.gumbel(rnd.fold_in(akey, g), policy.shape)
                          + policy.log())
                if not torch.equal(scores.argmax(-1).int(),
                                   traj["actions"][t][:, sl]):
                    raise AssertionError("a2c: a draw did not take its top "
                                         "score")
                top2 = scores.topk(2, -1).values
                gaps.append((top2[..., 0] - top2[..., 1]).flatten())
    return torch.cat(gaps).cpu()


def train_step_errors(got, want):
    """(loss and mean value relative error, Adam moments' largest error as
    a share of each tensor's largest magnitude, parameters' largest error
    where the gradient's sign is settled, parameters' largest error)
    between two :func:`small_train_step` results."""
    gm, gf = got[2], got[3]
    cm, cf = want[2], want[3]
    rel = max(float(((gm[k].cpu() - cm[k]).abs() / cm[k].abs()).max())
              for k in ("loss", "mean_value") if k in cm)
    moment_err = param_err = param_any = 0.0
    for (gp, gmu, gnu), (cp, cmu, cnu) in zip(gf, cf):
        for k in cp:
            for a, b in ((gmu[k], cmu[k]), (gnu[k], cnu[k])):
                moment_err = max(moment_err, float(
                    np.abs(a - b).max() / np.abs(b).max()))
            diff = np.abs(gp[k] - cp[k])
            settled = np.abs(cmu[k]) > TRAIN_MOMENT_RTOL * np.abs(
                cmu[k]).max()
            param_err = max(param_err, float(diff[settled].max(initial=0.0)))
            param_any = max(param_any, float(diff.max()))
    return rel, moment_err, param_err, param_any


def assert_steps_equal(a, b, tag):
    """Two :func:`small_train_step` results bit for bit."""
    for name in ("actions", "rewards", "alive", "alive_in", "done"):
        if not torch.equal(a[0][name], b[0][name]):
            raise AssertionError("%s: rollout %s differs" % (tag, name))
    assert_state_equal(a[1], b[1], tag)
    same = all(torch.equal(a[2][k], b[2][k]) for k in a[2]) and all(
        np.array_equal(x[k], y[k]) for fa, fb in zip(a[3], b[3])
        for x, y in zip(fa, fb) for k in x) and all(
        torch.equal(x, y) for x, y in zip(a[4], b[4]))
    if not same:
        raise AssertionError("%s: metrics, parameters, moments or hiddens "
                             "differ" % tag)


def check_trainers_gpu_match_cpu(forms=None, repeat=False):
    """Phase 9, last: one step of each fused trainer on the GPU (TF32 off)
    and on the CPU at a small size (:func:`small_train_step`): the rollouts
    and end states equal (A2C: every draw's top two scores on the CPU more
    than TRAIN_MARGIN apart, so equal draws are not luck), losses (and
    A2C's mean values) within TRAIN_LOSS_RTOL, Adam moments and
    parameters as the constants above say, DRQN's returned hiddens within
    TRAIN_HIDDEN_ATOL.  ``forms``: ``{label: (alg, keywords)}`` (default:
    each of TRAINERS as bench_train builds it); ``repeat``: each also a
    second time on the GPU, equal to the first bit for bit."""
    forms = forms or {alg: (alg, {}) for alg in TRAINERS}
    for label, (alg, kw) in forms.items():
        want = small_train_step(alg, "cpu", **kw)
        got = small_train_step(alg, "cuda", **kw)
        if repeat:
            assert_steps_equal(got, small_train_step(alg, "cuda", **kw),
                               "trainer %s, two runs on the card" % label)
        (gt, gs), (ct, cs) = got[:2], want[:2]
        for name in ("actions", "rewards", "alive", "alive_in", "done"):
            if not torch.equal(gt[name].cpu(), ct[name]):
                raise AssertionError("trainer %s: rollout %s differs between "
                                     "GPU and CPU" % (label, name))
        assert_state_equal(gs, cs, "trainer %s" % label)
        rel, moment_err, param_err, param_any = train_step_errors(got, want)
        if not (rel <= TRAIN_LOSS_RTOL and moment_err <= TRAIN_MOMENT_RTOL
                and param_err <= TRAIN_PARAM_ATOL
                and param_any <= 2 * TRAIN_LR + TRAIN_PARAM_ATOL):
            raise AssertionError(
                "trainer %s: GPU vs CPU loss rel error %g (tol %g), moments "
                "%g (tol %g), settled params %g (tol %g), params %g (tol %g)"
                % (label, rel, TRAIN_LOSS_RTOL, moment_err, TRAIN_MOMENT_RTOL,
                   param_err, TRAIN_PARAM_ATOL, param_any,
                   2 * TRAIN_LR + TRAIN_PARAM_ATOL))
        note = ""
        if alg == "a2c":
            gap = float(want[4].min())
            if not gap > TRAIN_MARGIN:
                raise AssertionError("trainer a2c: a draw's top two scores "
                                     "lie %g apart (margin %g)"
                                     % (gap, TRAIN_MARGIN))
            note = ", %d draws, the least top-two gap %.3g" % (
                want[4].numel(), gap)
        if alg == "drqn":
            h_err = max(float((a.cpu() - b).abs().max())
                        for a, b in zip(got[4], want[4]))
            if not h_err <= TRAIN_HIDDEN_ATOL:
                raise AssertionError("trainer %s: hiddens %g apart (tol %g)"
                                     % (label, h_err, TRAIN_HIDDEN_ATOL))
            note = ", hiddens within %.3g" % h_err
        if repeat:
            note += ", two runs on the card bit for bit"
        print("GPU vs CPU: trainer %s, battle map %d, %s, B=%d, rollout %d, "
              "f32%s: rollouts and end states equal%s, losses within "
              "%.3g relative, Adam moments within %.3g of each tensor's "
              "largest, parameters with a settled gradient sign within %.3g "
              "(all within %.3g)" % (
                  label, TRAIN_SMALL_MAP, TRAIN_SMALL_CAPS, TRAIN_SMALL_ENVS,
                  TRAIN_SMALL_T, "" if alg == "a2c" else ", eps 1.0", note,
                  rel, moment_err, param_err, param_any), flush=True)


def banded_battle_env(device):
    """Battle at the GPU-vs-CPU size (map SMALL_MAP, 2 x SMALL_N, B =
    SMALL_ENVS) with bf16 views, forced onto the banded route (an image
    budget of 1 byte), minimap on: the banded kernel's minimap epilogue and
    double rounding."""
    from magent_tpu_torch.builtin.config import battle
    from magent_tpu_torch.core import observe
    from magent_tpu_torch.parallel import VecGridWorld

    budget = observe.VMEM_IMAGE_BUDGET
    observe.VMEM_IMAGE_BUDGET = 1
    try:
        venv = VecGridWorld(battle.get_config(SMALL_MAP), [SMALL_N, SMALL_N],
                            SMALL_ENVS, obs_dtype=torch.bfloat16,
                            device=device)
    finally:
        observe.VMEM_IMAGE_BUDGET = budget
    if not venv.spec.minimap_mode or [o.route for o in venv._observe] != [
            "window_gather_banded"] * 2:
        raise AssertionError("battle map %d did not take the banded route "
                             "with its minimap" % SMALL_MAP)
    return venv


def seg_world_env(device):
    """The smallest pursuit map whose one world takes the segmented sweeps
    (and the banded gather), for the GPU-vs-CPU run."""
    venv = pursuit_env(P_SEG_SMALL_MAP, 1, P_SEG_SEED, device=device)
    if not venv._step.route.seg or [o.route for o in venv._observe] != [
            "window_gather_banded"] * 2:
        raise AssertionError("map %d does not take the segmented route"
                             % P_SEG_SMALL_MAP)
    return venv


def tests_helper(name):
    """A JAX-free helper module of ``tests/`` (the port and NumPy only):
    ``_torch_model_play`` (the per-agent models' play loop and its
    near-tie rule), ``_torch_render_replay`` (record a world's calls,
    replay them on another device, compare the dumps)."""
    import importlib

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    return importlib.import_module(name)


def model_class(kind):
    from magent_tpu_torch.builtin import torch_model

    return getattr(torch_model, MODEL_CLASSES[kind])


def load_trusty(models, names=("l", "r")):
    from magent_tpu_torch import utility

    for m, tag in zip(models, names):
        m.load(utility.bundled_model_dir(), 0, name="trusty-battle-game-" + tag)


def model_step(env, handles, models, clock):
    """One step of examples/rollout.py's loop over ``ProcessingModel``s:
    ``get_observation -> infer_action(eps) -> set_action -> step ->
    get_reward -> sample_step -> clear_dead``; the host seconds of the
    env's calls, the inference and the sampling are added into ``clock``
    (each ends in a copy to the host, so each is synchronized).  -> (live
    agents, observations, rewards)."""
    t0 = time.perf_counter()
    obs = [env.get_observation(h) for h in handles]
    ids = [env.get_agent_id(h) for h in handles]
    t1 = time.perf_counter()
    acts = [m.infer_action(o, i, "e_greedy", MODEL_EPS)
            for m, o, i in zip(models, obs, ids)]
    t2 = time.perf_counter()
    for h, a in zip(handles, acts):
        env.set_action(h, a)
    done = env.step()
    rewards = [env.get_reward(h) for h in handles]
    alives = [env.get_alive(h) for h in handles]
    t3 = time.perf_counter()
    for m, r, a in zip(models, rewards, alives):
        m.sample_step(r, a)
    t4 = time.perf_counter()
    env.clear_dead()
    clock["env"] += (t1 - t0) + (t3 - t2) + (time.perf_counter() - t4)
    clock["inference"] += t2 - t1
    clock["sampling"] += t4 - t3
    if done:
        raise AssertionError("model layer: the episode ended")
    return sum(len(i) for i in ids), obs, rewards


def views_round_trip_ms(view):
    """ms of one group's views (as ``get_observation`` returns them)
    copied card -> host and host -> card, CUDA-synchronized, median of
    20: the NumPy round trip between the env and the model."""
    dev = torch.from_numpy(view).cuda()
    d2h, h2d = [], []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev.cpu().numpy()
        t1 = time.perf_counter()
        torch.from_numpy(view).to("cuda")
        torch.cuda.synchronize()
        d2h.append(t1 - t0)
        h2d.append(time.perf_counter() - t1)
    return statistics.median(d2h) * 1e3, statistics.median(h2d) * 1e3


def run_model_loop(kind, env, models, device_name, label=None):
    """Phase 11, one model kind on train_battle's loop: warm-up, timed
    steps with the launch counts asserted, host syncs, the profiler, then
    one timed ``train()`` per model, and one more step and a short
    ``train()`` of group 1 under the profiler and the sync count -> the
    timed steps' launch counts.  ``label`` starts each line (default
    "model layer <kind>")."""
    from magent_tpu_torch import ops

    label = label or "model layer %s" % kind
    handles = env.get_handles()
    for _ in range(MODEL_WARMUP):
        model_step(env, handles, models, collections.Counter())
    torch.cuda.synchronize()
    n = MODEL_STEPS[kind]
    clock = collections.Counter()
    ops.reset_launch_counts()
    live = 0
    t0 = time.perf_counter()
    for _ in range(n):
        k, obs, rewards = model_step(env, handles, models, clock)
        live += k
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    expected = {name: MODEL_PER_STEP.get(name, 0) * n for name in PATH_KERNELS}
    if counts != expected:
        raise AssertionError("%s: launch counts %s, expected %s"
                             % (label, counts, expected))
    ms = dt / n * 1e3
    print("%s: train_battle's loop, battle map %d, %d live "
          "agent-steps in %d timed steps: %.4f ms per env step (env %.4f, "
          "inference %.4f, sampling %.4f), %.1f agent-steps/s on %s; "
          "launches per env step %s" % (
              label, GW_MAP, live, n, ms, clock["env"] / n * 1e3,
              clock["inference"] / n * 1e3, clock["sampling"] / n * 1e3,
              live / dt, device_name, json.dumps(
                  {k: v / n for k, v in counts.items() if v})), flush=True)
    if not all(np.isfinite(v).all() and np.isfinite(f).all()
               for v, f in obs) or not all(np.isfinite(r).all()
                                           for r in rewards):
        raise AssertionError("%s: outputs not finite" % label)
    syncs, sites = count_host_syncs(
        lambda: model_step(env, handles, models, collections.Counter()),
        MODEL_SYNC_STEPS)
    print("%s: %.1f host syncs per env step (torch.cuda sync "
          "debug mode, %d steps); by call site: %s" % (
              label, syncs, MODEL_SYNC_STEPS, json.dumps(
                  {k: v / MODEL_SYNC_STEPS for k, v in sites.most_common()})),
          flush=True)
    profile_steps("%s, per env step" % label,
                  lambda: model_step(env, handles, models,
                                     collections.Counter()),
                  MODEL_PROFILE_STEPS, ms)

    out, train_ms, batches = [], [], []
    for m in models:
        before = m.model.train_ct
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out.append(m.train(print_every=1000))
        torch.cuda.synchronize()
        train_ms.append((time.perf_counter() - t0) * 1e3)
        batches.append(m.model.train_ct - before)
    print("%s: train() of each group: %s batches in %s ms, %s "
          "ms per batch; returned %s" % (
              label, batches, ["%.3f" % t for t in train_ms],
              ["%.4f" % (t / b) for t, b in zip(train_ms, batches)], out),
          flush=True)
    # one more env step recorded, and a short train() call of group 1
    # under the profiler and the sync count
    model_step(env, handles, models, collections.Counter())
    m1 = models[1]
    before = m1.model.train_ct
    prof = []
    syncs, sites = count_host_syncs(lambda: prof.append(profile_steps(
        "%s, group 1 train() of one step" % label,
        lambda: out.append(m1.train(print_every=1000)), 1,
        train_ms[1] / batches[1])), 1)
    short = m1.model.train_ct - before
    print("%s: group 1 train() of one step: %d batches, %.2f "
          "host syncs per batch (%d in the call; by call site: %s)%s" % (
              label, short, syncs / short, syncs,
              json.dumps(dict(sites.most_common())),
              "" if prof[0] is None else
              ", %.1f device ops and %.4f ms of device time per batch" % (
                  prof[0][0] / short, prof[0][1] / short)), flush=True)
    if not (min(batches) > 0 and short > 0 and all(
            np.isfinite(np.hstack(r).astype(np.float64)).all()
            for r in out)):
        raise AssertionError("%s: train() gave %s" % (label, out))
    print("%s: peak device memory %.3f GB" % (
        label, torch.cuda.max_memory_allocated() / 1e9), flush=True)
    return counts


def check_trusty_round_trip(env):
    """Each trusty checkpoint loaded, saved and loaded again: the saved
    file and the reloaded weights equal the bundled file bit for bit."""
    import tempfile

    from magent_tpu_torch import utility

    cls = model_class("dqn")
    for g, tag in enumerate("lr"):
        h = env.get_handles()[g]
        name = "trusty-battle-game-" + tag
        with np.load(os.path.join(utility.bundled_model_dir(), name,
                                  "tfdqn_0.npz")) as f:
            trusty = dict(f)
        m = cls(env, h, "round-trip", memory_size=64)
        load_trusty([m], [tag])
        with tempfile.TemporaryDirectory() as d:
            m.save(d, 3)
            with np.load(os.path.join(d, "round-trip", "tfdqn_3.npz")) as f:
                saved = dict(f)
            again = cls(env, h, "again", memory_size=64, seed=7)
            again.load(d, 3, name="round-trip")
        for flat in (saved, again.get_params()):
            if sorted(flat) != sorted(trusty) or not all(
                    flat[k].dtype == trusty[k].dtype
                    and np.array_equal(flat[k], trusty[k]) for k in trusty):
                raise AssertionError("model layer: %s does not round-trip "
                                     "bit for bit" % name)
    print("model layer: both trusty checkpoints saved and loaded again on "
          "the card, bit for bit", flush=True)


def check_subprocess_model(env):
    """One ``SubprocessModel`` round trip with its worker on the card (the
    default device): the trusty weights loaded, act, sample, train, save,
    load; its actions equal a ``ProcessingModel``'s of the same seed and
    weights; ``quit()`` ends the worker."""
    import tempfile

    from magent_tpu_torch import ProcessingModel, SubprocessModel

    cls = model_class("dqn")
    handles = env.get_handles()
    h = handles[0]
    rng = np.random.RandomState(3)
    # the worker computes with PyTorch's defaults (cuDNN's convolutions in
    # TF32); the in-process model it is held to does too, meanwhile
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    t0 = time.perf_counter()
    sub = SubprocessModel(env, h, "battle-l", 20000, 1000, cls,
                          seed=MODEL_SEED, **MODEL_HYPER["dqn"])
    try:
        local = ProcessingModel(env, h, "battle-l", 20000, 1000, cls,
                                seed=MODEL_SEED, **MODEL_HYPER["dqn"])
        load_trusty([sub, local], ["l", "l"])
        other = handles[1]
        for _ in range(2):  # two steps: a one-step episode is all masked
            obs, ids = env.get_observation(h), env.get_agent_id(h)
            sub.infer_action(obs, ids, "e_greedy", MODEL_EPS, block=False)
            acts = sub.fetch_action()
            want = local.infer_action(obs, ids, "e_greedy", MODEL_EPS)
            if acts.dtype != np.int32 or not np.array_equal(acts, want):
                raise AssertionError("SubprocessModel: actions differ from "
                                     "the in-process model's")
            env.set_action(h, acts)
            env.set_action(other, rng.randint(
                0, env.get_action_space(other)[0],
                env.get_num(other)).astype(np.int32))
            env.step()
            sub.sample_step(env.get_reward(h), env.get_alive(h),
                            block=False)
            sub.check_done()
            env.clear_dead()
        loss, value = sub.train(print_every=1000)
        if not (np.isfinite(loss) and np.isfinite(value) and loss > 0):
            raise AssertionError("SubprocessModel: train gave %s"
                                 % ((loss, value),))
        with tempfile.TemporaryDirectory() as d:
            sub.save(d, 1)
            local.load(d, 1, name="battle-l")
            sub.load(d, 1)
        obs, ids = env.get_observation(h), env.get_agent_id(h)
        if not np.array_equal(sub.infer_action(obs, ids, "greedy"),
                              local.infer_action(obs, ids, "greedy")):
            raise AssertionError("SubprocessModel: greedy actions differ "
                                 "after the weights crossed")
    finally:
        sub.quit()
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    if sub.proc.is_alive() or sub.proc.exitcode != 0:
        raise AssertionError("SubprocessModel: the worker did not exit "
                             "cleanly (exit code %s)" % sub.proc.exitcode)
    print("model layer: SubprocessModel on the card (spawned worker, trusty "
          "weights): 2 steps of act = ProcessingModel's on %d agents and "
          "sample, train (loss %.6f), save, load, greedy acts equal again, "
          "quit (exit 0); "
          "%.2f s with the spawn" % (len(acts), loss,
                                       time.perf_counter() - t0), flush=True)


def port_adam(m):
    """(Adam steps, parameters, first and second moments) of a model of the
    JAX family's port, each a flat {name: array}."""
    from magent_tpu_torch.builtin.torch_model import (params_to_flax,
                                                      tensors_to_flax)

    names = [n for n, _ in m.net.named_parameters()]
    return (int(m.opt_state.count), params_to_flax(m.net), *[
        tensors_to_flax(dict(zip(names, getattr(m.opt_state, k))))
        for k in ("mu", "nu")])


def th_adam(m):
    """:func:`port_adam` of a second-backend model (``torch.optim.Adam``)."""
    state = m.opt.state_dict()["state"]
    named = list(m.net.named_parameters())
    return (int(state[0]["step"]) if state else 0,
            {n: p.detach().cpu().numpy() for n, p in named}, *[
                {n: state[i][k].cpu().numpy()
                 for i, (n, _) in enumerate(named)}
                for k in ("exp_avg", "exp_avg_sq")])


def th_scores(kind, model, view, feat):
    """What a second-backend model's ``infer_action`` decides by, from its
    state before the call, as ``_torch_model_play.port_scores`` gives it:
    DQN, the Q values and the rows whose host e-greedy draw explores; A2C,
    scores that put the drawn action on top by the host uniform's distance
    from the nearest boundary of the policy's running sum (so the near-tie
    rule compares the draw wherever that distance exceeds MARGIN)."""
    import copy

    probe = copy.deepcopy(model._rng)
    with torch.no_grad():
        out = model.net(model._tensor(view), model._tensor(feat))
    n = len(view)
    if kind == "dqn":
        return out.double().cpu().numpy(), probe.rand(n) < MODEL_EPS
    cdf = np.cumsum(out[0].cpu().numpy(), axis=1)
    u = probe.rand(n, 1) * cdf[:, -1:]
    drawn = (cdf < u).sum(axis=1).clip(0, cdf.shape[1] - 1)
    scores = np.zeros(cdf.shape)
    scores[np.arange(n), drawn] = np.abs(cdf - u).min(axis=1)
    return scores, np.zeros(n, bool)


def model_family(family, kind):
    """What phase 11's loop and GPU = CPU check need of model ``kind`` of
    ``family``: "port" (``builtin/torch_model``, the JAX family's port) or
    "th" (``builtin/th_model``, the second backend; build_alg's
    hyperparameters with backend="torch")."""
    if family == "port":
        play = tests_helper("_torch_model_play")
        return types.SimpleNamespace(
            label="model %s" % kind, cls=model_class(kind),
            hyper=MODEL_HYPER[kind], trusty=kind == "dqn",
            cmp_steps=MODEL_CMP_STEPS[kind], adam=port_adam,
            scores=lambda m, v, f, ids: play.port_scores(kind, m, v, f, ids,
                                                         MODEL_EPS))
    from magent_tpu_torch.examples.rollout import build_alg

    cls, hyper = build_alg(kind, backend="torch")
    return types.SimpleNamespace(
        label="second backend th_model %s" % kind, cls=cls, hyper=hyper,
        trusty=False, cmp_steps=TH_CMP_STEPS, adam=th_adam,
        scores=lambda m, v, f, ids: th_scores(kind, m, v, f))


def model_param_errors(got, want):
    """(Adam moments' largest error as a share of each tensor's largest
    magnitude, parameters' largest error where the gradient's sign is
    settled, parameters' largest error) of two models' :func:`port_adam`
    tuples."""
    _, gp, *gmom = got
    _, cp, *cmom = want
    moment_err = param_err = param_any = 0.0
    for k in cp:
        for a, b in zip(gmom, cmom):
            err, scale = np.abs(a[k] - b[k]).max(), np.abs(b[k]).max()
            # a moment that is 0 on the CPU must be 0 on the card
            moment_err = max(moment_err, float(
                err / scale if scale else np.inf if err else 0.0))
        diff = np.abs(gp[k] - cp[k])
        mu = cmom[0][k]
        settled = np.abs(mu) > TRAIN_MOMENT_RTOL * np.abs(mu).max()
        param_err = max(param_err, float(diff[settled].max(initial=0.0)))
        param_any = max(param_any, float(diff.max()))
    return moment_err, param_err, param_any


def check_models_gpu_match_cpu(family="port", kinds=("dqn", "a2c", "drqn")):
    """Phase 11, last: each model kind on the card and on the CPU over one
    round of MODEL_CMP_STEPS (the second backend: TH_CMP_STEPS) steps of
    train_battle's map and armies and one
    ``train()`` per model (``tests/_torch_model_play.py``'s loop, the same
    seeds, NumPy reseeded before each run): actions equal wherever the CPU
    run's top two scores lie more than its MARGIN apart (on a tie the card
    must pick a tied action, and the CPU's is played), rewards exact,
    ``train()``'s returns within TRAIN_LOSS_RTOL, Adam moments within
    TRAIN_MOMENT_RTOL of each tensor's largest and parameters within 0.2
    lr per Adam step where the gradient's sign is settled (2 lr more
    elsewhere), DRQN's hidden states within TRAIN_HIDDEN_ATOL.  The
    episode buffers hold MODEL_CMP_EPISODES agents per group, as
    ``tests/test_models.py``'s loop does (9 DQN batches per model): a
    train batch's double-Q argmax or a ReLU can meet a tie within the
    devices' rounding, after which the two runs' losses part; over 61
    batches (every agent recorded) one group's did, at its fifth batch,
    in one run on an H100.  ``family``: :func:`model_family`'s."""
    import magent_tpu_torch as tmag

    play = tests_helper("_torch_model_play")
    for kind in kinds:
        fam = model_family(family, kind)
        runs, models = {}, {}
        for dev in ("cpu", "cuda"):
            env = tmag.GridWorld("battle", map_size=GW_MAP, device=dev)
            models[dev] = [
                fam.cls(env, h, "battle-%s" % tag, seed=MODEL_SEED + g,
                        device=dev, **fam.hyper)
                for g, (h, tag) in enumerate(zip(env.get_handles(), "lr"))]
            if fam.trusty:
                load_trusty(models[dev])
            np.random.seed(MODEL_SEED)
            runs[dev] = play.play(
                tmag, env, models[dev], MODEL_EPS, rounds=1,
                steps=fam.cmp_steps, place=place_armies,
                capacity=MODEL_CMP_EPISODES, **(
                    dict(scores=fam.scores) if dev == "cpu"
                    else dict(ref=runs["cpu"])))
        want, got = runs["cpu"], runs["cuda"]
        gaps = np.concatenate([np.where(ex, np.inf, play.top_two_gap(sc))
                               for sc, ex in want["scores"]])
        compared = gaps > play.MARGIN
        if compared.sum() != len(gaps) - got["ties"]:
            raise AssertionError("%s: tie count" % fam.label)
        for a, b in zip(got["acts"] + got["rewards"],
                        want["acts"] + want["rewards"]):
            if not np.array_equal(a, b):
                raise AssertionError("%s: GPU and CPU actions or rewards "
                                     "differ" % fam.label)
        rel = max(float(np.max(np.abs(
            np.hstack(a).astype(np.float64) - np.hstack(b)) / np.maximum(
            np.abs(np.hstack(b)), 1e-30))) for a, b in zip(got["train"],
                                                       want["train"]))
        lr = fam.hyper["learning_rate"]
        errs = []
        for gm, cm in zip(models["cuda"], models["cpu"]):
            got_adam, want_adam = fam.adam(gm), fam.adam(cm)
            steps = want_adam[0]
            if got_adam[0] != steps or steps < 1:
                raise AssertionError("%s: %d and %d Adam steps" % (
                    fam.label, got_adam[0], steps))
            moment_err, param_err, param_any = model_param_errors(
                got_adam, want_adam)
            errs.append((steps, moment_err, param_err, param_any))
            if not (moment_err <= TRAIN_MOMENT_RTOL
                    and param_err <= 0.2 * lr * steps
                    and param_any <= 2.2 * lr * steps):
                raise AssertionError(
                    "%s: GPU vs CPU after %d Adam steps: moments %g (tol "
                    "%g), settled params %g (tol %g), params %g (tol %g)"
                    % (fam.label, steps, moment_err, TRAIN_MOMENT_RTOL,
                       param_err, 0.2 * lr * steps, param_any,
                       2.2 * lr * steps))
        if not rel <= TRAIN_LOSS_RTOL:
            raise AssertionError("%s: train() returns %g apart relative "
                                 "(tol %g)" % (fam.label, rel,
                                               TRAIN_LOSS_RTOL))
        note = ""
        if kind == "drqn":
            h_err = 0.0
            for gm, cm in zip(models["cuda"], models["cpu"]):
                if sorted(gm.agent_states) != sorted(cm.agent_states):
                    raise AssertionError("model drqn: hidden state ids "
                                         "differ")
                h_err = max([h_err] + [
                    float(np.abs(gm.agent_states[k] - s).max())
                    for k, s in cm.agent_states.items()])
            if not h_err <= TRAIN_HIDDEN_ATOL:
                raise AssertionError("model drqn: hiddens %g apart (tol %g)"
                                     % (h_err, TRAIN_HIDDEN_ATOL))
            note = ", hidden states within %.3g" % h_err
        print("GPU vs CPU: %s, battle map %d, %d agents, %d steps and "
              "one train() per model, f32: %d actions compared (%d greedy rows "
              "or draws, least top-two gap %.3g; %d ties played from the "
              "CPU run), rewards equal, train() returns within %.3g "
              "relative, (Adam steps, moments, settled params, params) per "
              "group %s%s" % (
                  fam.label, GW_MAP,
                  len(want["acts"][0]) + len(want["acts"][1]),
                  fam.cmp_steps, int(compared.sum()),
                  int(np.isfinite(gaps[compared]).sum()),
                  float(gaps.min()), got["ties"], rel,
                  json.dumps([[s, float("%.3g" % a), float("%.3g" % b),
                               float("%.3g" % c)] for s, a, b, c in errs]),
                  note), flush=True)
        del runs, models
    torch.cuda.empty_cache()


def run_model_layer(device_name):
    """Phase 11: the model layer at train_battle's full width -> the DQN
    loop's launch counts."""
    from magent_tpu_torch import GridWorld, ProcessingModel

    torch.cuda.reset_peak_memory_stats()
    env = GridWorld("battle", map_size=GW_MAP)
    handles = env.get_handles()
    counts = None
    for kind in ("dqn", "a2c", "drqn"):
        env.reset()
        place_armies(env, handles)
        models = [ProcessingModel(env, h, "battle-%s" % tag, 20000 + g, 1000,
                                  model_class(kind), seed=MODEL_SEED + g,
                                  **MODEL_HYPER[kind])
                  for g, (h, tag) in enumerate(zip(handles, "lr"))]
        if kind == "dqn":
            load_trusty(models)
            view, _ = env.get_observation(handles[0])
            d2h, h2d = views_round_trip_ms(view)
            print("model layer: one group's views (%d x %s f32, %.3f MB) "
                  "take %.4f ms card -> host and %.4f ms host -> card "
                  "(synchronized, median of 20)" % (
                      len(view), view.shape[1:], view.nbytes / 1e6, d2h,
                      h2d), flush=True)
        got = run_model_loop(kind, env, models, device_name)
        counts = counts or got
        del models
    env.reset()
    place_armies(env, handles)
    check_trusty_round_trip(env)
    check_subprocess_model(env)
    del env
    torch.cuda.empty_cache()
    check_models_gpu_match_cpu()
    return counts


# phase 12, rendering: the replay path (phase 4's world and loop, rendered
# after each step, then a second episode), the live battle at
# ``BattleServer``'s defaults (map 125, eps 0.05, the bundled trusty
# checkpoints), ``ArrangeServer`` at its defaults (map 100, RandomActor),
# each card run against the CPU
RENDER_WARMUP, RENDER_TIMED, RENDER_SYNC_FRAMES, RENDER_EPISODE2 = 3, 20, 5, 5
RENDER_PER_STEP = {"window_gather": 2, "rank_prefix_hp": 1, "move_claims": 1}
SERVER_WARMUP, SERVER_FRAMES, SERVER_SYNC_FRAMES = 2, 20, 2
SERVER_CMP_FRAMES, ARRANGE_FRAMES, SNAKE_RENDER_STEPS = 10, 10, 20
RENDER_FILES = ["config.json", "video_1.txt", "video_2.txt"]


def rendered_step(env, handles, rng, after_step=None):
    """Phase 4's step with ``after_step()`` (a render) between ``step`` and
    ``get_reward``; re-places the armies when the episode ends."""
    for h in handles:
        view, _ = env.get_observation(h)
        env.set_action(h, rng.randint(0, env.get_action_space(h)[0],
                                      len(view)).astype(np.int32))
    done = env.step()
    if after_step is not None:
        after_step()
    for h in handles:
        env.get_reward(h)
    env.clear_dead()
    if done:
        env.reset()
        place_armies(env, handles)


def run_replay_path(tmp, device_name):
    """Phase 12 (a), and its part of (c): the rendered GridWorld at battle
    map 125, 2x625; its calls replayed on the CPU write the same files.
    -> the timed rendered steps' launch counts."""
    from magent_tpu_torch import GridWorld, ops

    rr = tests_helper("_torch_render_replay")
    env = rr.Recorder(GridWorld("battle", map_size=GW_MAP))
    handles = env.get_handles()
    card_dir, cpu_dir = os.path.join(tmp, "cuda"), os.path.join(tmp, "cpu")
    env.set_render_dir(card_dir)
    env.reset()
    place_armies(env, handles)
    rng = np.random.RandomState(0)
    frame_s, events = [], []

    def render():
        t0 = time.perf_counter()
        env.render()  # ends in its host copy and a file write
        frame_s.append(time.perf_counter() - t0)
        events.append(len(env._attack_events))

    def timed(after_step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RENDER_TIMED):
            rendered_step(env, handles, rng, after_step)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / RENDER_TIMED * 1e3

    for _ in range(RENDER_WARMUP):
        rendered_step(env, handles, rng, render)
    gc.collect()  # no collection of earlier phases' garbage in the timing
    bare_ms = timed(None)
    video = os.path.join(card_dir, "video_1.txt")
    size0 = os.path.getsize(video)
    frame_s.clear()
    events.clear()
    ops.reset_launch_counts()
    with_ms = timed(render)
    counts = launch_counts()
    grew = os.path.getsize(video) - size0
    expected = {name: RENDER_PER_STEP.get(name, 0) * RENDER_TIMED
                for name in PATH_KERNELS}
    if counts != expected:
        raise AssertionError("rendered GridWorld launch counts %s, expected "
                             "%s" % (counts, expected))
    syncs, sites = [], collections.Counter()

    def counted_render():
        n, where = count_host_syncs(env.render, 1)
        syncs.append(n)
        sites.update(where)

    for _ in range(RENDER_SYNC_FRAMES):
        rendered_step(env, handles, rng, counted_render)
    step_syncs, _ = count_host_syncs(
        lambda: rendered_step(env, handles, rng, env.render), 2)
    print("phase 12 (a) rendered GridWorld: battle map %d, %s agents, %d "
          "timed steps: %.4f ms/step without render(), %.4f ms/step with "
          "it; %.4f ms per rendered frame (render() alone, host clock: it "
          "ends in its one host copy and the file write); %.1f host syncs "
          "per frame (render() alone, sync debug mode, %d frames; by call "
          "site: %s), %.1f per rendered step; %.1f bytes written per frame "
          "(%d attack events in %d frames); launches per step %s; on %s" % (
              GW_MAP, [env.get_num(h) for h in handles], RENDER_TIMED,
              bare_ms, with_ms, statistics.mean(frame_s) * 1e3,
              statistics.mean(syncs), RENDER_SYNC_FRAMES, json.dumps(
                  {k: v / RENDER_SYNC_FRAMES for k, v in sites.items()}),
              step_syncs, grew / RENDER_TIMED, sum(events), len(events),
              json.dumps({k: v / RENDER_TIMED for k, v in counts.items()
                          if v}), device_name), flush=True)
    if not sum(events):
        raise AssertionError("rendered GridWorld: no attack event drawn")
    # a second episode (video_2.txt), then a render query
    env.reset()
    place_armies(env, handles)
    for _ in range(RENDER_EPISODE2):
        rendered_step(env, handles, rng, env.render)
    card_info = env._get_render_info((0, GW_MAP - 1), (0, GW_MAP - 1))
    t0 = time.perf_counter()
    cpu_info = rr.replay(env.log, GridWorld("battle", map_size=GW_MAP,
                                            device="cpu"), cpu_dir)[-1]
    diffs = rr.dump_differences(card_dir, cpu_dir)
    files = sorted(os.listdir(card_dir))
    if diffs or files != RENDER_FILES or not rr.frames_equal(cpu_info,
                                                             card_info):
        raise AssertionError("rendered GridWorld GPU vs CPU: files %s, "
                             "differing %s, render info equal %s" % (
                                 files, diffs,
                                 rr.frames_equal(cpu_info, card_info)))
    print("phase 12 (c) rendered GridWorld GPU vs CPU: %d calls replayed on "
          "the CPU in %.1f s; %s equal byte for byte (%s bytes), the last "
          "render query equal (%d agents, %d events)" % (
              len(env.log), time.perf_counter() - t0, files,
              [os.path.getsize(os.path.join(card_dir, f)) for f in files],
              len(card_info[0]), len(card_info[1])), flush=True)
    return counts


def run_battle_server(device_name):
    """Phase 12 (b), and its part of (c): ``BattleServer()`` at its
    defaults on the card; the CPU server playing the card models' actions
    gives the same frames.  -> the timed frames' launch counts."""
    from magent_tpu_torch import ops
    from magent_tpu_torch.renderer.server import BattleServer

    rr = tests_helper("_torch_render_replay")
    t0 = time.perf_counter()
    server = BattleServer()
    setup_s = time.perf_counter() - t0
    if not all(server.loaded):
        raise AssertionError("BattleServer: the trusty checkpoints did not "
                             "load: %s" % server.loaded)
    (size, groups, static) = server.get_info()
    n = server.map_size
    if size != (n, n) or groups.shape != (2, 5) or \
            static["wall"].shape[1:] != (2,):
        raise AssertionError("BattleServer.get_info: %s %s %s" % (
            size, groups.shape, static["wall"].shape))
    clock = collections.Counter()
    tape = rr.record_actions(server, clock)
    info_fn = server.env._get_render_info
    timing = [False]

    def timed_info(*args):
        if timing[0]:  # the step's device work counts as the step's
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = info_fn(*args)
        clock["render info"] += time.perf_counter() - t
        return out

    server.env._get_render_info = timed_info
    frames, frame_id = [], 0

    def frame():
        nonlocal frame_id
        frame_id += 1
        if server.get_status(frame_id) is not True:
            raise AssertionError("BattleServer: status %r at frame %d" % (
                server.get_status(frame_id), frame_id))
        out = server.get_data(frame_id, (0, n), (0, n))
        if len(frames) < SERVER_CMP_FRAMES:
            frames.append((dict(out[0]), out[1].copy()))
        return out

    for _ in range(SERVER_WARMUP):
        frame()
    gc.collect()  # no collection of earlier phases' garbage in the timing
    torch.cuda.synchronize()
    clock.clear()
    ops.reset_launch_counts()
    timing[0] = True
    t0 = time.perf_counter()
    for _ in range(SERVER_FRAMES):
        pos, events = frame()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / SERVER_FRAMES * 1e3
    timing[0] = False
    counts = launch_counts()
    expected = {name: RENDER_PER_STEP.get(name, 0) * SERVER_FRAMES
                for name in PATH_KERNELS}
    if counts != expected:
        raise AssertionError("BattleServer launch counts %s, expected %s" % (
            counts, expected))
    inference = clock["inference"] / SERVER_FRAMES * 1e3
    info = clock["render info"] / SERVER_FRAMES * 1e3
    t0 = time.perf_counter()
    banners = server.get_banners(frame_id, (800, 600))
    status = server.get_status(frame_id)
    ui_ms = (time.perf_counter() - t0) * 1e3
    alive = [server.env.get_num(h) for h in server.handles]
    syncs, sites = count_host_syncs(frame, SERVER_SYNC_FRAMES)
    if not (pos and len(pos) == sum(alive) and events.dtype == np.int32
            and events.shape[1:] == (3,) and status is True
            and "vs" in banners[0][1][0]):
        raise AssertionError("BattleServer frame: %d agents for %s alive, "
                             "events %s, status %r, banners %s" % (
                                 len(pos), alive, events.shape, status,
                                 banners))
    print("phase 12 (b) BattleServer(): map %d, eps %g, trusty checkpoints "
          "loaded, set up in %.2f s; %d timed frames: %.4f ms per frame "
          "(env step %.4f, its device work included, inference %.4f, render "
          "info %.4f); get_banners + "
          "get_status %.4f ms; %.1f host syncs per frame (sync debug mode, "
          "%d frames; by call site: %s); launches per frame %s; last frame "
          "%d agents, %d attack events, banners %s; on %s" % (
              n, server.eps, setup_s, SERVER_FRAMES, dt,
              dt - inference - info, inference, info, ui_ms, syncs,
              SERVER_SYNC_FRAMES, json.dumps(
                  {k: v / SERVER_SYNC_FRAMES for k, v in sites.items()}),
              json.dumps({k: v / SERVER_FRAMES for k, v in counts.items()
                          if v}), len(pos), len(events),
              json.dumps(banners), device_name), flush=True)
    del server
    torch.cuda.empty_cache()

    cpu = BattleServer(device="cpu")
    rr.play_actions(cpu, tape)
    for f, want in enumerate(frames, 1):
        got = cpu.get_data(f, (0, n), (0, n))
        if not rr.frames_equal(got, want):
            raise AssertionError("BattleServer GPU vs CPU: frame %d differs "
                                 "(%d vs %d agents, %d vs %d events)" % (
                                     f, len(got[0]), len(want[0]),
                                     len(got[1]), len(want[1])))
    print("phase 12 (c) BattleServer GPU vs CPU: the card models' actions "
          "played on a CPU server: %d frames' agents and attack events "
          "equal (%d events)" % (len(frames), sum(len(w[1]) for w in frames)),
          flush=True)
    return counts


def run_arrange_server(device_name):
    """Phase 12 (b): ``ArrangeServer()`` at its defaults: only absorbed
    goal markers are drawn."""
    from magent_tpu_torch import ops
    from magent_tpu_torch.renderer.server import ArrangeServer

    np.random.seed(0)  # RandomActor's draws
    server = ArrangeServer()
    env, goal, seeker = server.env, server.goal_handle, server.agent_handle
    n = server.map_size
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drawn = []
    for f in range(1, ARRANGE_FRAMES + 1):
        pos, _ = server.get_data(f, (0, n), (0, n))
        absorbed = set(env.get_agent_id(goal)[
            env._host("absorbed", goal)].tolist())
        marks = {i for i, p in pos.items() if p[2] == goal.value}
        seekers = sum(p[2] == seeker.value for p in pos.values())
        if marks != absorbed or seekers != env.get_num(seeker):
            raise AssertionError("ArrangeServer frame %d: %d markers drawn "
                                 "for %d absorbed, %d of %d seekers" % (
                                     f, len(marks), len(absorbed), seekers,
                                     env.get_num(seeker)))
        drawn.append(len(marks))
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / ARRANGE_FRAMES * 1e3
    counts = launch_counts()
    print("phase 12 (b) ArrangeServer(): map %d, %d goal markers, %d "
          "seekers (%s); %d frames: %.4f ms per frame (the check's reads "
          "included); absorbed markers drawn per frame %s and no other; "
          "banners %s; launches per frame %s; on %s" % (
              n, env.get_num(goal), env.get_num(seeker),
              type(server.model).__name__, ARRANGE_FRAMES, dt, drawn,
              json.dumps(server.get_banners(ARRANGE_FRAMES, (800, 600))),
              json.dumps({k: v / ARRANGE_FRAMES for k, v in counts.items()
                          if v}), device_name), flush=True)


def check_snake_render_gpu_matches_cpu(tmp):
    """Phase 12 (c): the fast DiscreteSnake at phase 4e's defaults rendered
    on the card, its calls replayed on the CPU: the same files."""
    rr = tests_helper("_torch_render_replay")
    env = rr.Recorder(snake_world("cuda"))
    card_dir, cpu_dir = os.path.join(tmp, "cuda"), os.path.join(tmp, "cpu")
    env.set_render_dir(card_dir)
    rng = np.random.RandomState(7)
    frame_s = []
    for _ in range(SNAKE_RENDER_STEPS):
        view, _ = env.get_observation()
        env.set_action(0, rng.randint(0, 5, len(view)).astype(np.int32))
        env.step()
        t0 = time.perf_counter()
        env.render()
        frame_s.append(time.perf_counter() - t0)
        env.get_reward()
        env.clear_dead()
    rr.replay(env.log, snake_world("cpu"), cpu_dir)
    diffs = rr.dump_differences(card_dir, cpu_dir)
    files = sorted(os.listdir(card_dir))
    if diffs or files != ["config.json", "static.map", "video_0.txt"]:
        raise AssertionError("snake render GPU vs CPU: files %s, differing "
                             "%s" % (files, diffs))
    print("phase 12 (c) DiscreteSnake render GPU vs CPU: map %d, %d steps "
          "rendered, %s equal byte for byte (%s bytes); %.4f ms per frame "
          "on the card (render() alone)" % (
              env.width, SNAKE_RENDER_STEPS, files,
              [os.path.getsize(os.path.join(card_dir, f)) for f in files],
              statistics.mean(frame_s) * 1e3), flush=True)


def run_rendering(device_name):
    """Phase 12: rendering -> the launch counts of the replay path and of
    the live battle."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="magent_render_") as tmp:
        os.makedirs(os.path.join(tmp, "snake"))
        replay_counts = run_replay_path(tmp, device_name)
        server_counts = run_battle_server(device_name)
        run_arrange_server(device_name)
        check_snake_render_gpu_matches_cpu(os.path.join(tmp, "snake"))
    return replay_counts, server_counts


# phase 13: the examples (magent_tpu_torch/examples), the second backend
# (builtin/th_model) and the scale scripts.  (a) the second backend on
# train_battle's loop at map GW_MAP with place_armies' 2x625 (build_alg's
# hyperparameters with backend="torch"); (b) each training example at its
# default map through its setup, one round cut to EX_STEPS steps at round
# 0's eps, untrained; the fused example at its defaults (map 64, B=16)
# for one call of one train step per algorithm; (c) the reference
# harness's candidates (test_examples.candidates) with --train, cut to
# EX_STEPS, on both backends; (d) one train_battle CLI run in a
# subprocess; (e) test_1m at SCALE_N agents (host loop and one-world
# vectorized loop), test_mega at its defaults (1M over 64 envs) in f32
# and bf16, and the host loop GPU = CPU at SCALE_CMP_N agents
TH_CMP_STEPS = 5
EX_STEPS = 20
EXAMPLES = ("train_battle", "train_single", "train_against", "train_multi",
            "train_trans", "train_gather", "train_pursuit", "train_tiger",
            "train_arrange")
FUSED_ALGS = ("dqn", "dqn_remat", "a2c", "drqn")
FUSED_ROLLOUT, FUSED_SAMPLE_STEPS = 8, 2
SCALE_N, SCALE_STEPS, SCALE_CMP_N, SCALE_CMP_STEPS = 1000000, 4, 10000, 5
CLI_ARGV = ["--train", "--n_round", "1", "--map_size", "32"]


def check_th_checkpoint(model, fam):
    """A checkpoint of a second-backend model on the card, loaded into a
    CPU model of another seed: every tensor equal bit for bit."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        model.save(d, 3)
        back = fam.cls(model.env, model.handle, "back", seed=99,
                       device="cpu", **fam.hyper)
        back.load(d, 3, name=model.name)
    for k, v in model.net.state_dict().items():
        if not torch.equal(back.net.state_dict()[k], v.cpu()):
            raise AssertionError("%s: the card's checkpoint does not load "
                                 "bit for bit (%s)" % (fam.label, k))
    print("%s: a %s checkpoint saved on the card after the loop's train() "
          "loaded on the CPU bit for bit" % (fam.label, model.subclass_name),
          flush=True)


def run_second_backend(device_name):
    """Phase 13 (a): each kind of the second backend through phase 11's
    loop and GPU = CPU check, and a checkpoint of each -> the DQN loop's
    launch counts."""
    from magent_tpu_torch import GridWorld, ProcessingModel

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.cuda.reset_peak_memory_stats()
    env = GridWorld("battle", map_size=GW_MAP)
    handles = env.get_handles()
    counts = {}
    for kind in ("dqn", "a2c"):
        fam = model_family("th", kind)
        env.reset()
        place_armies(env, handles)
        models = [ProcessingModel(env, h, "battle-%s" % tag, 20000 + g, 1000,
                                  fam.cls, seed=MODEL_SEED + g, **fam.hyper)
                  for g, (h, tag) in enumerate(zip(handles, "lr"))]
        counts[kind] = run_model_loop(kind, env, models, device_name,
                                      "phase 13 (a) " + fam.label)
        check_th_checkpoint(models[0].model, fam)
        del models
    del env
    torch.cuda.empty_cache()
    check_models_gpu_match_cpu("th", ("dqn", "a2c"))
    if (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) != tf32:
        raise AssertionError("the second backend changed the TF32 flags")
    return counts["dqn"]


def numbers(x):
    """The numbers of nested lists and tuples (strings skipped), as a
    float64 array."""
    if isinstance(x, str):
        return np.zeros(0)
    if isinstance(x, (list, tuple, np.ndarray)):
        return np.concatenate([np.zeros(0)] + [numbers(v) for v in x])
    return np.array([float(x)])


def example_module(name):
    import importlib

    return importlib.import_module("magent_tpu_torch.examples." + name)


def counting_steps(env):
    """Count ``env.step`` calls in ``env.steps_taken``."""
    step = env.step
    env.steps_taken = 0

    def counted():
        env.steps_taken += 1
        return step()

    env.step = counted


def expected_launches(env, observed):
    """Kernel launches per step of a ``GridWorld`` whose groups
    ``observed`` are observed once each: each group's observation route,
    and on the grid path's pair-kernel route (``route.quad``) the damage
    sweep (``rank_prefix_hp``) and, for 1x1 bodies, the move claims."""
    per = collections.Counter(env._observe_fns[g].route for g in observed)
    if env._step_fn.route.quad:
        per["rank_prefix_hp"] += 1
        if env.spec.max_body_w == 1:
            per["move_claims"] += 1
    return per


def record_launched(step_fn):
    """Run ``step_fn`` with every kernel entry point of ``ops`` recording a
    copy of each call's operands and the launch counter the call moved ->
    ``[(counter name, args, kwargs)]`` in call order; fails unless every
    launch of the run was recorded."""
    from magent_tpu_torch.ops import attack_prefix as ap
    from magent_tpu_torch.ops import window_gather as wg

    calls = []
    patched = {(mod, kernel.__name__): kernel
               for kernel, _ in kernel_fns().values() for mod in (ap, wg)
               if getattr(mod, kernel.__name__, None) is kernel}

    def wrap(fn):
        def rec(*args, **kwargs):
            copy = ([a.clone() if isinstance(a, torch.Tensor) else a
                     for a in args],
                    {k: v.clone() if isinstance(v, torch.Tensor) else v
                     for k, v in kwargs.items()})
            before = launch_counts()
            out = fn(*args, **kwargs)
            moved = {k: v - before[k] for k, v in launch_counts().items()
                     if v != before[k]}
            if list(moved.values()) != [1]:
                raise AssertionError("%s: one call moved the launch counts "
                                     "by %s" % (fn.__name__, moved))
            calls.append((next(iter(moved)),) + copy)
            return out

        return rec

    before = launch_counts()
    for (mod, name), fn in patched.items():
        setattr(mod, name, wrap(fn))
    try:
        step_fn()
    finally:
        for (mod, name), fn in patched.items():
            setattr(mod, name, fn)
    launched = {k: v - before[k] for k, v in launch_counts().items()
                if v != before[k]}
    if launched != dict(collections.Counter(c[0] for c in calls)):
        raise AssertionError("launches %s, recorded calls %s" % (
            launched, collections.Counter(c[0] for c in calls)))
    return calls


def kernel_stats_of(step_fn, per, rows, f32_rate, int32_rate, form):
    """The kernel calls of ``step_fn()`` recorded (:func:`record_launched`),
    its launches held to ``per``, and each call held against its plain
    version and timed (:func:`call_stats`) into ``rows``."""
    calls = record_launched(step_fn)
    if collections.Counter(c[0] for c in calls) != per:
        raise AssertionError("%s: one step launched %s, expected %s" % (
            form, collections.Counter(c[0] for c in calls), dict(per)))
    for k, (name, args, kwargs) in enumerate(calls):
        rows[name]["per_call"].append(call_stats(
            name, args, kwargs, f32_rate, int32_rate,
            "%s, call %d" % (form, k)))
    del calls
    torch.cuda.empty_cache()


def example_step(env, observed):
    """One step of an example's world: each observed group observed,
    random actions for every group."""
    rng = np.random.RandomState(1)
    for h in env.get_handles():
        if h.value in observed:
            env.get_observation(h)
        env.set_action(h, rng.randint(0, env.get_action_space(h)[0],
                                      env.get_num(h)).astype(np.int32))
    env.step()
    env.clear_dead()


def example_round(name, argv, train, device_name, tag, check=None):
    """One round of example ``name`` through its ``setup`` on the card,
    cut to EX_STEPS steps, at round 0's eps; the launch counts set to 0
    just before the round and read just after, held to
    :func:`expected_launches` per step; with ``check`` = (rows, f32_rate,
    int32_rate), then :func:`kernel_stats_of` one more step of its world
    (:func:`example_step`) -> (counts, steps, ms per step)."""
    from magent_tpu_torch import ops

    mod = example_module(name)
    args = mod.cli().parse_args(argv)
    t0 = time.perf_counter()
    ex = mod.setup(args)
    setup_s = time.perf_counter() - t0
    env = ex.env
    counting_steps(env)
    eps = mod.round_eps(args, 0)
    np.random.seed(0)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if name == "train_arrange":
        out = mod.play_a_round(env, args.map_size, ex.font, [args.message],
                               ex.handles, ex.model, train=train,
                               eps=eps, max_steps=EX_STEPS - 1)
        observed = [ex.handles[1].value]
        round_s = time.perf_counter() - t0
    else:
        ex.new_round()
        ex.runner.max_steps = EX_STEPS - 1
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        totals = ex.runner.sample(eps)
        torch.cuda.synchronize()
        round_s = time.perf_counter() - t0
        out = (totals.tolist(), ex.runner.nums)
        if train:
            counts_sampled = launch_counts()
            t1 = time.perf_counter()
            out = out + ex.runner.train()
            torch.cuda.synchronize()
            out = out + ("train %.3f s" % (time.perf_counter() - t1),)
        observed = [s.handle.value for s in ex.runner.sides if s.observe]
    torch.cuda.synchronize()
    counts = launch_counts() if name == "train_arrange" or not train \
        else counts_sampled
    steps = env.steps_taken
    per = expected_launches(env, observed)
    want = {k: per.get(k, 0) * steps for k in PATH_KERNELS}
    if counts != want or steps < 1:
        raise AssertionError("%s (%s): launch counts %s over %d steps, "
                             "expected %s" % (name, tag, counts, steps, want))
    if not np.isfinite(numbers(out)).all():
        raise AssertionError("%s (%s): round gave %s" % (name, tag, out))
    agents = sum(env.get_num(h) for h in env.get_handles())
    print("phase 13 %s %s: map %d, %d agents (%s), engine route %s, "
          "observation routes %s: setup %.2f s, %d steps in %.3f s, %.4f ms "
          "per step on %s; launches per step %s; round %s" % (
              tag, name, env.spec.width, agents,
              [env.get_num(h) for h in env.get_handles()],
              tuple(env._step_fn.route), [env._observe_fns[g].route
                                          for g in observed],
              setup_s, steps, round_s, round_s / steps * 1e3, device_name,
              json.dumps(dict(per)), out), flush=True)
    if check is not None:
        kernel_stats_of(lambda: example_step(env, observed), per, *check,
                        "%s %s, map %d" % (tag, name, env.spec.width))
    for m in ex.models:
        getattr(m, "quit", lambda: None)()
    del ex, env
    torch.cuda.empty_cache()
    return counts, steps, round_s / steps * 1e3


def run_fused_example(device_name, rows, f32_rate, int32_rate):
    """Phase 13 (b), train_battle_fused at its defaults (map 64, 64 per
    side, B=16, rollout 8, f32): one warm call and one timed call of one
    train step per algorithm, launches asserted per train step; after the
    first, one lockstep step of its envs through :func:`kernel_stats_of`."""
    from magent_tpu_torch import ops
    from magent_tpu_torch import random as rnd

    fused = example_module("train_battle_fused")
    extra = {"dqn": 0, "dqn_remat": 4 * FUSED_SAMPLE_STEPS, "a2c": 2,
             "drqn": 0}
    out = {}
    for alg in FUSED_ALGS:
        args = fused.cli().parse_args(["--alg", alg, "--steps_per_call", "1"])
        ex = fused.setup(args)
        ex.call(0, 1.0)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = ex.call(1, 1.0)
        loss = metrics["loss"].cpu().numpy()
        dt = time.perf_counter() - t0
        counts = launch_counts()
        want = {k: 0 for k in PATH_KERNELS}
        want.update(window_gather=2 * FUSED_ROLLOUT + extra[alg],
                    occupant=FUSED_ROLLOUT, rank_prefix=FUSED_ROLLOUT,
                    move_resolve=FUSED_ROLLOUT)
        if counts != want or not np.isfinite(loss).all():
            raise AssertionError("train_battle_fused %s: launches %s, "
                                 "expected %s; loss %s" % (alg, counts, want,
                                                           loss))
        n_agents = 2 * args.agents_per_side * args.n_envs * args.rollout_len
        print("phase 13 (b) train_battle_fused %s: map %d, B=%d, 2x%d, "
              "rollout %d: %.3f ms per train step (%.1f trained agent-steps/s) "
              "on %s; launches per train step %s; loss %s" % (
                  alg, args.map_size, args.n_envs, args.agents_per_side,
                  args.rollout_len, dt * 1e3, n_agents / dt, device_name,
                  json.dumps({k: v for k, v in counts.items() if v}),
                  loss.tolist()), flush=True)
        if alg == FUSED_ALGS[0]:
            carry = [ex.carry[3], rnd.PRNGKey(5, ex.venv.device)]
            kernel_stats_of(
                lambda: lockstep_step(ex.venv, carry), collections.Counter(
                    window_gather=2, occupant=1, rank_prefix=1,
                    move_resolve=1), rows, f32_rate, int32_rate,
                "(b) train_battle_fused, map %d, B=%d, 2x%d" % (
                    args.map_size, args.n_envs, args.agents_per_side))
        out[alg] = counts
        del ex
        torch.cuda.empty_cache()
    return out


def run_cli_round():
    """Phase 13 (d): ``python -m magent_tpu_torch.examples.train_battle
    --train --n_round 1 --map_size 32`` in a subprocess, in a scratch
    directory, with the checkout on PYTHONPATH: exits 0 and logs its round
    0 line."""
    import tempfile

    from magent_tpu_torch.examples.test_examples import module_env

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "magent_tpu_torch.examples.train_battle"]
            + CLI_ARGV, cwd=d, env=module_env(), capture_output=True,
            text=True, timeout=600)
        dt = time.perf_counter() - t0
    lines = [ln for ln in (out.stdout + out.stderr).splitlines()
             if ln.startswith("round 0\t loss:")]
    if out.returncode != 0 or not lines:
        raise AssertionError("train_battle CLI: exit %d, no round-0 line; "
                             "stderr tail %s" % (out.returncode,
                                                 out.stderr[-2000:]))
    print("phase 13 (d) python -m magent_tpu_torch.examples.train_battle %s: "
          "exit 0 in %.1f s; %s" % (" ".join(CLI_ARGV), dt, lines[0]),
          flush=True)


def scale_args(**kw):
    base = dict(n_step=SCALE_STEPS, agent_number=SCALE_N, num_gpu=0,
                n_envs=1, unroll=1, vectorized=False, fast_rand=False,
                no_walls=False, frame="jax", device=None)
    return types.SimpleNamespace(**dict(base, **kw))


def run_scale(rows, f32_rate, int32_rate, device_name):
    """Phase 13 (e): the scale scripts at one million agents; the window
    kernels at their shapes against their plain versions, into ``rows``."""
    from magent_tpu_torch import ops
    from magent_tpu_torch import random as rnd

    t1m = example_module("test_1m")
    mega = example_module("test_mega")

    # the host loop, 20 warm-ups and SCALE_STEPS timed steps
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = t1m.run_host_loop(scale_args())
    wall = time.perf_counter() - t0
    counts = launch_counts()
    env = res["env"]
    steps = len(res["steps"])
    groups = env.get_handles()
    per = expected_launches(env, [h.value for h in groups])
    want = {k: per.get(k, 0) * steps for k in PATH_KERNELS}
    if counts != want or res["fps"] is None:
        raise AssertionError("test_1m host loop: launches %s over %d steps, "
                             "expected %s" % (counts, steps, want))
    phases = {k: v / steps * 1e3 for k, v in res["phase_totals"].items()}
    obs_ms = phases["obs:deer"] + phases["obs:tiger"]
    # the observations' device work alone, synchronized (the rest of
    # get_observation is the copy to pageable host memory)
    grids = env._grids_fn(env.state)
    dev_obs = []
    for h in groups:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        view, _ = env._observe_fns[h.value](env.state, grids)
        torch.cuda.synchronize()
        dev_obs.append((time.perf_counter() - t0) * 1e3)
        nbytes_view = view[0, :env.get_num(h)].numel() * 4
        del view
    step_ms = sum(phases.values())
    check_cells_rebuilt("phase 13 (e) test_1m host loop", env, env.state)
    print("phase 13 (e) test_1m host loop: %d agents on map %d (%d walls), "
          "engine route %s (grid path, %s), observation routes %s; placement "
          "%.2f s on the host; FPS %.1f over %d timed steps after %d "
          "warm-ups; %.4f ms per step by phase %s; get_observation %.4f ms "
          "per step of which the observations' device work %.4f ms "
          "(synchronized, per group %s), the rest the copies to pageable "
          "host memory: %.3f of the step; launches per step %s; peak device "
          "memory %.3f GB; %.1f s in all on %s" % (
              SCALE_N, env.spec.width, SCALE_N // 10,
              tuple(env._step_fn.route),
              "pair kernels" if env._step_fn.route.quad else "sort branches",
              [env._observe_fns[h.value].route for h in groups],
              res["place_s"], res["fps"], SCALE_STEPS, t1m.WARMUP_STEPS,
              step_ms, json.dumps({k: round(v, 4) for k, v in
                                   phases.items()}), obs_ms, sum(dev_obs),
              ["%.4f" % t for t in dev_obs],
              (obs_ms - sum(dev_obs)) / step_ms, json.dumps(dict(per)),
              torch.cuda.max_memory_allocated() / 1e9, wall, device_name),
          flush=True)
    profile_steps("phase 13 (e) test_1m host loop, per step",
                  lambda: [env.get_observation(h) for h in groups]
                  and env.step(), 1, step_ms)
    # row 13 (or whichever window kernel the routes take) at 1M
    paths = {}
    for name, stats in scale_window_rows(
            "test_1m host loop, %d agents, map %d" % (SCALE_N,
                                                      env.spec.width),
            lambda: [env.get_observation(h) for h in groups],
            f32_rate, int32_rate).items():
        rows[name]["per_call"] += stats
        paths[name] = counts[name]
    for name, n in paths.items():
        rows[name].setdefault("launches_by_path", {})[
            "test_1m host loop, %d agents, %d steps" % (SCALE_N, steps)] = n
    del env, res, grids
    torch.cuda.empty_cache()

    # the vectorized loop in one world
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    vres = t1m.run_vectorized(scale_args(vectorized=True))
    wall = time.perf_counter() - t0
    counts = launch_counts()
    venv = vres["venv"]
    print("phase 13 (e) test_1m --vectorized --n_envs 1: %d agents on map "
          "%d, engine route %s, observation routes %s: FPS %.1f, %.4f ms "
          "per step; launches per step %s; peak device memory %.3f GB; %.1f "
          "s in all" % (
              SCALE_N, vres["map_size"], tuple(venv._step.route),
              [o.route for o in venv._observe], vres["fps"],
              1e3 / vres["env_steps_per_s"], json.dumps(
                  {k: v / (2 * SCALE_STEPS) for k, v in counts.items() if v}),
              torch.cuda.max_memory_allocated() / 1e9, wall), flush=True)
    if not any(counts.values()):
        raise AssertionError("test_1m --vectorized launched no kernel")
    if venv._step.route.grid:  # the gridless path keeps no cell_slot
        check_cells_rebuilt("phase 13 (e) test_1m --vectorized", venv,
                            vres["state"])
    for name, n in counts.items():
        if n:
            rows[name].setdefault("launches_by_path", {})[
                "test_1m --vectorized, %d agents, %d steps" % (
                    SCALE_N, 2 * SCALE_STEPS)] = n
    del venv, vres
    torch.cuda.empty_cache()

    # test_mega at its defaults, f32 and bf16, with --observe
    for dtype in ("f32", "bf16"):
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        mres = mega.main(["--observe", "--obs_dtype", dtype])
        wall = time.perf_counter() - t0
        counts = launch_counts()
        venv = mres["venv"]
        n_steps = 2 * mega.cli().parse_args([]).steps
        if not (math.isfinite(mres["sink"]) and any(counts.values())):
            raise AssertionError("test_mega %s: sink %s, launches %s"
                                 % (dtype, mres["sink"], counts))
        print("phase 13 (e) test_mega --observe --obs_dtype %s: %d envs x %d "
              "agents on %dx%d maps, engine route %s, observation routes %s: "
              "%.1f agent-steps/s (%.4f ms per step); launches per step %s; "
              "peak device memory %.3f GB; %.1f s in all" % (
                  dtype, venv.n_envs, mres["per_env"], mres["map_size"],
                  mres["map_size"], tuple(venv._step.route),
                  [o.route for o in venv._observe], mres["value"],
                  mres["seconds"] / (n_steps // 2) * 1e3, json.dumps(
                      {k: v / n_steps for k, v in counts.items() if v}),
                  torch.cuda.max_memory_allocated() / 1e9, wall), flush=True)
        state = venv.reset(rnd.PRNGKey(3, venv.device))
        for name, stats in scale_window_rows(
                "test_mega %s, B=%d, %d agents" % (dtype, venv.n_envs,
                                                   mres["per_env"]),
                lambda: venv.observe_all(state), f32_rate,
                int32_rate).items():
            rows[name]["per_call"] += stats
            rows[name].setdefault("launches_by_path", {})[
                "test_mega %s, 1M agents, %d steps" % (dtype, n_steps)] = (
                counts[name])
        del venv, mres, state
        torch.cuda.empty_cache()

    check_scale_gpu_matches_cpu()


def check_cells_rebuilt(label, world, state):
    """``cell_slot`` of a 1M world equals its rebuild from the live agents'
    positions and bodies (:func:`rebuilt_cells`), and its occupied cells
    are the live bodies' area: no flat offset, sentinel or slot wrapped."""
    cells = rebuilt_cells(world, state)
    if not torch.equal(state.cell_slot, cells):
        raise AssertionError("%s: cell_slot differs from its rebuild"
                             % label)
    spec = world.spec
    alive = state.active & ~state.dead
    area = torch.as_tensor(spec.s_width * spec.s_length,
                           device=state.x.device)
    occupied, want = int((cells >= 0).sum()), int(area[alive[0]].sum())
    if occupied != want:
        raise AssertionError("%s: %d occupied cells for %d cells of live "
                             "bodies" % (label, occupied, want))
    print("%s: cell_slot after the timed steps equals its rebuild from the "
          "positions (%d live agents, %d occupied cells, slots up to %d, "
          "flat cells up to %d)" % (label, int(alive.sum()), occupied,
                                    int(cells.max()),
                                    spec.height * spec.width - 1),
          flush=True)


def scale_window_rows(label, fn, f32_rate, int32_rate):
    """The window kernels ``fn()`` launches, each call held against its
    plain version and timed (:func:`call_stats`) -> {row name: stats}."""
    out = collections.defaultdict(list)
    for g, (name, args, kwargs) in enumerate(record_launched(fn)):
        out[name].append(call_stats(name, args, kwargs, f32_rate,
                                    int32_rate, "%s, group %d" % (label, g)))
    for name, stats in out.items():
        print_window_forms(name, [1] * len(stats), stats)
    torch.cuda.empty_cache()
    if not out:
        raise AssertionError("%s launched no window kernel" % label)
    return out


def check_scale_gpu_matches_cpu():
    """Phase 13 (e): test_1m's host-loop world at SCALE_CMP_N agents on the
    card and on the CPU (the same LCG placements), SCALE_CMP_STEPS steps of
    its random actors (NumPy reseeded before each run): every state field
    equal."""
    from magent_tpu_torch.builtin.rule_model import RandomActor

    t1m = example_module("test_1m")
    states = {}
    for dev in ("cpu", "cuda"):
        env, groups, _ = t1m.host_world(scale_args(agent_number=SCALE_CMP_N,
                                                   device=dev))
        actors = [RandomActor(env, h) for h in groups]
        np.random.seed(3)
        paid = 0.0
        for _ in range(SCALE_CMP_STEPS):
            for h, actor in zip(groups, actors):
                env.set_action(h, actor.infer_action(env.get_observation(h),
                                                     None))
            env.step()
            paid += float(np.abs(env.get_reward(groups[1])).sum())
            env.clear_dead()
        states[dev] = (env.state, paid, [env.get_num(h) for h in groups])
    assert_state_equal(states["cuda"][0], states["cpu"][0],
                       "test_1m host loop, %d agents" % SCALE_CMP_N)
    if states["cuda"][1:] != states["cpu"][1:] or not states["cpu"][1]:
        raise AssertionError("test_1m GPU vs CPU: rewards or counts differ")
    print("GPU vs CPU: test_1m host loop, %d agents on map %d, %d steps of "
          "random actors: every state field equal (|reward| paid %.1f, alive "
          "%s)" % (SCALE_CMP_N, int(math.sqrt(SCALE_CMP_N * 20)),
                   SCALE_CMP_STEPS, states["cpu"][1], states["cpu"][2]),
          flush=True)


def run_examples_phase(rows, f32_rate, int32_rate, device_name):
    """Phase 13: the second backend, every example at its default map, the
    reference harness's protocol, the CLI round and the scale scripts; the
    launches of each path into ``rows``."""
    from magent_tpu_torch.examples.test_examples import candidates

    t_phase = time.perf_counter()
    th_counts = run_second_backend(device_name)
    for name in MODEL_PER_STEP:
        rows[name].setdefault("launches_by_path", {})[
            "second backend (th_model DQN), train_battle's loop, %d steps"
            % MODEL_STEPS["dqn"]] = th_counts[name]
    t = {"(a)": time.perf_counter() - t_phase}

    t0 = time.perf_counter()
    for name in EXAMPLES:
        counts, steps, _ = example_round(name, [], False, device_name,
                                         "(b) default map",
                                         (rows, f32_rate, int32_rate))
        for k, n in counts.items():
            if n:
                rows[k].setdefault("launches_by_path", {})[
                    "%s at its default map, %d steps" % (name, steps)] = n
    for alg, counts in run_fused_example(device_name, rows, f32_rate,
                                         int32_rate).items():
        for k, n in counts.items():
            if n:
                rows[k].setdefault("launches_by_path", {})[
                    "train_battle_fused %s, one train step" % alg] = n
    t["(b)"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for backend in ("jax", "torch"):
        for name, argv in candidates:
            # the kernels' shapes do not depend on the backend
            example_round(name, argv + ["--backend", backend], True,
                          device_name, "(c) harness, --backend %s" % backend,
                          (rows, f32_rate, int32_rate) if backend == "jax"
                          else None)
    t["(c)"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    run_cli_round()
    t["(d)"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    run_scale(rows, f32_rate, int32_rate, device_name)
    t["(e)"] = time.perf_counter() - t0
    print("phase 13: %.1f s (%s)" % (time.perf_counter() - t_phase,
                                     ", ".join("%s %.1f s" % kv
                                               for kv in t.items())),
          flush=True)


# phase 14, sharding: the ("dp", "tp") mesh over torch.distributed
SHARD_TRAIN_STEPS, SHARD_LOCKSTEP_STEPS = 2, 20
# launch_multihost's defaults (map 64, 64 per side, rollout 8), cut to one
# timed call of 16 env steps (train: two calls of two train steps)
SHARD_LM_ARGV = ["--map_size", "64", "--agents_per_side", "64", "--steps",
                 "16", "--calls", "1", "--rollout_len", "8"]
SHARD_RANKS, SHARD_RANK_TIMEOUT_S = 2, 300
# (name, launch_multihost mode, tp) of each two-rank run
SHARD_RUNS = (("env dp=2", "env", 1), ("train dp=2", "train", 1),
              ("train dp=1 tp=2", "train", 2))
SHARD_TRAIN_LR = 1e-4  # launch_multihost's ClipAdam(1e-4, inf)
SHARD_INFER_ROWS = 3000


def shard_lm_args(mode, envs_per_device, nproc):
    from magent_tpu_torch.examples import launch_multihost as lm

    return lm.parse_args(["--mode", mode,
                          "--envs_per_device", str(envs_per_device),
                          "--nproc", str(nproc)] + SHARD_LM_ARGV)


def flat_train(out, gather_fn=None):
    """(params, (mu, nu)) per group of a launch_multihost train run, as
    flat flax dicts of full tensors (``gather_fn``: the mesh's gather)."""
    from magent_tpu_torch.builtin.torch_model import tensors_to_flax

    res = []
    for g, (net, st) in enumerate(zip(out["nets"], out["opt_states"])):
        names = [n for n, _ in net.named_parameters()]
        if gather_fn is not None:
            params = gather_fn(net)
            st = gather_fn(st, out["placement"][g])
        else:
            params = dict(net.named_parameters())
        res.append((tensors_to_flax(params), tuple(
            tensors_to_flax(dict(zip(names, m))) for m in (st.mu, st.nu))))
    return res


def shard_rank_main(argv):
    """One rank of phase 14 (b): ``--shard-rank R --coordinator H:P --out
    DIR``.  Joins a gloo group of SHARD_RANKS ranks on card 0, runs
    SHARD_RUNS through launch_multihost's ``run`` on its mesh, and writes
    its env rows, metrics and launch counts (and, rank 0, the gathered
    parameters and moments); then holds the kernel calls of one lockstep
    step of the env run against their plain versions, one rank after the
    other."""
    import pickle

    import torch.distributed as dist

    from magent_tpu_torch import ops
    from magent_tpu_torch import random as rnd
    from magent_tpu_torch.core.state import FIELDS
    from magent_tpu_torch.examples import launch_multihost as lm
    from magent_tpu_torch.parallel import gather, make_mesh

    rank = int(argv[argv.index("--shard-rank") + 1])
    coord = argv[argv.index("--coordinator") + 1]
    out_dir = argv[argv.index("--out") + 1]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="tcp://" + coord, rank=rank,
                            world_size=SHARD_RANKS)
    res = {}
    env_out = None
    for name, mode, tp in SHARD_RUNS:
        mesh = make_mesh(tp=tp, devices="cuda:0")
        ops.reset_launch_counts()
        out = lm.run(shard_lm_args(mode, 2, SHARD_RANKS), mesh)
        torch.cuda.synchronize()
        r = dict(record=out["record"], rows=out["venv"].env_rows,
                 launches={k: v for k, v in launch_counts().items() if v},
                 state={f: getattr(out["state"], f).cpu()
                        for f in FIELDS})
        if mode == "train":
            r["metrics"] = {k: v.cpu() for k, v in out["metrics"].items()}
            flat = flat_train(out, gather)
            if rank == 0:
                r["flat"] = flat
            r["dense_view_rows"] = [n.dense_view.weight.shape[0]
                                    for n in out["nets"]]
        else:
            env_out = out
        res[name] = r
    f32_rate, int32_rate, _ = peak_rates()
    stats = []
    for turn in range(SHARD_RANKS):
        dist.barrier()
        if turn != rank:
            continue
        venv = env_out["venv"]
        carry = [env_out["state"], rnd.PRNGKey(5, venv.device)]
        calls = record_launched(lambda: lockstep_step(venv, carry))
        for k, (kname, args, kwargs) in enumerate(calls):
            stats.append((kname, call_stats(
                kname, args, kwargs, f32_rate, int32_rate,
                "(b) rank %d of 2 (gloo, one card), map 64, B=2 of 4, 2x64, "
                "call %d" % (rank, k))))
        torch.cuda.synchronize()
    dist.barrier()
    res["kernel_calls"] = stats
    with open(os.path.join(out_dir, "rank%d.pkl" % rank), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()
    return 0


def run_shard_ranks(out_dir):
    """Start the SHARD_RANKS ranks of phase 14 (b) (this script with
    ``--shard-rank``) through launch_multihost's poller, each under
    ``timeout`` -> their results."""
    import pickle

    from magent_tpu_torch.examples import launch_multihost as lm

    coord = "127.0.0.1:%d" % lm.free_port()
    script = os.path.abspath(__file__)
    lm.run_ranks([["timeout", "-k", "10", str(SHARD_RANK_TIMEOUT_S),
                   sys.executable, script, "--shard-rank", str(r),
                   "--coordinator", coord, "--out", out_dir]
                  for r in range(SHARD_RANKS)])
    res = []
    for r in range(SHARD_RANKS):
        with open(os.path.join(out_dir, "rank%d.pkl" % r), "rb") as f:
            res.append(pickle.load(f))
    return res


def check_shard_world_of_one(mesh, rows, device_name):
    """Phase 14 (a): at scripts/bench_train.py's geometry, the ``dqn``
    fused trainer placed through ``param_sharding`` on a one-rank mesh
    against the unsharded trainer over SHARD_TRAIN_STEPS steps, and the
    lockstep loop of a mesh venv (its state placed by ``state_sharding``)
    against the unsharded loop over SHARD_LOCKSTEP_STEPS steps: every
    value equal, bit for bit.  The trainers run on cuDNN's deterministic
    algorithms: the convolutions' gradient sums otherwise vary from run
    to run on the card, mesh or no mesh."""
    from magent_tpu_torch import ops
    from magent_tpu_torch import random as rnd
    from magent_tpu_torch.builtin.config import battle
    from magent_tpu_torch.core.state import FIELDS
    from magent_tpu_torch.parallel import (ClipAdam, VecGridWorld,
                                           device_put, param_sharding,
                                           state_sharding)

    bf16 = torch.bfloat16
    cfg = battle.get_config(MAP_SIZE)
    caps = [N_PER_GROUP, N_PER_GROUP]
    tx = ClipAdam(TRAIN_LR, bench_train.CLIP)
    runs = {}
    for placed in (False, True):
        venv = VecGridWorld(cfg, caps, N_ENVS, obs_dtype=bf16,
                            mesh=mesh if placed else None)
        loop, carry = trainer_loop("dqn", venv, tx, bf16)
        if placed:
            placement = param_sharding(mesh, carry[0])
            for i in range(3):
                carry[i] = device_put(carry[i], placement)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = []
        for s in range(SHARD_TRAIN_STEPS):
            nets, opts, state, m = loop.train_step(
                *carry, rnd.fold_in(rnd.PRNGKey(5, venv.device), s),
                TRAIN_EPS)
            carry[0], carry[2], carry[3] = nets, opts, state
            metrics.append(m)
        torch.cuda.synchronize()
        runs[placed] = (carry, metrics, time.perf_counter() - t0,
                        launch_counts())
        del loop, venv
    (c0, m0, dt0, _), (c1, m1, dt1, counts) = runs[False], runs[True]
    for s, (a, b) in enumerate(zip(m0, m1)):
        for k in a:
            if not torch.equal(a[k], b[k]):
                raise AssertionError("phase 14 (a) dqn step %d: %s %s vs "
                                     "unsharded %s" % (s, k, b[k], a[k]))
    assert_state_equal(c1[3], c0[3], "phase 14 (a) dqn trainer env state")
    for g in range(2):
        for (n, p), (_, q) in zip(c0[0][g].named_parameters(),
                                  c1[0][g].named_parameters()):
            if not torch.equal(p, q):
                raise AssertionError("phase 14 (a) dqn group %d %s" % (g, n))
        for a, b in zip(c0[2][g].mu + c0[2][g].nu, c1[2][g].mu + c1[2][g].nu):
            if not torch.equal(a, b):
                raise AssertionError("phase 14 (a) dqn group %d moments"
                                     % g)
    for name in ("window_gather_bf16", "occupant", "rank_prefix",
                 "move_resolve"):
        if not counts[name]:
            raise AssertionError("phase 14 (a): the placed dqn trainer "
                                 "launched no %s" % name)
        row = "window_gather" if name == "window_gather_bf16" else name
        rows[row].setdefault("launches_by_path", {})[
            "phase 14 (a) dqn trainer on a one-rank mesh, %d train steps"
            % SHARD_TRAIN_STEPS] = counts[name]
    print("phase 14 (a) dqn fused trainer, battle 2x%d, map %d, B=%d, "
          "rollout %d, bf16, on a one-rank mesh (%s backend) placed by "
          "param_sharding: %d train steps equal the unsharded trainer bit "
          "for bit (cuDNN deterministic; losses %s, every parameter, moment "
          "and state field); "
          "%.1f ms vs %.1f ms for the %d steps on %s; launches %s" % (
              N_PER_GROUP, MAP_SIZE, N_ENVS, TRAIN_ROLLOUT,
              torch.distributed.get_backend(), SHARD_TRAIN_STEPS,
              [m["loss"].tolist() for m in m1], dt1 * 1e3, dt0 * 1e3,
              SHARD_TRAIN_STEPS, device_name,
              json.dumps({k: v for k, v in counts.items() if v})),
          flush=True)
    del runs, c0, c1
    torch.cuda.empty_cache()

    venv = VecGridWorld(cfg, caps, N_ENVS)
    mvenv = VecGridWorld(cfg, caps, N_ENVS, mesh=mesh)
    state = venv.reset(rnd.PRNGKey(0))
    carries = [[state, rnd.PRNGKey(2)],
               [device_put(state, state_sharding(mesh, state)),
                rnd.PRNGKey(2)]]
    sinks, counts = [], None
    for v, carry in zip((venv, mvenv), carries):
        ops.reset_launch_counts()
        sink = [lockstep_step(v, carry) for _ in range(SHARD_LOCKSTEP_STEPS)]
        sinks.append(torch.stack(sink))
        counts = launch_counts()
    if not torch.equal(sinks[0], sinks[1]):
        raise AssertionError("phase 14 (a) lockstep: the sums differ")
    for f in FIELDS:
        if not torch.equal(getattr(carries[0][0], f),
                           getattr(carries[1][0], f)):
            raise AssertionError("phase 14 (a) lockstep: %s differs" % f)
    want = {"window_gather": 2, "occupant": 1, "rank_prefix": 1,
            "move_resolve": 1}
    for name, per in want.items():
        if counts[name] != per * SHARD_LOCKSTEP_STEPS:
            raise AssertionError("phase 14 (a) lockstep: %s launched %d "
                                 "times in %d steps" % (
                                     name, counts[name],
                                     SHARD_LOCKSTEP_STEPS))
        rows[name].setdefault("launches_by_path", {})[
            "phase 14 (a) lockstep on a one-rank mesh, %d steps"
            % SHARD_LOCKSTEP_STEPS] = counts[name]
    print("phase 14 (a) lockstep, battle 2x%d, map %d, B=%d: the state "
          "placed by state_sharding on a one-rank mesh, %d steps equal the "
          "unsharded loop bit for bit (every state field, the step sums); "
          "launches %s" % (N_PER_GROUP, MAP_SIZE, N_ENVS,
                           SHARD_LOCKSTEP_STEPS,
                           json.dumps({k: v for k, v in counts.items()
                                       if v})), flush=True)
    del venv, mvenv, carries
    torch.cuda.empty_cache()


def check_shard_two_ranks(mesh, rows, device_name):
    """Phase 14 (b): SHARD_RUNS on two gloo ranks sharing the card against
    the same workloads at world size one (this process): env rows exact,
    losses and mean rewards within TRAIN_LOSS_RTOL, the gathered
    parameters and moments by the Adam rule; each rank's kernel calls of
    one step held against their plain versions."""
    import tempfile

    from magent_tpu_torch.examples import launch_multihost as lm

    checks = tests_helper("_torch_train_checks")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ranks = run_shard_ranks(d)
    dt = time.perf_counter() - t0
    for name, mode, tp in SHARD_RUNS:
        # the one-process run: the same global envs (4) on one rank
        ref = lm.run(shard_lm_args(mode, 4, 1), mesh)
        recs = [r[name]["record"] for r in ranks]
        if any((rec["dp"], rec["tp"], rec["backend"], rec["n_envs"])
               != (SHARD_RANKS // tp, tp, "gloo", 4) for rec in recs):
            raise AssertionError("phase 14 (b) %s: records %s" % (name, recs))
        for r, res in enumerate(ranks):
            r0, r1 = res[name]["rows"]
            for f, t in res[name]["state"].items():
                if not torch.equal(t, getattr(ref["state"], f)[r0:r1].cpu()):
                    raise AssertionError(
                        "phase 14 (b) %s rank %d: %s rows %d:%d differ from "
                        "the one-process run" % (name, r, f, r0, r1))
        msg = ""
        if mode == "train":
            want = {k: v.cpu() for k, v in ref["metrics"].items()}
            for res in ranks:
                for k, v in want.items():
                    np.testing.assert_allclose(
                        res[name]["metrics"][k].numpy(), v.numpy(),
                        rtol=TRAIN_LOSS_RTOL, err_msg="phase 14 (b) " + name)
            if any(res[name]["dense_view_rows"] != [256 // tp] * 2
                   for res in ranks):
                raise AssertionError("phase 14 (b) %s: dense_view rows %s"
                                     % (name, [res[name]["dense_view_rows"]
                                               for res in ranks]))
            steps = 2 * 2  # two calls of two train steps
            for g, ((gp, gm), (wp, wm)) in enumerate(zip(
                    ranks[0][name]["flat"], flat_train(ref))):
                checks.assert_adam_steps_close(
                    gp, wp, gm, wm, lr=SHARD_TRAIN_LR, steps=steps,
                    moment_rtol=TRAIN_MOMENT_RTOL,
                    param_atol=0.2 * SHARD_TRAIN_LR,
                    tag="phase 14 (b) %s group %d" % (name, g))
            msg = (", losses %s within %g of %s, gathered parameters and "
                   "moments within the Adam rule over %d steps" % (
                       ranks[0][name]["metrics"]["loss"].tolist(),
                       TRAIN_LOSS_RTOL, want["loss"].tolist(), steps))
        for k, n in ranks[0][name]["launches"].items():
            rows[k].setdefault("launches_by_path", {})[
                "phase 14 (b) %s, rank 0 of 2 (gloo, one card)" % name] = n
        print("phase 14 (b) %s: 2 gloo ranks on one %s, map 64, 2x64, "
              "4 envs; every rank's env rows equal the one-process run's%s; "
              "rank 0 launches %s; %.1f agent-steps/s (rank 0's record)" % (
                  name, device_name, msg,
                  json.dumps(ranks[0][name]["launches"]),
                  recs[0]["agent_steps_per_s"] or 0.0), flush=True)
        del ref
    n_calls = 0
    for res in ranks:
        for kname, st in res["kernel_calls"]:
            rows[kname]["per_call"].append(st)
            n_calls += 1
    want = collections.Counter(window_gather=2, occupant=1, rank_prefix=1,
                               move_resolve=1)
    for r, res in enumerate(ranks):
        got = collections.Counter(k for k, _ in res["kernel_calls"])
        if got != want:
            raise AssertionError("phase 14 (b) rank %d: one step launched "
                                 "%s" % (r, dict(got)))
    print("phase 14 (b): %d kernel calls of one lockstep step per rank "
          "held against their plain versions (largest error %g); the two "
          "ranks' runs took %.1f s" % (
              n_calls, max(st["max_abs_err"] for res in ranks
                           for _, st in res["kernel_calls"]), dt),
          flush=True)


def run_test_scaling(device_name):
    """Phase 14 (c): ``python -m magent_tpu_torch.examples.test_scaling``
    at its defaults (map 200, 2x1000 agents, 8 envs per device, 32 steps):
    one point on the one card."""
    from magent_tpu_torch.examples import launch_multihost as lm

    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m",
                          "magent_tpu_torch.examples.test_scaling"],
                         capture_output=True, text=True, timeout=600,
                         env=lm.module_env())
    if out.returncode != 0:
        raise AssertionError("test_scaling failed (%d): %s" % (
            out.returncode, out.stderr[-3000:]))
    recs = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    if len(recs) != 1 or recs[0]["devices"] != 1 or not (
            recs[0]["env_steps_per_s"] > 0):
        raise AssertionError("test_scaling printed %s" % out.stdout[-2000:])
    print("phase 14 (c) test_scaling (defaults: map 200, 2x1000, 8 envs per "
          "device, 32 steps) on %s, %.1f s: %s" % (
              device_name, time.perf_counter() - t0, json.dumps(recs[0])),
          flush=True)


def check_sharded_inference(device_name):
    """Phase 14 (d): ``DeepQNetwork(num_gpu=2)`` on the one card caps at
    one device, and with the card twice as its devices runs two replicas
    on it; greedy and eps-0.3 actions of SHARD_INFER_ROWS rows equal the
    unsharded model's (trusty weights, train_battle's map 125)."""
    import magent_tpu_torch as tmag
    from magent_tpu_torch.builtin.torch_model import DeepQNetwork

    env = tmag.GridWorld("battle", map_size=GW_MAP)
    h = env.get_handles()[0]
    flat = dict(np.load(TRUSTY[0]))
    models = {"unsharded": DeepQNetwork(env, h, "shard", memory_size=64),
              "num_gpu=2": DeepQNetwork(env, h, "shard", memory_size=64,
                                        num_gpu=2),
              "num_gpu=2, devices=[cuda:0, cuda:0]": DeepQNetwork(
                  env, h, "shard", memory_size=64, num_gpu=2,
                  devices=["cuda:0", "cuda:0"])}
    n_dev = [m._infer_devices for m in models.values()]
    if n_dev != [1, 1, 2]:
        raise AssertionError("phase 14 (d): inference devices %s" % n_dev)
    rng = np.random.RandomState(0)
    m0 = models["unsharded"]
    view = rng.rand(SHARD_INFER_ROWS, *m0.view_space).astype(np.float32)
    feat = rng.rand(SHARD_INFER_ROWS, *m0.feature_space).astype(np.float32)
    ids = np.arange(SHARD_INFER_ROWS)
    acts = {}
    for tag, m in models.items():
        m.set_params(flat)
        key0 = m.key
        greedy = m.infer_action((view, feat), ids, policy="greedy")
        m.key = key0
        acts[tag] = (greedy, m.infer_action((view, feat), ids, eps=0.3))
    for tag, (greedy, eps) in acts.items():
        if not (np.array_equal(greedy, acts["unsharded"][0])
                and np.array_equal(eps, acts["unsharded"][1])):
            raise AssertionError("phase 14 (d) %s: actions differ from the "
                                 "unsharded model's" % tag)
    print("phase 14 (d) DeepQNetwork on one %s, trusty weights, %d rows: "
          "num_gpu=2 caps at 1 device; with devices=[cuda:0, cuda:0] two "
          "replicas on the card split the padded chunk (4096, 2048 rows "
          "each); greedy and eps-0.3 actions of both equal the unsharded "
          "model's (%d of %d eps-0.3 actions differ from the greedy ones)"
          % (device_name, SHARD_INFER_ROWS,
             int((acts["unsharded"][0] != acts["unsharded"][1]).sum()),
             SHARD_INFER_ROWS), flush=True)


def run_sharding_phase(rows, device_name):
    """Phase 14: the mesh at world size one on the card, two gloo ranks
    sharing it, test_scaling at its defaults, sharded DQN inference."""
    from magent_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    mesh = make_mesh()
    if mesh.shape != {"dp": 1, "tp": 1} or mesh.device.type != "cuda":
        raise AssertionError("phase 14: make_mesh() gave %s" % mesh)
    t = {}
    for part, fn in (("(a)", lambda: check_shard_world_of_one(
                          mesh, rows, device_name)),
                     ("(b)", lambda: check_shard_two_ranks(
                         mesh, rows, device_name)),
                     ("(c)", lambda: run_test_scaling(device_name)),
                     ("(d)", lambda: check_sharded_inference(device_name))):
        t0 = time.perf_counter()
        fn()
        t[part] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    print("phase 14: %.1f s (%s)" % (time.perf_counter() - t_phase,
                                     ", ".join("%s %.1f s" % kv
                                               for kv in t.items())),
          flush=True)


# phase 15, the driving scripts (ROADMAP item 22): each module of
# magent_tpu_torch/tools and /examples through its main() at its own
# widths, the launch counters set to 0 before it and read after; one
# sample of each path's kernel calls (a step, a train step, a variant's
# iteration) recorded and held against the plain versions
REPRO_ALGS, REPRO_STEPS, REPRO_TIMED = ("dqn", "dqn_remat", "a2c", "drqn"), 2, 3
REPRO_LEARN_CALLS = 10  # learn-half calls per timed batch (4 batches)


def train_once(alg, step, carry, key, repaired=True):
    """One train step of trainer ``alg`` (``step``, a loop's
    ``train_step``) on ``carry`` in place; ``repaired=False`` (``dqn``):
    the step's two halves unwrapped from ``deterministic_convolutions``
    (``__wrapped__``), i.e. on cuDNN's default algorithms."""
    from magent_tpu_torch import random as rnd

    args = trainer_args(alg, key, step=True)
    if repaired:
        out = step(*carry, *args)
    else:
        nets, tnets, opts, state = carry
        key, rkey = rnd.split(key).unbind(-2)
        state, traj = step.rollout.__wrapped__(nets, state, rkey, args[1])
        opts, m = step.learn.__wrapped__(nets, tnets, opts, traj, key)
        out = (nets, opts, state, m)
    if alg == "a2c":
        carry[:] = out[:-1]
    else:
        carry[0], carry[2:] = out[0], list(out[1:-1])
    return out[-1]


def repro_run(alg, dtype, repaired, device, timed=0):
    """bench_train's trainer ``alg`` at its geometry with ``dtype`` views
    and trunk: REPRO_STEPS train steps from the keys fold_in(PRNGKey(2),
    s) -> (the nets' parameters flattened, ms per step of ``timed`` more
    synchronized steps)."""
    from magent_tpu_torch import random as rnd

    args = bench_train.cli().parse_args(
        [alg, "--obs_dtype", dtype, "--net_dtype", dtype])
    loop, carry = bench_train.build(args, alg, device)
    step, key = loop.train_step, rnd.PRNGKey(2, device)
    for s in range(REPRO_STEPS):
        train_once(alg, step, carry, rnd.fold_in(key, s), repaired)
    params = [torch.cat([p.detach().reshape(-1) for p in net.parameters()])
              for net in carry[0]]
    ms = None
    if timed:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(timed):
            train_once(alg, step, carry, rnd.fold_in(key, 100 + s),
                       repaired)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / timed * 1e3
    return params, ms


def learn_cost(dtype, device):
    """Device ms per call of ``dqn``'s learn half at bench_train's geometry
    with ``dtype`` views and trunk, with the repair and without it
    (``__wrapped__``): CUDA events around REPRO_LEARN_CALLS back-to-back
    calls on one rollout, in batches with, without, without, with, after
    a warm-up call of each -> ({repaired: [ms per call of each batch]})."""
    from magent_tpu_torch import random as rnd
    from magent_tpu_torch.tools.timing import elapsed_ms

    args = bench_train.cli().parse_args(
        ["dqn", "--obs_dtype", dtype, "--net_dtype", dtype])
    loop, (nets, tnets, opts, state) = bench_train.build(args, "dqn", device)
    step, key = loop.train_step, rnd.PRNGKey(2, device)
    state, traj = step.rollout(nets, state, key, TRAIN_EPS)
    learn = {True: step.learn, False: step.learn.__wrapped__}
    box = [opts]

    def call(repaired, k):
        box[0] = learn[repaired](nets, tnets, box[0], traj,
                                 rnd.fold_in(key, k))[0]

    for repaired in (True, False):
        call(repaired, 0)
    ms = {True: [], False: []}
    for b, repaired in enumerate((True, False, False, True)):
        ks = iter(range(b * REPRO_LEARN_CALLS, (b + 1) * REPRO_LEARN_CALLS))
        ms[repaired].append(elapsed_ms(lambda: call(repaired, next(ks)),
                                       REPRO_LEARN_CALLS, device)
                            / REPRO_LEARN_CALLS)
    return ms


def check_model_reproducible():
    """``DeepQNetwork.train`` twice from fixed seeds at the card test's
    size (``tests/_torch_model_play.py`` ``DQN_REPRO``), with the repair
    and without it (``__wrapped__``) -> {repaired: parameters that
    differ}; fails if any differ with it."""
    import io

    import magent_tpu_torch as tmag
    from magent_tpu_torch.builtin.torch_model import DeepQNetwork

    helper = tests_helper("_torch_model_play")
    repaired_train, out = DeepQNetwork.train, {}
    try:
        for repaired in (True, False):
            DeepQNetwork.train = (repaired_train if repaired
                                  else repaired_train.__wrapped__)
            with contextlib.redirect_stdout(io.StringIO()):  # train's log
                a, b = (helper.dqn_train_params(
                    tmag, DeepQNetwork, torch.device("cuda"),
                    **helper.DQN_REPRO) for _ in range(2))
            out[repaired] = sum(int((x != y).sum()) for x, y in zip(a, b))
            print("phase 15 reproducibility: DeepQNetwork.train %s (battle "
                  "map %d, %d agents a side, batch %d): two runs differ in "
                  "%d of %d parameters" % (
                      "with deterministic_convolutions" if repaired
                      else "on cuDNN's defaults",
                      helper.DQN_REPRO["map_size"], helper.DQN_REPRO["n"],
                      helper.DQN_REPRO["batch_size"], out[repaired],
                      sum(x.numel() for x in a)), flush=True)
    finally:
        DeepQNetwork.train = repaired_train
    if out[True]:
        raise AssertionError("phase 15: DeepQNetwork.train is not "
                             "reproducible with the repair")
    return out


def check_reproducible(device_name):
    """Phase 15 (repair): each trainer at bench_train's geometry (battle
    2x1000, B=16, rollout 8) run twice from one key, parameters compared
    bit for bit; ``dqn`` in f32 and bf16 also without the repair, and its
    ms per train step with and without; then one f32 step of each under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``, the ops
    it flags printed; and :func:`check_model_reproducible` -> {(alg,
    dtype, repaired): (differing, ms), ("learn", dtype): :func:`learn_cost`,
    "DeepQNetwork": {repaired: differing}}."""
    device = torch.device("cuda")
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic = cudnn.benchmark = False  # PyTorch's defaults
    out = {}
    try:
        for alg in REPRO_ALGS:
            for dtype in ("f32", "bf16") if alg == "dqn" else ("f32",):
                for repaired in (True, False) if alg == "dqn" else (True,):
                    # the cost is measured on dqn alone
                    a, ms = repro_run(alg, dtype, repaired, device,
                                      REPRO_TIMED if alg == "dqn" else 0)
                    b, _ = repro_run(alg, dtype, repaired, device)
                    n_diff = sum(int((x != y).sum()) for x, y in zip(a, b))
                    n_all = sum(x.numel() for x in a)
                    out[alg, dtype, repaired] = (n_diff, ms)
                    cost = ("; %.3f ms per train step (%d synchronized "
                            "steps) on %s" % (ms, REPRO_TIMED, device_name)
                            if ms is not None else "")
                    print("phase 15 reproducibility: %s %s %s: two runs "
                          "of %d train steps from one key differ in %d of "
                          "%d parameters%s" % (
                              alg, dtype, "with deterministic_convolutions"
                              if repaired else "on cuDNN's defaults",
                              REPRO_STEPS, n_diff, n_all, cost), flush=True)
                    if repaired and n_diff:
                        raise AssertionError(
                            "phase 15: trainer %s %s is not reproducible "
                            "with the repair" % (alg, dtype))
                    del a, b
                    torch.cuda.empty_cache()
        out["DeepQNetwork"] = check_model_reproducible()
        for dtype in ("f32", "bf16"):
            ms = learn_cost(dtype, device)
            out["learn", dtype] = ms
            print("phase 15 the repair's device cost, dqn %s learn half: "
                  "%.4f ms per call with deterministic_convolutions, %.4f "
                  "ms on cuDNN's defaults (CUDA events, %d calls per batch, "
                  "batches with %s, without %s) on %s" % (
                      dtype, statistics.mean(ms[True]),
                      statistics.mean(ms[False]), REPRO_LEARN_CALLS,
                      json.dumps(ms[True]), json.dumps(ms[False]),
                      device_name), flush=True)
            torch.cuda.empty_cache()
        torch.use_deterministic_algorithms(True, warn_only=True)
        for alg in REPRO_ALGS:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                repro_run(alg, "f32", True, device)
                torch.cuda.synchronize()
            flagged = sorted({str(w.message).strip().splitlines()[0][:160]
                              for w in caught})
            print("phase 15 deterministic-algorithms scan, %s f32: %s" % (
                alg, json.dumps(flagged) if flagged else "nothing flagged"),
                flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
        cudnn.deterministic, cudnn.benchmark = saved
    return out


def hold_calls(calls, label, phase=15):
    """Each recorded ``(counter, args, kwargs)`` kernel call held against
    its plain version (:func:`hold_call`) -> the largest error."""
    err = 0.0
    for k, (name, args, kwargs) in enumerate(calls):
        err = max(err, hold_call(name, args, kwargs,
                                 "%s, call %d" % (label, k))[2])
    print("phase %d %s: %d kernel calls (%s) equal their plain versions "
          "(max abs error %g)" % (phase, label, len(calls), json.dumps(dict(
              collections.Counter(c[0] for c in calls))), err), flush=True)
    return err


def run_module(rows, label, fn, phase=15):
    """``fn()`` (a module's main) with the launch counters set to 0 before
    it and read after, into ``rows``' ``launches_by_path`` -> (its result,
    the counts, seconds)."""
    from magent_tpu_torch import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {k: v for k, v in launch_counts().items() if v}
    for name, n in counts.items():
        rows[name].setdefault("launches_by_path", {})[label] = n
    print("phase %d %s: %.1f s, launches %s" % (phase, label, dt,
                                                json.dumps(counts)),
          flush=True)
    return result, counts, dt


def run_bench_scripts(rows):
    """Phase 15 (22a): tools.bench, tools.bench_train (the four trainers)
    and tools.bench_pursuit (default and --turn) at their defaults; one
    step (train step) of each path recorded and held."""
    from magent_tpu_torch import random as rnd
    from magent_tpu_torch.tools import bench_pursuit

    dev = torch.device("cuda")
    run_module(rows, "tools.bench at its defaults",
               lambda: bench.main([]))
    args = bench.cli().parse_args([])
    venv = bench.build(args, dev)
    state = venv.reset(rnd.PRNGKey(0, dev))
    hold_calls(record_launched(lambda: bench.run(
        venv, state, rnd.PRNGKey(1, dev), 1)), "tools.bench, one step")
    del venv, state
    run_module(rows, "tools.bench_train, dqn dqn_remat a2c drqn",
               lambda: bench_train.main(list(REPRO_ALGS)))
    for alg in REPRO_ALGS:
        targs = bench_train.cli().parse_args([alg])
        loop, carry = bench_train.build(targs, alg, dev)
        hold_calls(record_launched(lambda: train_once(
            alg, loop.train_step, carry, rnd.PRNGKey(2, dev))),
            "tools.bench_train %s, one train step" % alg)
        del loop, carry
        torch.cuda.empty_cache()
    for argv in ([], ["--turn"]):
        label = "tools.bench_pursuit %s" % (" ".join(argv) or "default")
        run_module(rows, label + ", map 1000",
                   lambda: bench_pursuit.main(argv))
        pargs = bench_pursuit.cli().parse_args(argv)
        venv = bench_pursuit.build(pargs, dev)
        state = venv.reset(rnd.PRNGKey(0, dev))
        hold_calls(record_launched(lambda: bench_pursuit.run(
            venv, state, rnd.PRNGKey(1, dev), 1)), label + ", one step")
        del venv, state
        torch.cuda.empty_cache()


EV_ROUNDS, EV_SAVE, EV_EVAL_STEPS = 20, 10, 20  # train_evidence: 600, 0, 200
PLAY_GAMES, PLAY_STEPS = 2, 50  # eval_checkpoint 4 x 400; tournament 10 x 550
SEG_DIFF_N = (6000, 20000)  # diff_seg_chip: its default, and in the seg range
FUZZ_SEEDS = 1  # the fuzzers' 25 and 10 (each leg a process of ~10 s)


def run_evidence_paths(rows):
    """Phase 15 (22b) in ``work``: train_evidence on its three games, then
    the checkpoint plays over what it and ``data/models`` hold."""
    from magent_tpu_torch.examples import (eval_checkpoint, tournament,
                                           tournament_pursuit,
                                           train_evidence)

    print("phase 15 cuts: train_evidence --n_round %d (600) --save_every "
          "%d --eval_steps %d (200); tournament_pursuit --eval_steps %d "
          "(200); eval_checkpoint --n_games %d (4) --max_steps %d (400); "
          "tournament --n_game %d (10) --max_steps %d (550)"
          % (EV_ROUNDS, EV_SAVE, EV_EVAL_STEPS, EV_EVAL_STEPS, PLAY_GAMES,
             PLAY_STEPS, PLAY_GAMES, PLAY_STEPS), flush=True)
    for game in ("pursuit", "gather", "tiger"):
        argv = ["--game", game, "--n_round", str(EV_ROUNDS), "--save_every",
                str(EV_SAVE), "--eval_steps", str(EV_EVAL_STEPS), "--name",
                "smoke-" + game]
        out = run_module(rows, "examples.train_evidence %s, map 64, B=16, "
                         "%d rounds" % (game, EV_ROUNDS),
                         lambda: train_evidence.main(argv))[0]
        if not (math.isfinite(out["trained"])
                and math.isfinite(out["untrained"])):
            raise AssertionError("train_evidence %s: eval %s" % (game, out))
        args = train_evidence.cli().parse_args(argv + [
            "--steps_per_call", "1", "--rollout_len", "2"])
        ex = train_evidence.setup(args)
        hold_calls(record_launched(lambda: ex.call(0, 1.0)),
                   "examples.train_evidence %s, one train step of rollout "
                   "2" % game)
        del ex
    gens, matrix = run_module(
        rows, "examples.tournament_pursuit, 3 x 3 generations",
        lambda: tournament_pursuit.main(
            ["--name", "smoke-pursuit", "--eval_steps",
             str(EV_EVAL_STEPS)]))[0]
    if gens != [0, EV_SAVE, 2 * EV_SAVE] or not np.isfinite(matrix).all():
        raise AssertionError("tournament_pursuit: %s %s" % (gens, matrix))
    models = os.path.join(REPO_ROOT, "data", "models")
    play_argv = ["--savedir", models, "--name", "trusty-battle-game-l",
                 "--n_games", str(PLAY_GAMES), "--max_steps", str(PLAY_STEPS)]
    games = run_module(rows, "examples.eval_checkpoint, map 64, %d games"
                       % PLAY_GAMES,
                       lambda: eval_checkpoint.main(play_argv))[0]
    if len(games) != PLAY_GAMES:
        raise AssertionError("eval_checkpoint: %s" % games)
    args = eval_checkpoint.cli().parse_args(play_argv + ["--n_games", "1",
                                                         "--max_steps", "1"])
    ex = eval_checkpoint.setup(args)
    hold_calls(record_launched(lambda: eval_checkpoint.play(ex, args)),
               "examples.eval_checkpoint, one step")
    os.makedirs("save_model/smoke-battle", exist_ok=True)
    for side, epoch in (("l", 0), ("r", 3)):
        shutil.copy(os.path.join(models, "trusty-battle-game-%s" % side,
                                 "tfdqn_0.npz"),
                    "save_model/smoke-battle/tfdqn_%d.npz" % epoch)
    results = run_module(
        rows, "examples.tournament, map 125, epochs 0 and 3",
        lambda: tournament.main(["--name", "smoke-battle",
                                 "--pick_every", "1", "--n_game",
                                 str(PLAY_GAMES), "--max_steps",
                                 str(PLAY_STEPS)]))[0]
    if list(results) != [(0, 3)]:
        raise AssertionError("tournament: %s" % results)


def run_profilers(rows):
    """Phase 15 (22c): four profilers at their defaults (``profile_drqn``
    in phase 16); one iteration of each kernel path they add held against
    the plain versions."""
    from magent_tpu_torch import random as rnd
    from magent_tpu_torch.tools import (profile_banded, profile_micro,
                                        profile_phases, profile_sweep)

    dev = torch.device("cuda")
    for name, mod in (("profile_phases", profile_phases),
                      ("profile_sweep", profile_sweep),
                      ("profile_micro", profile_micro),
                      ("profile_banded", profile_banded)):
        out = run_module(rows, "tools.%s at its defaults" % name,
                         lambda: mod.main([]))[0]
        bad = {k: v for k, v in out.items()
               if v is not None and not (v[0] > 0 and math.isfinite(v[1]))}
        if bad:
            raise AssertionError("%s: %s" % (name, bad))
    for name in ("rank_prefix", "move_claims"):
        def one_iteration():
            # the variant built under the recording: it binds its kernel
            init, body = profile_micro.variant(name)
            body(init(rnd.PRNGKey(0, dev)))

        hold_calls(record_launched(one_iteration),
                   "tools.profile_micro %s, one iteration" % name)
    pargs = profile_phases.cli().parse_args([])
    venv = profile_phases.build(pargs, dev)
    for name, (v, body) in profile_phases.variant_bodies(
            venv, pargs.variants, profile_phases.phase_context(venv)).items():
        state = v.reset(rnd.PRNGKey(0, dev))
        hold_calls(record_launched(lambda: bench.run(
            v, state, rnd.PRNGKey(1, dev), 1, body)),
            "tools.profile_phases %s, one step" % name)
    del venv, v, state
    bargs = profile_banded.cli().parse_args([])
    bodies, key = profile_banded.build(bargs, dev)
    with torch.no_grad():
        for name in bargs.variants:
            if name in bodies:  # the rest are fused: no call of their own
                hold_calls(record_launched(
                    lambda: bodies[name](rnd.fold_in(key, 0))),
                    "tools.profile_banded %s, one iteration" % name)
    del bodies
    torch.cuda.empty_cache()
    venv, _, walls = profile_sweep.build_venv(100000, 16, device=dev)
    state = venv.reset(rnd.PRNGKey(0, dev))
    hold_calls(record_launched(lambda: bench.run(venv, state, rnd.PRNGKey(
        1, dev), 1)), "tools.profile_sweep's world, one step")
    del venv, state
    torch.cuda.empty_cache()


def run_diff_paths(rows):
    """Phase 15 (22d): both fuzzers (the port's leg on the card against
    its leg on the CPU; each leg a child process, its launches counted
    there), diff_seg_chip at SEG_DIFF_N and search cut to one round."""
    from magent_tpu_torch import random as rnd
    from magent_tpu_torch.parallel import VecGridWorld
    from magent_tpu_torch.tools import (diff_seg_chip, fuzz_reference,
                                        fuzz_snake, search)

    dev = torch.device("cuda")
    # each fuzzer waits on its legs' child processes: the two run side by
    # side (their launches are the children's, not counted here)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        fuzzes = {name: pool.submit(mod.main, ["--against", "cpu", "--seeds",
                                               str(FUZZ_SEEDS)] + extra)
                  for name, mod, extra in (
                      ("fuzz_reference", fuzz_reference, ["--views"]),
                      ("fuzz_snake", fuzz_snake, []))}
        failed = {name: f.result() for name, f in fuzzes.items()}
    print("phase 15 tools.fuzz_reference and tools.fuzz_snake, %d seed(s) "
          "each, the card's legs against the CPU's: %.1f s, failed seeds "
          "%s" % (FUZZ_SEEDS, time.perf_counter() - t0, failed), flush=True)
    if any(failed.values()):
        raise AssertionError("the fuzzers failed: %s" % failed)
    for n in SEG_DIFF_N:
        out = run_module(rows, "tools.diff_seg_chip n=%d" % n,
                         lambda: diff_seg_chip.main([str(n)]))[0]
        if out["seg"] != (n > diff_seg_chip.ap.QUAD_MAX_SINGLE):
            raise AssertionError("diff_seg_chip n=%d: route %s" % (
                n, out["route"]))
        print("phase 15 diff_seg_chip n=%d: %s, bit for bit over %d steps"
              % (n, "the segmented sweeps engaged" if out["seg"]
                 else "the pair kernels' gridless path", out["steps"]),
              flush=True)
    cfg, caps, placements, walls = diff_seg_chip.build(SEG_DIFF_N[-1])
    venv = VecGridWorld(cfg, caps, 1, placements=placements, walls=walls)
    state = venv.reset(rnd.PRNGKey(0, dev))
    acts = venv.random_actions(rnd.PRNGKey(1, dev))
    hold_calls(record_launched(lambda: venv.step(state, acts)),
               "tools.diff_seg_chip n=%d, one gridless step" % SEG_DIFF_N[-1])
    del venv, state
    argv = ["--algs", "dqn", "--n_round", "1"]
    print("phase 15 cuts: search %s (its 3 algorithms x 50 rounds)"
          % " ".join(argv), flush=True)
    run_module(rows, "tools.search, train_tiger dqn, 1 round",
               lambda: search.main(argv))
    log = open("search.log").read().splitlines()
    if not log or not log[-1].endswith("code: 0"):
        raise AssertionError("search: %s" % log[-1:])


def run_driving_scripts(rows, device_name):
    """Phase 15, in a scratch directory (the scripts write save_model/ and
    their logs into the working directory) -> seconds."""
    t0 = time.perf_counter()
    check_reproducible(device_name)
    run_bench_scripts(rows)
    here = os.getcwd()
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)
        try:
            run_evidence_paths(rows)
            run_profilers(rows)
            run_diff_paths(rows)
        finally:
            os.chdir(here)
    dt = time.perf_counter() - t0
    print("phase 15 (the driving scripts) took %.1f s" % dt, flush=True)
    return dt


# phase 16: the JAX profilers' split variants and the trainers' forms that
# bench_train does not build.  profile_drqn runs its 13 variants at its
# default width with its depth cut (its defaults: 4 calls of 4 iterations)
P16_DRQN_CUT = ["--calls", "1", "--inner", "2"]
P16_MICRO = ("row_gather", "scatter_max", "scatter_set", "rand_bits")
P16_A2C_STEPS = 3  # timed A2C+CommNet train steps, after a warm one
P16_FORMS = {
    "a2c+CommNet": ("a2c", dict(use_comm=True)),
    "drqn share_acting, unroll_remat False": (
        "drqn", dict(share_acting=True, unroll_remat=False)),
    "drqn share_acting, unroll_remat dots": (
        "drqn", dict(share_acting=True, unroll_remat="dots")),
    "drqn two unrolls, unroll_remat False": (
        "drqn", dict(share_acting=False, unroll_remat=False)),
    "drqn two unrolls, unroll_remat dots": (
        "drqn", dict(share_acting=False, unroll_remat="dots")),
    "drqn two unrolls, unroll_remat all": (
        "drqn", dict(share_acting=False, unroll_remat="all")),
}


def print_variants(label, out, unit, card):
    """Each ``{variant: (ms, sink)}`` of a profiler's ``main`` printed with
    the card; fails on a time not above 0 or a sink not finite."""
    for name, (ms, sink) in out.items():
        if not (ms > 0 and math.isfinite(sink)):
            raise AssertionError("%s %s: %s ms, sink %s" % (label, name, ms,
                                                            sink))
        print("phase 16 %s %-15s %9.3f %s on %s" % (label, name, ms, unit,
                                                     card), flush=True)


def run_drqn_split(rows, card):
    """Phase 16: ``tools.profile_drqn``'s 13 variants at its default width,
    then one iteration of each recorded and its kernel calls held."""
    from magent_tpu_torch import random as rnd
    from magent_tpu_torch.tools import profile_drqn

    dev = torch.device("cuda")
    print("phase 16 cuts: profile_drqn %s (its --calls 4 --inner 4)"
          % " ".join(P16_DRQN_CUT), flush=True)
    out = run_module(rows, "tools.profile_drqn, its 13 variants",
                     lambda: profile_drqn.main(P16_DRQN_CUT), phase=16)[0]
    if list(out) != list(profile_drqn.VARIANTS):
        raise AssertionError("profile_drqn ran %s" % list(out))
    print_variants("tools.profile_drqn", out, "ms per env step", card)
    variants, _ = profile_drqn.build(profile_drqn.cli().parse_args([]), dev)
    for name, (fn, operands) in variants.items():
        ops_ = copy.deepcopy(operands)
        hold_calls(record_launched(lambda: fn(rnd.PRNGKey(5, dev), *ops_)),
                   "tools.profile_drqn %s, one iteration" % name, phase=16)
        del ops_
    del variants
    torch.cuda.empty_cache()
    return out


def run_opt_in_profilers(rows, card):
    """Phase 16: ``profile_phases one_group view_only`` (one step of each
    variant that runs held), ``profile_banded plain`` at its default 16 x
    62,500 (its peak memory; its sink equal to ``fixed_img``'s at the same
    moved positions, whose kernel call is held) and ``profile_micro``'s
    primitives."""
    from magent_tpu_torch import random as rnd
    from magent_tpu_torch.tools import (profile_banded, profile_micro,
                                        profile_phases)

    dev = torch.device("cuda")
    opt_in = list(profile_phases.OPT_IN)
    out = run_module(rows, "tools.profile_phases %s" % " ".join(opt_in),
                     lambda: profile_phases.main(opt_in), phase=16)[0]
    if sorted(out) != ["one_group"]:  # battle's 13 x 13 x 7 windows skip
        raise AssertionError("profile_phases ran %s" % sorted(out))
    print_variants("tools.profile_phases", out, "ms per step", card)
    pargs = profile_phases.cli().parse_args(opt_in)
    venv = profile_phases.build(pargs, dev)
    for name, (v, body) in profile_phases.variant_bodies(
            venv, pargs.variants, profile_phases.phase_context(venv)).items():
        state = v.reset(rnd.PRNGKey(0, dev))
        hold_calls(record_launched(lambda: bench.run(
            v, state, rnd.PRNGKey(1, dev), 1, body)),
            "tools.profile_phases %s, one step" % name, phase=16)
    del venv, v, state
    torch.cuda.empty_cache()

    out = run_module(rows, "tools.profile_banded plain, 16 x 62,500",
                     lambda: profile_banded.main(["plain"]), phase=16)[0]
    print_variants("tools.profile_banded", out, "ms per iteration", card)
    bodies, key = profile_banded.build(profile_banded.cli().parse_args(
        ["plain"]), dev)
    k = rnd.fold_in(key, 0)
    with torch.no_grad():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        plain = float(bodies["plain"](k))
        peak = torch.cuda.max_memory_allocated() - base
        kernel = float(bodies["fixed_img"](k))
        hold_calls(record_launched(lambda: bodies["fixed_img"](k)),
                   "tools.profile_banded fixed_img at plain's positions",
                   phase=16)
    if plain != kernel:
        raise AssertionError("profile_banded: plain's sink %r, the kernel's "
                             "%r" % (plain, kernel))
    print("phase 16 tools.profile_banded plain: sink %r equal to the "
          "kernel's (fixed_img) at the same positions; %.3f GB of device "
          "memory above its operands at its peak" % (plain, peak / 1e9),
          flush=True)
    del bodies
    torch.cuda.empty_cache()

    out = run_module(rows, "tools.profile_micro %s" % " ".join(P16_MICRO),
                     lambda: profile_micro.main(list(P16_MICRO)), phase=16)[0]
    print_variants("tools.profile_micro", out, "ms per step", card)


def run_a2c_comm(rows, card):
    """Phase 16: the fused A2C trainer with CommNet nets (fresh, seeded) at
    bench_train's geometry (battle 2x1000, B=16, rollout 8, bf16 views
    and trunk): a warm train step, P16_A2C_STEPS timed ones (synchronized
    host clock), their launches asserted, one more step's kernel calls
    held."""
    from magent_tpu_torch import ops
    from magent_tpu_torch import random as rnd
    from magent_tpu_torch.builtin.config import battle
    from magent_tpu_torch.parallel import ClipAdam, VecGridWorld

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    venv = VecGridWorld(battle.get_config(MAP_SIZE),
                        [N_PER_GROUP, N_PER_GROUP], n_envs=N_ENVS,
                        obs_dtype=bf16, device=dev)
    nets = fresh_nets("a2c", venv.spec, dev, bf16, use_comm=True)
    loop, carry = bench_train.trainer_loop(
        "a2c", venv, ClipAdam(TRAIN_LR, bench_train.CLIP), bf16, nets,
        **bench_train.loop_kwargs(bench_train.cli().parse_args(["a2c"])))
    step, key = loop.train_step, rnd.PRNGKey(2, dev)
    float(train_once("a2c", step, carry, key)["loss"].sum())
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    losses = torch.stack([train_once("a2c", step, carry,
                                     rnd.fold_in(key, s + 1))["loss"]
                          for s in range(P16_A2C_STEPS)]).cpu()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / P16_A2C_STEPS * 1e3
    counts = {k: v for k, v in launch_counts().items() if v}
    n_env = TRAIN_ROLLOUT * P16_A2C_STEPS
    expected = dict(window_gather_bf16=2 * n_env + LEARNER_VIEWS["a2c"]
                    * P16_A2C_STEPS, occupant=n_env, rank_prefix=n_env,
                    move_resolve=n_env)
    if counts != expected:
        raise AssertionError("a2c+CommNet: launches %s, expected %s"
                             % (counts, expected))
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError("a2c+CommNet: losses %s" % losses.tolist())
    label = "trainer a2c+CommNet, %d train steps" % P16_A2C_STEPS
    for name, n in counts.items():
        rows[name].setdefault("launches_by_path", {})[label] = n
    print("phase 16 trainer a2c+CommNet: battle 2x%d, map %d, B=%d, rollout "
          "%d, bf16 views and trunk, fresh nets: %.3f ms per train step "
          "(%d synchronized steps), %.1f trained agent-steps/s on %s; "
          "losses %s; launches per train step %s" % (
              N_PER_GROUP, MAP_SIZE, N_ENVS, TRAIN_ROLLOUT, ms,
              P16_A2C_STEPS, 2 * N_PER_GROUP * N_ENVS * TRAIN_ROLLOUT
              / (ms / 1e3), card, losses[-1].tolist(), json.dumps(
                  {k: v / P16_A2C_STEPS for k, v in counts.items()})),
          flush=True)
    hold_calls(record_launched(lambda: train_once(
        "a2c", step, carry, rnd.fold_in(key, 99))),
        "trainer a2c+CommNet, one train step", phase=16)
    del loop, step, carry, venv, nets
    torch.cuda.empty_cache()
    return ms


def run_split_phase(rows, card):
    """Phase 16 -> seconds."""
    t0 = time.perf_counter()
    run_drqn_split(rows, card)
    run_opt_in_profilers(rows, card)
    run_a2c_comm(rows, card)
    check_trainers_gpu_match_cpu(P16_FORMS, repeat=True)
    dt = time.perf_counter() - t0
    print("phase 16 (the profilers' split variants, the trainers' other "
          "forms) took %.1f s" % dt, flush=True)
    return dt


def _flat(items):
    for item in items:
        if isinstance(item, list):
            yield from _flat(item)
        else:
            yield item


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from magent_tpu_torch import random as rnd
    from magent_tpu_torch.builtin.config import battle
    from magent_tpu_torch.ops import _build
    from magent_tpu_torch.parallel import VecGridWorld

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    log = _build.build(force=True)
    _build.lib()
    print("kernels built in %.1f s (nvcc, sm_90a)" % (time.perf_counter() - t0),
          flush=True)
    for line in log.splitlines():
        if "registers" in line or "error" in line.lower():
            print("  ptxas:", line.strip())

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device_name = torch.cuda.get_device_name(0)
    venv = VecGridWorld(battle.get_config(MAP_SIZE),
                        [N_PER_GROUP, N_PER_GROUP], n_envs=N_ENVS)
    state = venv.reset(rnd.PRNGKey(0))
    f32_rate, int32_rate, mhz = peak_rates()
    print("peak at %.0f MHz max SM clock: %.4g f32 and %.4g int32 "
          "instructions/s" % (mhz, f32_rate, int32_rate), flush=True)
    rows = check_kernels(venv, state, rnd.PRNGKey(1), f32_rate, int32_rate)
    rng_row = check_threefry(int32_rate)
    gru_rows = check_gru_cell(card)
    counts, state, key, ms_per_step, _ = run_lockstep(
        "main path: battle lockstep", venv, state, rnd.PRNGKey(2),
        {"window_gather": 2, "occupant": 1, "rank_prefix": 1,
         "move_resolve": 1}, device_name, draws=LOCKSTEP_DRAWS)
    for name, row in rows.items():
        row["launches"] = counts[name]
    rng_row["launches"] = LOCKSTEP_DRAWS * TIMED_STEPS
    rows[RNG_KERNEL] = rng_row
    rows.update(gru_rows)
    profile_lockstep("lockstep", venv, state, key, ms_per_step)
    del venv, state
    torch.cuda.empty_cache()
    gw_counts, gw_rows, gw_views = run_gridworld_path(f32_rate, int32_rate,
                                                      device_name)
    for name, row in gw_rows.items():
        row["launches"] = gw_counts[name]
    rows.update(gw_rows)
    rows["window_gather"]["per_call"] += gw_views
    tiger = {m: run_tiger_path(m, f32_rate, int32_rate, device_name)
             for m in TIGER_MAPS}
    pursuit_worlds = {m: run_pursuit_world_path(m, f32_rate, int32_rate,
                                                device_name)
                      for m in PURSUIT_WORLD_MAPS}
    turn = {m: run_turn_path(m, f32_rate, int32_rate, device_name)
            for m in TURN_MAPS}
    check_turn_gpu_matches_cpu()
    n_goldens = check_goldens_on_card()
    reference_order = {
        "sequential GridWorld battle map %d" % GW_MAP: run_sequential_path(
            f32_rate, int32_rate, device_name),
        "DiscreteSnake map 100": run_snake_path(f32_rate, int32_rate,
                                                device_name)}
    # later phases report their peak memory from here
    torch.cuda.reset_peak_memory_stats()
    rect_rows, banded_500, syncs_500, g4_forms = run_pursuit_paths(
        f32_rate, int32_rate, device_name, rows["rank_prefix"])
    rows.update(rect_rows)
    seg_rows, banded_1000 = run_seg_path(f32_rate, int32_rate, device_name,
                                         banded_500, syncs_500)
    rows.update(seg_rows)
    del banded_500
    # phase 6's ragged checks, after the pursuit loops have reported their
    # peak device memory: the plain versions hold up to ~13 GB
    check_rect_ragged()
    rows.update(run_window_ladder(f32_rate))
    train_rows, train_counts = run_trainers(f32_rate, int32_rate,
                                            device_name, g4_forms,
                                            banded_1000)
    rows.update(train_rows)
    for alg, counts in train_counts.items():
        for name in ("occupant", "rank_prefix", "move_resolve"):
            rows[name].setdefault("launches_by_path", {})[
                "trainer %s, %d timed calls" % (alg, TRAIN_CALLS)] = (
                counts[name])
    del g4_forms, banded_1000
    torch.cuda.empty_cache()
    check_trainers_gpu_match_cpu()

    check_gpu_matches_cpu(
        "battle map %d" % SMALL_MAP,
        lambda d: VecGridWorld(battle.get_config(SMALL_MAP),
                               [SMALL_N, SMALL_N], SMALL_ENVS, device=d),
        SMALL_STEPS, VIEW_ATOL)
    check_gridworld_gpu_matches_cpu()
    pairs = (check_tiger_gpu_matches_cpu(
        "double_attack map %d, train_tiger's layout" % TIGER_SMALL_MAP,
        TIGER_SMALL_MAP, place_tiger_world, TIGER_SMALL_STEPS)
        + check_tiger_gpu_matches_cpu(
            "double_attack map 20, the golden layout, sort branches forced",
            20, place_golden_tigers, TIGER_SMALL_STEPS, sort=True)
        + check_tiger_gpu_matches_cpu(
            "double_attack map 500, train_tiger's layout", 500,
            place_tiger_world, TIGER_BIG_STEPS))
    if not pairs:
        raise AssertionError("the double_attack GPU-vs-CPU runs paid no "
                             "double attack")
    check_new_grid_paths_gpu_match_cpu()
    for frac in (0.0, P_WALL_FRAC):
        check_gpu_matches_cpu(
            "pursuit map %d, %g interior walls" % (P_MAP, frac),
            lambda d: pursuit_env(P_MAP, P_ENVS, P_SEED, frac, device=d),
            P_SMALL_STEPS, 0.0)
    check_gpu_matches_cpu(
        "pursuit one world, map %d (segmented sweeps, banded gather)"
        % P_SEG_SMALL_MAP, seg_world_env, P_SMALL_STEPS, 0.0)
    check_gpu_matches_cpu(
        "battle map %d forced onto the banded route, bf16 views, minimap"
        % SMALL_MAP, banded_battle_env, SMALL_STEPS, 0.0)
    model_counts = run_model_layer(device_name)
    for name in MODEL_PER_STEP:
        rows[name].setdefault("launches_by_path", {})[
            "model layer, train_battle's DQN loop, %d steps"
            % MODEL_STEPS["dqn"]] = model_counts[name]
    replay_counts, server_counts = run_rendering(device_name)
    for name in RENDER_PER_STEP:
        paths = rows[name].setdefault("launches_by_path", {})
        paths["rendered battle replay, %d steps" % RENDER_TIMED] = (
            replay_counts[name])
        paths["rendered battle game (BattleServer), %d frames"
              % SERVER_FRAMES] = server_counts[name]

    for path, (counts, stats) in [
            ("double_attack map %d" % m, v) for m, v in tiger.items()] + [
            ("pursuit GridWorld map %d" % m, v)
            for m, v in pursuit_worlds.items()] + [
            ("turn mode map %d, B=%d" % (m, TURN_MAPS[m][0]), v)
            for m, v in turn.items()] + list(reference_order.items()):
        for name, st in stats.items():
            rows[name]["per_call"] += st
            rows[name].setdefault("launches_by_path", {})[path] = counts[name]
    run_examples_phase(rows, f32_rate, int32_rate, device_name)
    run_sharding_phase(rows, device_name)
    run_driving_scripts(rows, device_name)
    run_split_phase(rows, card)
    print("phase 4e: %d C++ goldens matched (14 GridWorld on the card, "
          "snake_basic on the host)" % n_goldens, flush=True)
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if "--shard-rank" in sys.argv:  # one rank of phase 14 (b)
        sys.exit(shard_rank_main(sys.argv))
    sys.exit(main())
