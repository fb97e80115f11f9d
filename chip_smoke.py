"""Smoke test of the PyTorch port (dm_control_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's two CUDA sources at once (the batched Cholesky solve and
the fused scalar-chain step of ``physics/fastpath.py``, which pendulum,
cartpole, acrobot, reacher, walker and cheetah take: phase 4's goldens of
those six go through it in float64, phase 5's main paths of them launch it
once a control step and never chol_solve, and hold it against its plain
version for one control step from the state after the warm-up step, in
float32 at the path's batch and float64 at B = 256, and time it at
cartpole's and cheetah's batch beside its bound, its plain version and
``engine.step``).  It builds the batched Cholesky kernel, holds it
against its plain PyTorch version (sizes on both sides of every boundary
of the launcher's rule, its register, block and global branches, and
every nv of the ported models up to 1,370, both types, a
shared matrix, a matrix given by its lower triangle alone, a non-SPD
system), times it at the main paths' shapes beside its bound, the plain
version and PyTorch's library calls for the same function, checks one
float64 control step of every golden (one per domain, three for
quadruped, two for manipulator and for dog) against the JAX package's
golden result, drives each main path (``suite.load_batch(domain, task)``
-> ``BatchEnv.reset`` and ``BatchEnv.step`` in float32: humanoid:run,
humanoid_CMU:run with contact compaction, lqr:lqr_6_2, quadruped:walk,
escape and fetch, finger:turn_hard, manipulator:bring_ball and
insert_peg, stacker:stack_4 and nine more at B = 1024, cartpole:swingup
at B = 8192, cheetah:run at B = 4096, dog:run and dog:fetch with the
noslip post-pass at B = ``DOG_BATCH``) and checks that every dense solve
on it went through the kernel, then compares a short rollout with and
without the kernel, and last trains PPO on the card (``rl/ppo.py``:
``init_train_state`` and ``train_step`` on cartpole:swingup at B = 2048,
T = 8 and humanoid:run at B = 512, T = 4, the JAX package's bench
batch sizes at a quarter of its rollout length; one float64 train step of
pendulum:swingup with and without the kernel), and last drives the single environment (``suite.load(domain,
task)`` -> ``Environment.reset`` and ``step``): six recorded float64
episodes of the JAX package's ``suite.load`` against the port's on the
card, humanoid:run in float32 with its rate, launches and idle share,
and humanoid:run in float64 with and without the kernel; and last the
batched manipulation path (``manipulation.load_batch(name)``): one
float64 golden step of each of its four models (reach_site, reach_duplo,
lift_brick, lift_large_box), each in float32 at B = 1024 with its rate,
launches and idle share, reach_site in float64 with and without the
kernel, and one PPO train step on reach_site; and last the batched
locomotion path: one float64 golden step of each of its four models
(BoxHead soccer 1 and 2 a side, ``locomotion.soccer.load_batch``, the
golden's later states scoring a goal; mocap tracking with the rolling ball
and with the CMU 2020 humanoid, ``MultiClipMocapTracking`` through
``composer.compile_task``), soccer 2v2 at B = 512 and both tracking tasks
at B = 1024 in float32 with their rates, launches and idle shares, and
soccer 2v2 in float64 with and without the kernel; and last the port's
MJCF compiler (``mjcf.compile_model``, which every phase before builds
its suite models with): all 32 suite model variants compiled onto the
card in float64 and held to the JAX compiler's output checked in as
``dm_control_torch/suite/assets/*.npz`` (the compiler's fields equal,
``set_const``'s within 1e-10 of each field's largest entry), a sphere
dropped on a plane built with ``Physics.from_xml_string`` (500 steps on
the card, at rest at its radius), and cartpole:three_poles with 5 poles,
a model no file holds, at B = 8192 in float32 with its rate, launches,
idle share and peak memory; and last composer's host path
(``manipulation.load(name)`` -> the entities' MJCF trees compiled by the
port -> ``composer.Environment.reset`` and ``step``): four recorded
float64 host episodes of the JAX package's ``manipulation.load`` replayed
on the card one control step at a time, the 11 distinct manipulation
entity trees compiled onto the card (the four with reference files held
to them), stack_3_bricks_features in float32 with its rate, launches,
idle share and the observation updater's host time, and the five-brick
reassembly (nv 39) in float64 with and without the kernel; and last
locomotion's host path (``soccer.load`` and the tracking tasks through
``composer.Environment``, their entity trees compiled by the port): four
recorded float64 host episodes of the JAX package's (soccer one a side
on its drawn pitch, two a side on a fixed pitch, ball and CMU 2020
tracking) replayed on the card one control step at a time, the four
locomotion trees held to their reference files, ``soccer.load()`` (2v2,
a pitch drawn and compiled every episode) in float32 with its rate,
launches, idle share, updater time, contact scans and recompile, and CMU
2020 tracking (nv 62) in float64 with and without the kernel; and last
locomotion's example environments (``locomotion.examples.basic``: the
CMU 2019 humanoid and the rat in corridors, on a floor, in mazes and in
the bowl, their trees compiled by the port): each of the nine in float32
with its compile time, candidate contacts, rate, launches and idle
share, four recorded float64 host episodes of the JAX package's examples
replayed on the card one control step at a time, and the rat (nv 73) in
float32 and float64 with and without the kernel; and last soccer's ANT
and HUMANOID players (``soccer.load(walker_type=...)``): HUMANOID two a
side (nv 254) in float32 with its rate, launches by branch, candidates,
contact rows and idle share, the ANT two a side and HUMANOID one a side
float64 host goldens replayed one control step at a time, HUMANOID two a
side in float64 (the kernel's global branch) with and without the
kernel (the kernel's step profiled: the card's busy time and the global
kernel's share of it), and BoxHead ten a side (nv 166) in float64 on the
card; and last rendering (``dm_control_torch/rendering``: the ray caster
on the card): ``pixels.Wrapper`` over humanoid_CMU:run in float32 (a
reset and 2 control steps observed in pixels, the kernel's launches by
branch), quadruped:escape's height field box, stack_3_bricks_vision's
front_close camera at 84 x 84 with a ``MujocoCamera`` observable and an
inline mesh's k-DOP, soccer two a side with a ``MultiplayerTrackingCamera``
at 1920 x 1080 (a reset and 3 control steps), and the headless viewer on
cartpole:swingup with a click-select and a perturbation on the card: each
with its frames/s, kernels and bytes to the host a frame and peak memory,
its frames held to the port's CPU frames of the same state, and the four
recorded states of ``rendering.golden`` held to the JAX package's frames
of them; and last mocap clip files and the tracking trainer: three
walk_tiny clips written to a CMU 2020 h5 and a protobuf bank and read
back (where ``h5py`` and ``protobuf`` import), ``examples.cmu_2020_
tracking.cmu_humanoid_tracking`` on those clips in float32 with its rate,
launches by branch and idle share, and in float64 with and without the
kernel, one epoch of ``scripts.ppo_tracking`` (the trainer's policy and
update on the card, its seconds split between the environments, the
policy and the update), and ``scripts.vec_env.TorchVecEnv`` over
pendulum:swingup at B = 1024 through an autoreset; and last the
behaviour-cloning pipeline of ``scripts/``: the CEM solver at the JAX
package's defaults on cartpole:swingup in float32 (60 actions at 4
iterations a segment, one profiled iteration), one
CEM iteration of 3 control steps on humanoid:walk in float32 and one
iteration's candidate
returns in float64 with and without the kernel, ``create_dataset``
replaying the actions and seeded random ones on the card (the CEM's
return above the random actions', the HDF5 file where ``h5py``
imports), the GPT at ``train.py``'s defaults trained one epoch on it and
10 timed steps through the native loader (built by g++), a checkpoint
round trip and one traced step, ``load_model`` and
``evaluate`` on the first 40 actions with ``validate_reference_actions``,
and
``ppo_box2d``'s suite smoke; and last the engine features no suite model
declares (``tests/data/torch_features.xml``: ball joints and their
limits, WELD, CONNECT and JOINT equalities, ball, free and site transmissions,
nine sensor types): one float64 step of each start state of its JAX
recording, Euler and RK4, under the golden gate and through the kernel
against ``reference_solves()``, ``BatchEnv`` at B = 1024 in float32 with
its rate, launches by branch and idle share, and ``Physics.step`` at
B = 1 in float64; ``parallel`` at world size 1 over NCCL (a PPO train
step of the suite smoke and a BC ``Trainer`` step with the mesh equal to
one without, the mesh's env step free of NCCL kernels, the gathers of a
train step timed); and Duplo's ``measure_separation_force`` in float64
beside the JAX recording, one probe's heights through the kernel against
``reference_solves()``.  Each phase prints one line (phases 11 to 19 one
per model or item); any failure exits with a non-zero code.  The last line is a
JSON object naming the device.  Needs one CUDA device; exits with code 1
and prints no result without one.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
MAIN_BATCH = 1024
#: dog's batch: the largest of 256, 512 and 1024 whose peak device memory
#: stays under 60 GB (every candidate's rows are kept: noslip forbids
#: compaction)
DOG_BATCH = 512
#: control steps after a reset; the first is the warm-up (3 until phase 16
#: came: the script's time limit)
MAIN_STEPS = 2
PROFILE_PAD_S = 0.1  # the profiling window's margin on each side
PROFILE_ATTEMPTS = 3  # traces taken before a trace with no device event fails
#: the main paths: (domain, task, batch); cartpole and cheetah at the sizes
#: of the JAX package's bench rungs, quadruped at its rung's size.
MAIN_PATHS = (
    ("humanoid", "run", MAIN_BATCH), ("pendulum", "swingup", MAIN_BATCH),
    ("acrobot", "swingup", MAIN_BATCH), ("cartpole", "swingup", 8192),
    ("reacher", "easy", MAIN_BATCH), ("walker", "run", MAIN_BATCH),
    ("cheetah", "run", 4096), ("hopper", "hop", MAIN_BATCH),
    ("point_mass", "hard", MAIN_BATCH), ("ball_in_cup", "catch", MAIN_BATCH),
    ("quadruped", "walk", MAIN_BATCH), ("quadruped", "escape", MAIN_BATCH),
    ("quadruped", "fetch", MAIN_BATCH), ("fish", "swim", MAIN_BATCH),
    ("swimmer", "swimmer15", MAIN_BATCH),
    ("finger", "turn_hard", MAIN_BATCH),
    ("manipulator", "bring_ball", MAIN_BATCH),
    ("manipulator", "insert_peg", MAIN_BATCH),
    ("stacker", "stack_4", MAIN_BATCH),
    ("humanoid_CMU", "run", MAIN_BATCH), ("lqr", "lqr_6_2", MAIN_BATCH),
    ("dog", "run", DOG_BATCH), ("dog", "fetch", DOG_BATCH),
)
#: the task arguments of a domain (lqr's model is seeded)
TASK_KWARGS = {"lqr": {"random": 0}}
#: the golden files (tests/data/torch_<golden>_golden_f64.npz), one per
#: main path, as (golden, domain, task): named like the domain apart from
#: the other ones of quadruped, manipulator and dog, and stepping the main
#: path's task apart from swimmer's, which steps swimmer6
_OTHER_GOLDENS = {("quadruped", "escape"): "quadruped_escape",
                  ("quadruped", "fetch"): "quadruped_fetch",
                  ("manipulator", "insert_peg"): "manipulator_insert_peg",
                  ("dog", "fetch"): "dog_fetch"}
GOLDENS = tuple(
    (_OTHER_GOLDENS.get((d, t), d), d, "swimmer6" if d == "swimmer" else t)
    for d, t, _ in MAIN_PATHS)
#: phase 10: the batched locomotion path: (asset, batch) of each path
#: stepped in float32 (soccer 2v2 at the JAX package's soccer bench rung's
#: batch, tracking at its tracking rung's), and the assets held to their
#: float64 goldens (tests/data/torch_locomotion_<asset>_golden_f64.npz)
LOCO_PATHS = (("soccer_2v2", 512), ("tracking_ball", MAIN_BATCH),
              ("tracking_cmu2020", MAIN_BATCH))
LOCO_GOLDENS = ("soccer_1v1", "soccer_2v2", "tracking_ball",
                "tracking_cmu2020")
#: (B, n) the kernel is timed at: humanoid's, cartpole's, cheetah's,
#: quadruped's, stacker:stack_4's, humanoid_CMU's (and CMU tracking's),
#: dog:fetch's and dog:run's (the block kernel), the manipulation paths'
#: (reach_site's arm; the arm and a free prop), soccer 2v2's, ball
#: tracking's and phase 11's 5-pole cartpole's
TIMED_SHAPES = ((MAIN_BATCH, 27), (8192, 2), (4096, 9), (MAIN_BATCH, 22),
                (MAIN_BATCH, 20), (MAIN_BATCH, 62), (DOG_BATCH, 85),
                (DOG_BATCH, 79), (MAIN_BATCH, 9), (MAIN_BATCH, 15),
                (512, 38), (MAIN_BATCH, 8), (8192, 5))
#: (B, n, dtype) the kernel is also timed at: the single environment's
#: humanoid solve, phase 12's stack of 3 bricks (nv = 21) and reassembly
#: of 5 (nv = 39, float64 on the block kernel), and phase 13's
#: ball (8), soccer 1v1 (22), 2v2 (38) and CMU 2020 (62) on the host, and
#: phase 14's rat (73, the block kernel in both types), each in the
#: single environment's float64 and in float32 (CMU 2019's 62 in float32 is
#: phase 14's humanoid rate path), and phase 15's float64 BoxHead 10v10
#: (166, the block kernel), HUMANOID 2v2 (254: the global kernel in
#: float64, the block kernel in float32; and 4 systems of it in float64),
#: an 11v11 HUMANOID match's 1,370 (the global kernel in both types), an
#: ANT 11v11 match's 314 and a HUMANOID 3v3 match's 378 in float32 (the
#: global kernel), phase 18's CEM populations of 128: cartpole's and
#: humanoid's in float32, humanoid's float64 selfcheck, and phase 19's
#: float64 features recording (4 systems of 22) and Duplo pair (6)
TIMED_SINGLE = ((1, 27, torch.float64), (1, 27, torch.float32),
                (1, 21, torch.float64), (1, 21, torch.float32),
                (1, 39, torch.float64), (1, 39, torch.float32),
                (1, 8, torch.float64), (1, 8, torch.float32),
                (1, 22, torch.float64), (1, 22, torch.float32),
                (1, 38, torch.float64), (1, 38, torch.float32),
                (1, 62, torch.float64), (1, 62, torch.float32),
                (1, 73, torch.float64), (1, 73, torch.float32),
                (1, 166, torch.float64), (1, 254, torch.float64),
                (1, 254, torch.float32), (1, 1370, torch.float64),
                (1, 314, torch.float32), (1, 378, torch.float32),
                (1, 1370, torch.float32), (4, 254, torch.float64),
                (128, 2, torch.float32), (128, 27, torch.float32),
                (128, 27, torch.float64), (4, 22, torch.float64),
                (1, 6, torch.float64))
TOL = {torch.float32: 2e-4, torch.float64: 1e-10}
#: phase 5's fused-step check: float64 environments (the first of the
#: float32 path's state), and how much further from the float64 step than
#: the plain float32 version the float32 kernel may be where float32 itself
#: is off it by more than TOL (``phase_fast_check``)
FAST_B64 = 256
FAST_F32_FACTOR = 2.0
#: the main paths whose fused step is timed (``time_fast``): the JAX
#: package's bench rungs
FAST_TIMED = (("cartpole", "swingup"), ("cheetah", "run"))
#: the suite domains whose main path takes the fused fast path, as in the
#: JAX package's BatchEnv
FAST_DOMAINS = ("pendulum", "cartpole", "acrobot", "reacher", "walker",
                "cheetah")
#: phase 8: the single-environment episode goldens
#: (tests/data/torch_env_<domain>_<task>_f64.npz: a reset and 5 control
#: steps of the JAX package's suite.load with task_kwargs={"random": 11})
ENV_GOLDENS = (("cartpole", "swingup"), ("cheetah", "run"),
               ("humanoid", "run"), ("hopper", "hop"),
               ("manipulator", "bring_ball"), ("swimmer", "swimmer6"))
ENV_SEED = 11
SINGLE_STEPS = 2  # phase 8's float32 humanoid:run control steps (20 before
#: phase 16, 10 before phase 17, 5 before phase 18, 3 before phase 19)
#: phase 7's training paths in float32, (domain, task, batch,
#: steps_per_batch), at the batch sizes of the JAX package's ppo_train
#: and ppo_train_humanoid rungs (bench.py:162-211): 2 epochs of 4
#: minibatches (T halved since phase 16 came and again since phases 17
#: and 18, for the script's time limit: the rungs run T = 32 and 16)
TRAIN_PATHS = (("cartpole", "swingup", 2048, 4),
               ("humanoid", "run", 512, 2))
#: timed train steps per path, after one warm-up (a rollout of the host
#: paths takes 15-25 s of the script's time limit)
TRAIN_TIMED = 1
#: phase 9: the batched manipulation path (``manipulation.load_batch``):
#: (asset, task) of each distinct physics, stepped in float32 at
#: MANIP_BATCH (the JAX package's manipulation bench rung's batch) and
#: held to its float64 golden
#: (tests/data/torch_manipulation_<asset>_golden_f64.npz)
MANIP_PATHS = (("reach_site", "reach_site_features"),
               ("reach_duplo", "reach_duplo_features"),
               ("lift_brick", "lift_brick_features"),
               ("lift_large_box", "lift_large_box_features"))
MANIP_BATCH = MAIN_BATCH
#: (task, batch, steps; 8 steps before phase 16 came, 4 before phase 17, 2
#: before phase 18)
MANIP_TRAIN = ("reach_site_features", 256, 1)
#: phase 11: a model no reference file holds, stepped at the headline
#: batch: (domain, task, task arguments, batch)
COMPILE_PATH = ("cartpole", "three_poles", {"num_poles": 5}, 8192)
RECIPE_STEPS = 350  # the dropped sphere's steps (at rest from ~320)
#: phase 11's gate: each ``set_const`` field's largest deviation from the
#: reference over the field's largest entry; every other field is exact
SET_CONST_REL = 1e-10
#: phase 12: composer's host path (``manipulation.load``).  The host
#: episode goldens (tests/data/torch_manipulation_env_<name>_f64.npz: a
#: reset and 3 control steps of the JAX package's manipulation.load with
#: seed 11), replayed one control step at a time
HOST_GOLDENS = ("reach_site_features", "lift_large_box_features",
                "place_cradle_features",
                "stack_3_bricks_random_order_features")
HOST_SEED = 11
#: the 11 distinct entity trees of the 25 names, as (tree, a name that
#: builds it); a tree named like a file of dm_control_torch/manipulation/
#: assets/ is held to that reference
HOST_TREES = (("reach_site", "reach_site_features"),
              ("reach_duplo", "reach_duplo_features"),
              ("lift_brick", "lift_brick_features"),
              ("lift_large_box", "lift_large_box_features"),
              ("place_brick", "place_brick_features"),
              ("place_cradle", "place_cradle_features"),
              ("stack_2_fixed", "stack_2_bricks_features"),
              ("stack_3_fixed", "stack_3_bricks_features"),
              ("stack_2_free", "stack_2_bricks_moveable_base_features"),
              ("stack_3_free", "stack_2_of_3_bricks_random_order_features"),
              ("stack_5_free", "reassemble_5_bricks_random_order_features"))
#: the float32 rate path: (name, control steps after the reset; 2 since
#: phase 18 came, 3 since phase 17, 5 since phase 16, 10 before)
HOST_RATE = ("stack_3_bricks_features", 2)
#: the float64 selfcheck, kernel against ``reference_solves()``: (name,
#: seed, control steps after the reset); nv = 39 runs the block kernel in
#: float64.  The seed's episode is one where a
#: change of one rounding in every solve moves no observation by more than
#: 2e-13 of its scale (a nudge on the CPU, ``PERF.md`` §6)
HOST_SELFCHECK = ("reassemble_5_bricks_random_order_features", 7, 1)
#: its gate: the reward's and every observation's largest difference,
#: absolute, except the observations named next
HOST_SELFCHECK_TOL = 1e-10
#: the observations held to ``HOST_SELFCHECK_TOL`` of their scale, their
#: largest entry in the episode: the Jaco's joint torque sensors reach
#: 5.9e4 there, where 1e-10 absolute is 14 roundings (ROADMAP C)
HOST_SELFCHECK_SCALED = ("arm/joints_torque",)
#: phase 13: locomotion's host path (``soccer.load``, tracking through
#: ``composer.Environment``).  The host episode goldens
#: (tests/data/torch_locomotion_env_<name>_f64.npz: a reset and 3 control
#: steps of the JAX package's environment with random_state 11: soccer one
#: a side on its randomized pitch, two a side on a fixed (12, 9) pitch with
#: the field box, ball and CMU 2020 tracking), replayed one control step at
#: a time
LOCO_HOST_GOLDENS = ("soccer_1v1", "soccer_2v2_fixed", "tracking_ball",
                     "tracking_cmu2020")
LOCO_HOST_SEED = 11
#: the locomotion entity trees held to dm_control_torch/locomotion/assets/
LOCO_TREES = ("soccer_1v1", "soccer_2v2", "tracking_ball",
              "tracking_cmu2020")
#: the float32 rate path, ``soccer.load()`` (2 a side on a randomized
#: pitch): control steps after the reset (10 before phase 16, 5 before
#: phase 17, 3 before phase 18)
LOCO_RATE_STEPS = 2
#: the float64 selfcheck, kernel against ``reference_solves()``: (asset,
#: seed, control steps after the reset); nv = 62 runs the block kernel in
#: float64.  Seed 2's episode is one where a change
#: of one rounding in every solve moves no observation by more than
#: 7.2e-16 of max(1, its largest entry) (a nudge on the CPU, seeds 0-11)
LOCO_SELFCHECK = ("tracking_cmu2020", 2, 1)
#: its gate: the reward within this, absolute; each observation within
#: this times max(1, its largest |entry| in the episode)
LOCO_SELFCHECK_TOL = 1e-10
#: phase 14, locomotion's example environments
#: (``locomotion.examples.basic.<name>`` through ``composer.Environment``,
#: the CMU 2019 humanoid and the rat on corridors, a floor, mazes and the
#: bowl): each in float32, a reset and this many control steps
LOCO_EXAMPLES = ("cmu_humanoid_run_walls", "cmu_humanoid_run_gaps",
                 "cmu_humanoid_go_to_target", "cmu_humanoid_maze_forage",
                 "cmu_humanoid_heterogeneous_forage", "rodent_escape_bowl",
                 "rodent_run_gaps", "rodent_maze_forage", "rodent_two_touch")
#: the last of them profiled; with one, the rate is the profiled step's
#: wall time (2 until phase 16 came: the script's time limit)
LOCO_EXAMPLE_STEPS = 1
#: the examples' host episode goldens (tests/data/torch_locomotion_env_
#: <name>_f64.npz: a reset and 3 control steps of the JAX package's
#: example with numpy's global state and random_state seeded with 11),
#: replayed one control step at a time
LOCO_EXAMPLE_GOLDENS = ("cmu_humanoid_run_gaps", "cmu_humanoid_maze_forage",
                        "rodent_escape_bowl", "rodent_two_touch")
#: the rat's selfcheck (nv = 73: the block kernel in both types), kernel
#: against ``reference_solves()``: (golden, the recorded timesteps whose
#: state and action each control step starts from)
LOCO_EXAMPLE_SELFCHECK = ("rodent_two_touch", (1,))
#: its float32 gate: observations, reward and state (qpos, qvel) within
#: this times max(1, their largest |entry|).  A change of one float32
#: rounding in every solve moves them by at most 6.8e-7 of that scale (a
#: nudge on the CPU from this state and the reset's; float64: 4.5e-15,
#: under the 1e-9 absolute of phases 9 and 10, which the float64 run
#: keeps)
LOCO_EXAMPLE_F32_TOL = 1e-4
#: phase 15, soccer's ANT and HUMANOID players (``soccer.load(walker_type=
#: ...)``) and the matches past the block kernel's first cap of 160: the
#: float32 rate path, HUMANOID two a side on the pitch drawn from the
#: humanoids' areas (nv 254, the block kernel in float32), a reset and
#: ``LOCO_EXAMPLE_STEPS`` control steps
WALKER_RATE = ("soccer humanoid 2v2",
               {"team_size": 2, "walker_type": "humanoid"})
#: the host episode goldens of ANT two a side on a fixed (12, 9) pitch and
#: HUMANOID one a side on its drawn pitch (``tools/export_torch_assets.py
#: loco_walker_goldens``), replayed one control step at a time
WALKER_GOLDENS = ("soccer_ant_2v2", "soccer_humanoid_1v1")
#: the float64 selfcheck, kernel against ``reference_solves()``: HUMANOID
#: two a side (nv 254, the global kernel in float64), one control step
#: from the reset's state; gate 1e-9 absolute, as phases 9, 10 and 14
#: (no recording holds this match, so there is no recording to hold a
#: plain step that is off to)
WALKER_SELFCHECK = {"team_size": 2, "walker_type": "humanoid"}
#: BoxHead ten a side (nv 166: the block kernel, over its first cap) in
#: float64 on its drawn pitch: a reset and one control step
LARGE_MATCH = {"team_size": 10}
#: phase 16, rendering: (a)'s control steps (humanoid_CMU:run through
#: ``pixels.Wrapper``), (d)'s (soccer two a side with a tracking camera),
#: (e)'s frames (the viewer on cartpole:swingup), the frames each item
#: times after a warm-up, and the bytes a frame may copy to the host
#: besides its image
RENDER_STEPS = 2  # 10 before phase 17, 5 before 18, 3 before 19
RENDER_SOCCER_STEPS = 2
VIEWER_FRAMES = 4
RENDER_TIMED_FRAMES = 3
#: phase 17 (a): the clip files' walk_tiny ids (of the CMU 2020 h5's name)
#: and their synthetic clips' frames
MOCAP_IDS = ("CMU_016_22", "CMU_047_01", "CMU_069_01")
MOCAP_FRAMES = 60
#: phase 17 (b): float32 control steps of cmu_humanoid_tracking; (c): the
#: float64 selfcheck's control steps and gate (of max(1, the scale)); 5
#: float32 steps before phase 18
MOCAP_STEPS = 2
MOCAP_SELFCHECK_STEPS = 1
MOCAP_SELFCHECK_TOL = 1e-10
#: phase 17 (d): one ppo_tracking epoch (4 env steps an environment; 16
#: until the first whole run put phase 17 at 66.4 s of its 60, 8 until
#: phase 18 came)
PPO_TRACKING_ARGS = ("--n_envs=2", "--steps_per_epoch=8", "--max_epochs=1",
                     "--seed=0")
#: phase 17 (e): TorchVecEnv over pendulum:swingup, episodes of 3 control
#: steps, stepped 4 times (the fourth starts the next episodes)
VEC_ENV_BATCH = 1024
VEC_ENV_EPISODE = 3
RENDER_D2H_SLACK = 4096
#: phase 18 (a): the CEM solver at the JAX package's defaults (population
#: 128, segments of 20, 10% elites) on cartpole:swingup in float32, 60
#: control steps (3 segments), 4 iterations a segment (the default 8 took
#: 74.8 s on the card: a batched control step of cartpole is ~6,700
#: kernel launches); its actions, replayed by (c), must beat seeded
#: uniform random actions by more than the JAX package's test margin
CEM_STEPS = 60
CEM_ITERATIONS = 4
CEM_MARGIN = 0.5
#: (b): one CEM iteration on humanoid:walk at the defaults in float32 over
#: segments of 3 control steps (20 took 15.6 s on the card; 5 before
#: phase 19), and one iteration's candidate returns over 3 control steps in
#: float64 through the kernel and under ``reference_solves()``
CEM_HUMANOID_STEPS = 3
CEM_SELFCHECK_STEPS = 3
CEM_SELFCHECK_TOL = 1e-10
#: (d): the GPT at ``scripts/train.py``'s defaults, a batch of 64 blocks;
#: 10 timed steps (20 before phase 19) over a synthetic dataset of
#: cartpole's widths (20
#: episodes of 100 steps: 1,940 blocks of 4) through the native loader
BC_BATCH = 64
BC_TIMED_STEPS = 10
BC_SYNTHETIC_EPISODES = (20, 100)
BC_WORKERS = 2
#: (e): ``comprehensive_eval``'s default context, over (a)'s first 40
#: actions (8 steps of the policy's own actions after the context)
BC_CONTEXT_STEPS = 32
BC_EVAL_STEPS = 40
#: (f): ``ppo_box2d``'s suite smoke
PPO_BOX2D_ARGS = ("--updates=3", "--batch=256")
#: (c)'s mesh: an octahedron (a k-DOP of 26 planes) before a fixed camera
#: phase 19's engine-features model: the float32 BatchEnv path's control
#: steps after the reset (5 substeps each), the float64 Physics.step
#: path's steps, and the selfcheck's gate (of max(1, scale))
FEATURES_STEPS = 3
FEATURES_CONTROL_DT = 0.02
FEATURES_PHYSICS_STEPS = 10
FEATURES_SELFCHECK_TOL = 1e-10
#: phase 19's mesh of one rank over NCCL: the PPO suite smoke's settings
#: (``scripts/ppo_box2d.py::run_suite_smoke``), one train step, and the
#: BC trainer's FFNet; with and without the mesh equal within this
MESH_PPO_BATCH = 256
MESH_TOL = 1e-6
#: phase 19's Duplo pair: ``measure_separation_force``'s arguments and
#: the probe whose heights are held (``tools/export_torch_assets.py``'s
#: ``DUPLO_ARGS`` and ``DUPLO_PROBE_FORCE``, the JAX recording's)
DUPLO_ARGS = dict(min_force=512.0, max_force=1024.0, tolerance=8.0,
                  time_limit=0.01)
DUPLO_PROBE_FORCE = 900.0
DUPLO_TOL = 1e-9

MESH_XML = """
<mujoco>
  <asset>
    <mesh name="octa" vertex="0.3 0 0  -0.3 0 0  0 0.3 0  0 -0.3 0
                              0 0 0.3  0 0 -0.3"/>
  </asset>
  <worldbody>
    <geom name="octa" type="mesh" mesh="octa" pos="0 0 1" rgba=".2 .8 .2 1"
          contype="0" conaffinity="0"/>
    <camera name="front" pos="0 -3 1" quat="0.7071068 0.7071068 0 0"/>
  </worldbody>
</mujoco>
"""


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def ptxas_kernels(report: str) -> list:
    """Each kernel's registers, stack and spills from nvcc's ``-Xptxas -v``
    report, named by branch (or ``fastpath_step``) and type
    (``global<double>``)."""
    out, name = [], None
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            branch = next((b for b in ("reg", "block", "global")
                           if f"chol_solve_{b}_kernel" in mangled),
                          "fastpath_step" if "fastpath_step_kernel" in mangled
                          else mangled)
            kind = "double" if "IdL" in mangled or "IdE" in mangled else \
                "float"
            cols = "Li2E" in mangled and ", 2 columns" or ""
            name, stack = f"{branch}<{kind}{cols}>", ""
        elif "bytes stack frame" in ln:
            stack = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            regs = ln.split("Used", 1)[1].split(",")[0].strip()
            out.append(f"{name}: {regs}, {stack}")
            name = None
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


#: n on both sides of every boundary of the launcher's rule (32, and 64 in
#: float32; the block kernel's last, 202 in float64 and 303 in float32) and
#: of the block kernel's panels (64/65, 96/97, 128/129), and every ported
#: nv (soccer 10v10 and 11v11: 166, 182; HUMANOID 2v2: 254; 11v11: 1,370),
#: and on the global kernel fewer chunks of 32 rows below the first panel
#: than a cluster has CTAs (230), ANT 11v11 (314) and HUMANOID 3v3 (378)
KERNEL_NS = (1, 2, 3, 4, 7, 8, 9, 11, 13, 14, 15, 17, 20, 21, 22, 27, 28, 31,
             32, 33, 39, 40, 62, 63, 64, 65, 73, 79, 85, 96, 97, 128, 129,
             160, 166, 182, 202, 203, 230, 254, 303, 304, 314, 378, 1370)
#: 1001 fills no block of 4 warps evenly; 4 and 512 are the block kernel's
#: small batches and dog's
KERNEL_BS = (1, 4, 512, 1001, 1024)
#: from this n on, the batches of KERNEL_BS_LARGE only (a matrix of 1,370
#: takes 15 MB in float64)
LARGE_N = 304
KERNEL_BS_LARGE = (1, 4)
SHARED_NS = (27, 32, 33, 64, 65, 73, 85, 160)
LOWER_NS = (27, 32, 33, 64, 65, 73, 85, 160, 254)
NON_SPD_NS = (27, 62, 73, 79, 85, 160, 254)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FLOAT32_FLOPS = 67e12      # H100 SXM, outside the tensor cores
#: H100 SXM data sheet: float64 on the tensor cores (DMMA); outside them
#: the card does half of it, 34e12, but the bound takes the card's peak
FLOAT64_FLOPS = 67e12
PEAK_FLOPS = {torch.float32: FLOAT32_FLOPS, torch.float64: FLOAT64_FLOPS}


def spd(gen, b, n, dtype):
    q = torch.randn(b, n, n, generator=gen, dtype=torch.float64,
                    device="cuda")
    a = q @ q.transpose(-1, -2) + n * torch.eye(n, dtype=torch.float64,
                                                device="cuda")
    return a.to(dtype)


def randn(gen, shape, dtype):
    return torch.randn(*shape, generator=gen, dtype=torch.float64,
                       device="cuda").to(dtype)


def time_ms(fn, reps=30):
    """Median milliseconds per call over ``reps`` CUDA-event timings."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def profiled(fn, what):
    """The card's kernels, memory copies and sets while ``fn`` runs once
    under ``torch.profiler`` (the card's activity alone, read from the
    profiler's raw events: turning a manipulation step's ~190,000 kernels
    into ``prof.events()`` takes longer than the step, and recording the
    host's activity too lengthens it), and the wall seconds of ``fn``.

    The profiler keeps a device record only if its time stamp lies in the
    profiling window, and on an H100 host the card's stamps were seen up
    to 12 ms before their launch's, so the window opens ``PROFILE_PAD_S``
    before ``fn`` and closes as long after it.  A trace that holds no
    device event is taken again, ``fn`` with it, up to
    ``PROFILE_ATTEMPTS`` times, each miss reported on stderr."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(PROFILE_PAD_S)
        events = list(prof.profiler.kineto_results.events())
        # the enum compared as it is: its string, made for each of a rat
        # control step's ~585,000 events, took 3.9 s on the card's host
        device = [e for e in events if e.device_type() == DeviceType.CUDA]
        if device:
            return device, wall
        print(f"chip_smoke: torch.profiler saw no device event in {what} "
              f"(attempt {attempt} of {PROFILE_ATTEMPTS}; {len(events)} "
              f"host events, {wall * 1e3:.1f} ms)", file=sys.stderr,
              flush=True)
    check(False, f"torch.profiler saw no kernel on the device in {what} "
                 f"({PROFILE_ATTEMPTS} attempts)")


def device_ms(fn, what, calls=50):
    """Device milliseconds per call of ``fn`` from ``torch.profiler``."""
    def calls_of_fn():
        for _ in range(calls):
            fn()

    events, _ = profiled(calls_of_fn, what)
    return sum(e.duration_ns() for e in events) / 1e6 / calls


BURST_GAP_S = 0.05  # the pause between the bursts of one profiled session


def device_ms_each(fns, what, calls=50):
    """``device_ms`` of each of ``fns`` from one profiled session (a
    session costs more than the calls it times): each runs ``calls`` times
    in a burst, ``BURST_GAP_S`` after the one before, and the device events
    are split at the widest gaps between one event's end and the next
    one's start.  Where those gaps are not clearly the pauses, each is
    profiled alone."""
    def bursts():
        for i, fn in enumerate(fns):
            if i:
                torch.cuda.synchronize()
                time.sleep(BURST_GAP_S)
            for _ in range(calls):
                fn()

    events, _ = profiled(bursts, what)
    events.sort(key=lambda e: e.start_ns())
    gap = {i: events[i].start_ns() - events[i - 1].end_ns()
           for i in range(1, len(events))}
    cuts = sorted(sorted(gap, key=gap.get)[len(gap) - len(fns) + 1:])
    if len(cuts) != len(fns) - 1 or any(
            gap[i] < 0.5e9 * BURST_GAP_S for i in cuts):
        return [device_ms(fn, what, calls) for fn in fns]
    bounds = [0, *cuts, len(events)]
    return [sum(e.duration_ns() for e in events[a:b]) / 1e6 / calls
            for a, b in zip(bounds, bounds[1:])]


def check_branch(linalg, what, model, launches, branch_launches):
    """Every solve of a path is one system of the model's nv, so all of its
    launches take the branch that (nv, type) names: ``branch_launches``
    (launches by branch) holds ``launches`` there and 0 elsewhere."""
    branch = linalg.kernel_branch(model.nv, model.dtype)
    want = {k: (launches if k == branch else 0) for k in branch_launches}
    check(branch_launches == want,
          f"{what}: chol_solve launches by branch {branch_launches} of "
          f"{launches}; nv = {model.nv} in {model.dtype} names the "
          f"{branch} kernel")


def reset_counts(linalg):
    """Sets every kernel's launch count to 0: chol_solve's (by branch) and
    the fused fast path's."""
    from dm_control_torch.physics import fastpath

    linalg.reset_launch_counts()
    fastpath.reset_launch_count()


def fast_launches() -> int:
    """The fused fast path's kernel launches since the count was set to 0."""
    from dm_control_torch.physics import fastpath

    return fastpath.fastpath_step_cuda.launches


def takes_fast(env) -> bool:
    """Whether a BatchEnv runs its steps through the fused fast path."""
    return getattr(env, "_fast", None) is not None


def check_fast(linalg, what, fast, control_steps, resets=0, settle=False):
    """A path through the fused fast path: no chol_solve launch, and one
    fast-path launch a control step (and one a reset with settle steps;
    an autoreset's reset may add one more a step).  Returns the fast-path
    launches."""
    check(linalg.chol_solve.launches == 0,
          f"{what}: chol_solve launched {linalg.chol_solve.launches} times "
          f"on a fast-path path")
    low = control_steps + (resets if settle else 0)
    high = low + (control_steps if settle else 0)
    check(low <= fast <= high,
          f"{what}: the fast path launched {fast} times in {control_steps} "
          f"control steps and {resets} resets (settle steps: {settle}); "
          f"expected {low}..{high}")
    return fast


class PlainFast:
    """A BatchEnv's fused step sent to its plain version on the card, to
    hold a path through the kernel against the same path without it."""

    def __init__(self, fast):
        self.fast = fast
        self.fk_observe_ok = fast.fk_observe_ok
        self.fk_fields = fast.fk_fields

    def __call__(self, qpos, qvel, warm, ctrl, n_steps=1):
        return self.fast.plain(qpos, qvel, warm, ctrl, n_steps)


@contextlib.contextmanager
def plain_version(linalg, env):
    """Within this block ``env`` runs without the kernels: its fused step
    through the plain version where it takes the fast path, its dense
    solves under ``reference_solves()`` otherwise."""
    if not takes_fast(env):
        with linalg.reference_solves():
            yield
        return
    fast = env._fast
    env._fast = PlainFast(fast)
    try:
        yield
    finally:
        env._fast = fast


def check_close(x, ref, dtype, what):
    err = (x - ref).abs() - TOL[dtype] * ref.abs()
    check(bool(torch.isfinite(x).all()), f"non-finite x at {what}")
    check(bool((err <= TOL[dtype]).all()),
          f"kernel != plain at {what}: max |dx| "
          f"{float((x - ref).abs().max()):.3e}")
    return float((x - ref).abs().max())


def phase_kernel(linalg):
    """Kernel against plain version over sizes on both sides of every
    boundary of the launcher's rule, both types, a shared matrix, a matrix
    given by its lower triangle alone and one non-SPD system; returns
    the largest |dx| per type."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    for dtype in (torch.float32, torch.float64):
        for n in KERNEL_NS:
            batches = KERNEL_BS if n < LARGE_N else KERNEL_BS_LARGE
            a_all = spd(gen, max(batches), n, dtype)
            rhs_all = randn(gen, (max(batches), n), dtype)
            for b in batches:
                a, rhs = a_all[:b], rhs_all[:b]
                x = linalg.chol_solve_cuda(a, rhs)
                torch.cuda.synchronize()
                worst[dtype] = max(worst[dtype], check_close(
                    x, linalg.chol_solve_reference(a, rhs), dtype,
                    f"n={n} B={b} {dtype}"))
        # one (n, n) matrix shared by the batch: read with a batch stride
        # of 0, directly and as an expanded view through the dispatcher
        for n in SHARED_NS:
            a = spd(gen, 1, n, dtype)[0]
            rhs = randn(gen, (1001, n), dtype)
            ref = linalg.chol_solve_reference(a.expand(1001, n, n), rhs)
            worst[dtype] = max(worst[dtype], check_close(
                linalg.chol_solve_cuda(a, rhs), ref, dtype,
                f"shared matrix n={n} {dtype}"))
            check_close(linalg.chol_solve(a.expand(1001, n, n), rhs), ref,
                        dtype, f"expanded shared matrix n={n} {dtype}")
        # only the lower triangle is the input, as for the plain version:
        # what stands above the diagonal must not reach x
        for n in LOWER_NS:
            a = spd(gen, 1001, n, dtype)
            rhs = randn(gen, (1001, n), dtype)
            ref = linalg.chol_solve_reference(a, rhs)
            junk = a.tril() + randn(gen, (1001, n, n), dtype).triu(1)
            check_close(linalg.chol_solve_reference(junk, rhs), ref, dtype,
                        f"plain version, lower triangle only n={n} {dtype}")
            worst[dtype] = max(worst[dtype], check_close(
                linalg.chol_solve_cuda(junk, rhs), ref, dtype,
                f"lower triangle only n={n} {dtype}"))
        # one system that is not SPD inside a batch: NaN in that row only
        for n in NON_SPD_NS:
            a = spd(gen, 1001, n, dtype)
            a[17] = -a[17]
            rhs = torch.ones(1001, n, dtype=dtype, device="cuda")
            x = linalg.chol_solve_cuda(a, rhs)
            ref = linalg.chol_solve_reference(a, rhs)
            torch.cuda.synchronize()
            nan_rows = torch.isnan(x).any(-1).nonzero().flatten().tolist()
            check(nan_rows == [17] and bool(torch.isnan(x[17]).all()),
                  f"non-SPD system n={n} {dtype}: NaN rows {nan_rows}, "
                  f"expected [17]")
            check(torch.isnan(ref[17]).all(),
                  "plain version lost the NaN row")
            keep = torch.arange(1001, device="cuda") != 17
            check(bool(torch.allclose(x[keep], ref[keep], rtol=TOL[dtype],
                                      atol=TOL[dtype])),
                  f"non-SPD system disturbed other rows (n={n} {dtype})")

    return worst


def time_shape(linalg, batch, n, dtype=torch.float32):
    """The kernel at one main-path shape: its error, and its time per call
    by CUDA events beside the bound, the plain version and the library
    calls; with the kernel's and the two library calls' functions on this
    shape's inputs, for ``time_shapes`` to time on the device.  A stays
    warm in L2 between calls, as on the main path, where the product that
    writes H runs just before the solve."""
    gen = torch.Generator(device="cuda").manual_seed(n)
    a = spd(gen, batch, n, dtype)
    rhs = randn(gen, (batch, n), dtype)
    err = check_close(linalg.chol_solve_cuda(a, rhs),
                      linalg.chol_solve_reference(a, rhs), dtype,
                      f"timed shape B={batch} n={n} {dtype}")

    def library(a, rhs):
        return torch.linalg.solve(a, rhs)

    def library_cholesky(a, rhs):
        factor, _ = torch.linalg.cholesky_ex(a)
        return torch.cholesky_solve(rhs.unsqueeze(-1), factor).squeeze(-1)

    lib_err = float((library(a, rhs)
                     - linalg.chol_solve_reference(a, rhs)).abs().max())
    check(lib_err <= TOL[dtype], f"library call != plain: {lib_err}")
    fns = {"ms": linalg.chol_solve_cuda, "plain_ms":
           linalg.chol_solve_reference, "library_ms": library,
           "library_cholesky_ms": library_cholesky}
    runs = {k: [] for k in fns}
    for order in (list(fns), list(reversed(fns))):  # in turns
        for k in order:
            runs[k].append(time_ms(lambda: fns[k](a, rhs)))
    # the function's input is the lower triangle of a (as for the plain
    # version), so the bound counts its bytes, b and x at the rate of device
    # memory; an a that is warm in L2 comes at a higher rate, so the true
    # floor is lower still.  The dense a is kept beside it.
    width = torch.finfo(dtype).bits // 8
    byte_ms = (1e3 * width * batch * (n * (n + 1) // 2 + 2 * n)
               / HBM_BYTES_PER_S)
    dense_ms = 1e3 * width * batch * (n * n + 2 * n) / HBM_BYTES_PER_S
    flop_ms = 1e3 * batch * (n ** 3 / 3 + 2 * n * n) / PEAK_FLOPS[dtype]
    out = {k: min(v) for k, v in runs.items()}
    out.update(B=batch, n=n, dtype=str(dtype).replace("torch.", ""),
               branch=linalg.kernel_branch(n, dtype),
               max_abs_err=err, bound_ms=max(byte_ms, flop_ms),
               dense_bound_ms=max(dense_ms, flop_ms),
               bound_by="bytes" if byte_ms >= flop_ms else "operations",
               runs=runs)
    return out, [lambda: linalg.chol_solve_cuda(a, rhs),
                 lambda: library(a, rhs), lambda: library_cholesky(a, rhs)]


def time_shapes(linalg, shapes):
    """``time_shape`` at each (B, n, type) of ``shapes``, with the device
    milliseconds of the kernel and of the two library calls at each, all
    from one profiled session (a session costs more than the calls it
    times)."""
    timed = [time_shape(linalg, *shape) for shape in shapes]
    device = device_ms_each(
        [fn for _, fns in timed for fn in fns],
        "chol_solve, torch.linalg.solve and cholesky_ex + cholesky_solve at "
        "phase 3's timed shapes")
    keys = ("device_ms", "library_device_ms", "library_cholesky_device_ms")
    for i, (out, _) in enumerate(timed):
        out.update(zip(keys, device[3 * i:3 * i + 3]))
    return [out for out, _ in timed]


def phase_golden(suite, linalg, name, domain, task, env=None):
    """One float64 control step from the golden's start states (after a
    reset, and some steps later: on the floor, the string taut, the ball at
    rest, the feet loaded) with the golden's per-episode model overrides,
    against JAX, through the golden gate (``rl/golden.py``: qacc_warmstart
    within ``REL_GATE`` of its largest recorded entry, every other key
    within ``ABS_GATE``).  Returns the largest absolute deviation of any
    key with its name, and the gate's two figures."""
    from dm_control_torch.rl import golden

    with np.load(os.path.join(ROOT, "tests", "data",
                              f"torch_{name}_golden_f64.npz"),
                 allow_pickle=False) as z:
        gold = {k: z[k] for k in z.files}
    if env is None:
        env = suite.load_batch(domain, task, device="cuda",
                               dtype=torch.float64, autoreset=False,
                               task_kwargs=TASK_KWARGS.get(domain))
    errs, rest, rel = {}, 0.0, 0.0
    reset_counts(linalg)
    for p in golden.PREFIXES:
        one = golden.step_errors(env, gold, p)
        errs.update({f"{p}_{k}": v for k, v in one.items()})
        r, q = golden.gate_figures(one, gold, p)
        rest, rel = max(rest, r), max(rel, q)
    worst = max(errs, key=errs.get)
    check(rest <= golden.ABS_GATE and rel <= golden.REL_GATE,
          f"golden mismatch in {name}: all but qacc_warmstart {rest:.3e} "
          f"(<= {golden.ABS_GATE}), qacc_warmstart {rel:.3e} of its scale "
          f"(<= {golden.REL_GATE}); largest {worst} {errs[worst]:.3e}")
    check(all(errs[f"{p}_{k}"] == 0 for p in golden.PREFIXES
              for k in ("discount", "step_type")),
          f"golden discount or step type mismatch in {name}")
    if takes_fast(env):  # each recorded step through the fused kernel
        check_fast(linalg, f"golden {name}", fast_launches(),
                   len(golden.PREFIXES))
    return errs[worst], worst, rest, rel, fast_launches()


def min_solves_per_substep(env):
    """The fewest dense solves one substep of this model makes: per
    ``forward`` (four under RK4) one ``solve_m`` and, where the model has
    constraint rows, at least one Newton direction; under Euler with joint
    damping (the model's, or the task's per-episode one) one more for the
    implicit step."""
    from dm_control_torch.physics import constraints, engine
    from dm_control_torch.physics.model import make_data

    m = env.model
    d = engine.fwd_velocity(m, engine.fwd_position(m, make_data(m, 1)))
    rows = constraints.make_constraint(m, d).nefc
    rk4 = m.opt.integrator == 1
    per_forward = 1 + (1 if rows else 0)
    if rk4:
        return 4 * per_forward
    damping = env.task.initial_model_diff(m).get("dof_damping",
                                                 m.dof_damping)
    return per_forward + (1 if bool((damping != 0).any()) else 0)


def rewards_in_unit_range(domain):
    """The suite's check of a path's rewards (steps, B): within [0, 1], or
    at most 1 for lqr, whose reward is 1 less a quadratic cost."""
    low = -float("inf") if domain == "lqr" else 0.0

    def check_rewards(r):
        return (bool(((r >= low) & (r <= 1)).all()),
                f"reward outside [{low}, 1]")
    return check_rewards


def phase_main(suite, linalg, solver, domain, task, batch, env=None,
               profile=False, check_rewards=None, inspect=None):
    """``reset`` and MAIN_STEPS control steps of one main path in float32,
    with the kernel's launch count (and the noslip sweep's slot count) set
    to 0 just before and read just after; ``env``: the path's env where it
    is not ``suite.load_batch(domain, task)``'s; ``check_rewards``: a
    function of the stacked finite rewards that returns (ok, what it
    holds), by default ``rewards_in_unit_range``; ``inspect(env, state)``
    is read after the reset and after the last step.  With ``profile``,
    one more control step under ``torch.profiler`` after the counts are
    read: its device kernels and the card's idle share."""
    from dm_control_torch.physics import engine

    if env is None:
        env = suite.load_batch(domain, task, device="cuda",
                               dtype=torch.float32,
                               task_kwargs=TASK_KWARGS.get(domain))
    gen = torch.Generator(device="cuda").manual_seed(0)
    act_gen = torch.Generator(device="cuda").manual_seed(1)
    nu = env.model.nu
    min_solves = min_solves_per_substep(env)

    def actions():
        return 2.0 * torch.rand(batch, nu, generator=act_gen,
                                device="cuda") - 1.0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(linalg)
    solver.noslip.slots = 0
    t0 = time.perf_counter()
    state, ts = env.reset(batch, gen)
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    reset_launches = linalg.chol_solve.launches
    fast = takes_fast(env)
    reset_fast = fast_launches()
    seen = {} if inspect is None else {"reset": inspect(env, state)}
    step_times = []
    diverged = 0
    rewards = []
    after_warmup = None
    for i in range(MAIN_STEPS):
        t0 = time.perf_counter()
        state, ts = env.step(state, actions())
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t0)
        if i == 0 and fast:
            after_warmup = state
        # divergence, not a termination with discount 0 (a goal, a fall)
        diverged += int(engine.check_divergence(env.model,
                                                state.data).sum())
        rewards.append(ts.reward)
        check(all(bool(torch.isfinite(v).all())
                  for v in ts.observation.values()),
              f"{domain}: non-finite observation at step {i}")
    launches = linalg.chol_solve.launches
    branch_launches = dict(linalg.chol_solve.branch_launches)
    total_fast = fast_launches()
    check_branch(linalg, f"{domain}:{task}", env.model, launches,
                 branch_launches)
    noslip_slots = solver.noslip.slots
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if inspect is not None:
        seen["steps"] = inspect(env, state)
    what = f"{domain}:{task} B={batch}"
    check(all(v.device.type == "cuda" for v in ts.observation.values()),
          f"{what}: observation left the card")
    r = torch.stack(rewards)
    check(bool(torch.isfinite(r).all()), f"{what}: non-finite reward")
    ok, holds = (check_rewards or rewards_in_unit_range(domain))(r)
    check(ok, f"{what}: {holds}")
    share = diverged / (batch * MAIN_STEPS)
    substeps = MAIN_STEPS * env.n_sub_steps
    if fast:
        # one launch a control step (its substeps), one a reset that
        # settles; chol_solve not at all
        settle = bool(env.task.settle_steps)
        check(reset_fast == int(settle),
              f"{what}: the fast path launched {reset_fast} times in a reset "
              f"of {env.task.settle_steps} settle steps")
        check_fast(linalg, what, total_fast - reset_fast, MAIN_STEPS,
                   settle=settle)
    else:
        check(total_fast == 0, f"{what}: the fast path launched "
                               f"{total_fast} times on the general path")
        check(reset_launches >= min_solves * env.task.settle_steps,
              f"{what}: chol_solve launched {reset_launches} times in a "
              f"reset of {env.task.settle_steps} settle steps")
        check(launches - reset_launches >= max(1, min_solves * substeps),
              f"{what}: chol_solve launched {launches - reset_launches} "
              f"times in {substeps} substeps (expected >= {min_solves} per "
              f"substep)")
    if env.model.opt.noslip_iterations:
        check(noslip_slots > 0, f"{what}: the noslip sweep visited no "
              f"contact")
    warm = step_times[1:]  # first step is the warm-up
    sps = batch * len(warm) / sum(warm)
    profiled = {}
    if profile:
        box = [state]

        def one_step():
            box[0], _ = env.step(box[0], actions())

        kernels, busy_ms, wall_ms = _idle_share(one_step, what)
        # the profiler slows the host: the share is also taken of the
        # unprofiled steps' median
        median_ms = 1e3 * float(np.median(step_times[1:]))
        profiled = dict(kernels_per_step=kernels, busy_ms=busy_ms,
                        profiled_ms=wall_ms, idle_share=1 - busy_ms / wall_ms,
                        step_median_ms=median_ms,
                        idle_share_unprofiled=1 - busy_ms / median_ms)
    return dict(domain=domain, task=task, batch=batch, launches=launches,
                branch_launches=branch_launches,
                reset_launches=reset_launches, substeps=substeps, fast=fast,
                fast_launches=total_fast, fast_reset_launches=reset_fast,
                fast_per_step=(total_fast - reset_fast) / MAIN_STEPS,
                after_warmup=after_warmup, env=env if fast else None,
                min_solves=min_solves, env_steps_per_s=sps,
                diverged_share=share, reset_s=reset_s,
                drop_rounds=getattr(env.task, "last_drop_rounds", None),
                rejection_rounds=env.last_rejection_rounds,
                step_ms=[1e3 * t for t in step_times],
                mean_reward=float(r.mean()), peak_gb=peak_gb,
                contact_cap=env.model.opt.contact_cap,
                noslip_slots_per_substep=(
                    noslip_slots / substeps
                    if env.model.opt.noslip_iterations else None),
                seen=seen, **profiled)


def fast_inputs(env, state, seed=2):
    """A control step's inputs to the fused step from ``state``: the task's
    ``before_step`` with seeded uniform actions, as ``BatchEnv.step`` does
    (qpos, qvel, warm start, ctrl), and the Data they came from."""
    from dm_control_torch.rl.control import apply_model_diff

    gen = torch.Generator(device="cuda").manual_seed(seed)
    B = state.data.qpos.shape[0]
    action = 2.0 * torch.rand(B, env.model.nu, generator=gen, device="cuda",
                              dtype=env.model.dtype) - 1.0
    d = env.task.before_step(apply_model_diff(env.model, state.model_diff),
                             env._unstrip(state.data), action)
    return [x.contiguous() for x in (d.qpos, d.qvel, d.qacc_warmstart,
                                     d.ctrl)], d


def _env_dev(got, ref, scale):
    """Each environment's largest |got - ref| over the three state fields,
    each field over max(1, ``scale``'s largest |entry| in that field)."""
    return torch.stack([
        ((g - r).abs().amax(-1) / max(1.0, float(c.abs().max()))).double()
        for g, r, c in zip(got, ref, scale)]).amax(0)


def phase_fast_check(suite, fastpath, domain, task, env, state):
    """The fused-step kernel against its plain version, each called
    directly, for one control step from ``state`` (after the warm-up step)
    with the same inputs: in float32 at the path's B, and in float64 at B =
    ``FAST_B64`` from the first environments of the same state.

    float64: every field within ``TOL`` (1e-10) of max(1, its largest
    |entry|).  float32: each environment within ``TOL`` (2e-4) of the same
    scale, or, where the float32 step itself is further than that from the
    float64 step of the same state (stiff contacts: the Newton loop stops
    on float32 cost comparisons, which fix qacc to about the square root
    of float32's epsilon), the kernel no further from the float64 step
    than ``FAST_F32_FACTOR`` times the plain float32 version is."""
    t0 = time.perf_counter()
    args, _ = fast_inputs(env, state)
    n = env.n_sub_steps
    got = fastpath.fastpath_step_cuda(env._fast, *args, n)
    torch.cuda.synchronize()
    ref = env._fast.plain(*args, n)
    env64 = suite.load_batch(domain, task, device="cuda",
                             dtype=torch.float64,
                             task_kwargs=TASK_KWARGS.get(domain))
    args64 = [a.double() for a in args]
    dev = _env_dev(got, ref, ref)
    fine = dev <= TOL[torch.float32]
    # the float64 step of the float32 state: of every environment where
    # some is off TOL, else of the first FAST_B64 (the float64 check's)
    rows = slice(None) if not bool(fine.all()) else slice(0, FAST_B64)
    ref64 = env64._fast.plain(*[a[rows] for a in args64], n)
    dev_plain = _env_dev([r[rows] for r in ref], ref64, ref64)
    dev_kernel = _env_dev([g[rows] for g in got], ref64, ref64)
    coarse = ~fine[rows] & (dev_plain > TOL[torch.float32])
    held = fine[rows] | (coarse & (dev_kernel <= FAST_F32_FACTOR * dev_plain))
    what = f"{domain}:{task} B={args[0].shape[0]} float32"
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"{what}: a non-finite value through the kernel")
    ratio = float((dev_kernel / dev_plain.clamp(min=1e-300))[coarse].max()) \
        if bool(coarse.any()) else 0.0
    check(bool(fine.all()) or bool(held.all()),
          f"{what}: kernel != plain in {int((~held).sum())} environments: "
          f"largest deviation {float(dev.max()):.3e} of the scale")
    a64 = [a[:FAST_B64].contiguous() for a in args64]
    got64 = fastpath.fastpath_step_cuda(env64._fast, *a64, n)
    torch.cuda.synchronize()
    ref64_b = [r[:FAST_B64] for r in ref64]
    err64 = float(_env_dev(got64, ref64_b, ref64_b).max())
    check(err64 <= TOL[torch.float64],
          f"{domain}:{task} B={FAST_B64} float64: kernel vs plain "
          f"{err64:.3e} of the scale (<= 1e-10)")
    return dict(err32=float(dev.max()), coarse=int(coarse.sum()),
                coarse_ratio=ratio, plain32_vs_64=float(dev_plain.max()),
                err64=err64, seconds=time.perf_counter() - t0,
                max_abs_err=max(float((g - r).abs().max())
                                for g, r in zip(got, ref)))


def fast_ops(step, n_steps, newton_iterations):
    """Floating-point operations of the fused step on this run's data,
    counted from the device functions of ``csrc/fastpath_step.cu`` (each
    add, multiply, divide, square root, sine and cosine one; pow as one):
    ``n_steps`` steps of each environment (4 forwards a step under RK4)
    and, summed over the batch, the Newton iterations they took
    (``newton_iterations``, from the plain version on the same inputs).
    The gradient and Hessian terms of rows with force are left out (they
    depend on the data), so the count is a lower bound."""
    nv, nb, nr = step.nv, step.nbody, step.nrows
    hinge = sum(t == 3 for t in step.jnt_type)
    slide = nv - hinge
    rotate, quat_mul = 30, 28
    fk = (nb - 1) * (rotate + 3) + sum(
        quat_mul for b in range(1, nb) if not step.body_quat_unit[b]) \
        + hinge * (3 * rotate + quat_mul + 17) + slide * (2 * rotate + 9)
    # per body: quat_to_mat, xipos, com, cinert, crb, cfrc (two inert_mul,
    # force_cross), the leaf-to-root sums; per dof: cdof, motion_cross,
    # the velocity and acceleration updates, inert_mul and M's dots, bias,
    # passive; per actuator: clamps, gear, the sum
    smooth = nb * (27 + 18 + 9 + 100 + 10 + 126 + 19) + sum(
        45 for b in range(nb) if not step.body_iquat_unit[b]) \
        + nv * (15 + 30 + 24 + 45 + 11 + 4) \
        + sum(11 * len([k for k in step.body_chain[step.dof_body[i]]
                        if k <= i]) for i in range(nv)) + 6 * step.nu
    chol = nv ** 3 // 3 + 2 * nv * nv + 2 * nv
    rows = len(step.lims) * (30 + nv + 10)
    for p in step.pairs:
        pose = 2 * 18 + 45 * ((not p["g1_unit"]) + (not p["g2_unit"]))
        per_con = 27 * nv + 30 + 3 * 5 * 3 + (
            2 * nv + 12 if p["condim"] == 1 else 4 * (3 * nv + 6))
        rows += pose + 120 + p["nrows"] * per_con
    cost = 4 * nv * nv + nr * (2 * nv + 4)
    newton_fixed = 2 * cost if nr else 0
    per_iteration = (nr * 2 * nv + nv * nv + 2 * nv * nv + chol
                     + nr * 2 * nv + 2 * nv * nv + 2 * nv
                     + step.ls_iterations * (nr * 4 + 4 * nv + 4)
                     + 3 * nv + cost + 10)
    forwards = n_steps * (4 if step.integrator == 1 else 1)
    per_env = forwards * (fk + smooth + chol + (rows if nr else 0)
                          + newton_fixed) + n_steps * (
        (chol + 2 * nv if step.has_damping and step.integrator == 0 else 0)
        + 4 * nv)
    return per_env * newton_iterations.numel() + per_iteration * int(
        newton_iterations.sum())


def time_fast(fastpath, engine, env, state):
    """The fused-step kernel at one main path's shape, from ``state``: its
    time a launch by CUDA events (the median) and on the device
    (``torch.profiler``), beside its bound (the larger of the bytes it
    must move over the card's memory rate and ``fast_ops`` over the peak
    rate of its type), the plain version's time and, for context, the
    general ``engine.step``'s for the same substeps.  No single PyTorch
    call computes this function: there is no library time."""
    args, d = fast_inputs(env, state)
    n = env.n_sub_steps
    fast = env._fast
    B = args[0].shape[0]

    def kernel():
        return fastpath.fastpath_step_cuda(fast, *args, n)

    def plain():
        return fast.plain(*args, n)

    def general():
        dd = d
        for _ in range(n):
            dd = engine.step(env.model, dd)
        return dd

    fast.plain(*args, n)
    iterations = fast.newton_iterations
    ms = time_ms(kernel)
    plain_ms = time_ms(plain, reps=3)
    engine_ms = time_ms(general, reps=3)
    device = device_ms(kernel, f"the fused step at B={B}", calls=20)
    dtype = args[0].dtype
    width = torch.finfo(dtype).bits // 8
    nbytes = width * B * (4 * fast.nv + fast.nu + 3 * fast.nv) \
        + 4 * len(fast.plan_ints) + width * len(fast.plan_floats)
    byte_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops = fast_ops(fast, n, iterations)
    flop_ms = 1e3 * ops / PEAK_FLOPS[dtype]
    return dict(B=B, nv=fast.nv, rows=fast.nrows, substeps=n,
                dtype=str(dtype).replace("torch.", ""), ms=ms,
                device_ms=device, plain_ms=plain_ms, engine_step_ms=engine_ms,
                bound_ms=max(byte_ms, flop_ms), byte_ms=byte_ms,
                flop_ms=flop_ms, ops=ops, bytes=nbytes,
                newton_iterations=float(iterations.double().mean()),
                bound_by="bytes" if byte_ms >= flop_ms else "operations",
                library_ms=None)


def phase_selfcheck(suite, linalg, engine, make_data, batch=256, steps=5):
    env = suite.load_batch("humanoid", "run", device="cuda",
                           dtype=torch.float32)
    m = env.model
    d0 = make_data(m, batch)
    d0 = d0.replace(qvel=torch.full_like(d0.qvel, 0.05))

    def run():
        d = d0
        for _ in range(steps):
            d = engine.step(m, d)
        return d.qpos

    q_kernel = run()
    with linalg.reference_solves():
        q_plain = run()
    dq = float((q_kernel - q_plain).abs().max())
    check(dq <= 1e-4, f"selfcheck max |dqpos| {dq:.3e} > 1e-4")
    return dq


class _TimedEnv:
    """An env whose ``step`` is the wrapped env's followed by a
    synchronize: ``end`` is when the last step ended; with ``flatten``,
    ``obs`` holds each step's flat observation."""

    def __init__(self, env, flatten=None):
        self.env, self.flatten = env, flatten
        self.end, self.obs = None, []

    def step(self, state, action):
        state, ts = self.env.step(state, action)
        torch.cuda.synchronize()
        self.end = time.perf_counter()
        if self.flatten is not None:
            self.obs.append(self.flatten(ts.observation))
        return state, ts


def phase_train(suite, linalg, ppo, domain, task, batch, steps, env=None):
    """PPO on one training path in float32 through the user's entry points
    (``load_batch`` on its default device, ``make_train_step``,
    ``init_train_state``): one warm-up train step, then ``TRAIN_TIMED``
    timed ones, with the kernel's launch count set to 0 just before
    ``init_train_state`` and read after the last step; ``env``: the path's
    env where it is not ``suite.load_batch(domain, task)``'s."""
    if env is None:
        env = suite.load_batch(domain, task, dtype=torch.float32)
    check(env.model.device.type == "cuda", "load_batch left the card")
    cfg = ppo.PPOConfig(steps_per_batch=steps, update_epochs=2,
                        num_minibatches=4)
    clock = _TimedEnv(env)
    train_step, optimizer = ppo.make_train_step(clock, cfg)
    min_solves = min_solves_per_substep(env)
    what = f"ppo {domain}:{task} B={batch} T={steps}"

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(linalg)
    t0 = time.perf_counter()
    state = ppo.init_train_state(
        env, torch.Generator(device="cuda").manual_seed(0), batch,
        optimizer)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, _ = train_step(state)  # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_launches = linalg.chol_solve.launches
    warm_fast = fast_launches()
    rollout_ms, update_ms, step_s = [], [], []
    for _ in range(TRAIN_TIMED):
        before = [p.detach().clone() for p in state.module.parameters()]
        t0 = time.perf_counter()
        state, metrics = train_step(state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step_s.append(t1 - t0)
        rollout_ms.append(1e3 * (clock.end - t0))
        update_ms.append(1e3 * (t1 - clock.end))
        after = list(state.module.parameters())
        check(any(not torch.equal(a, b) for a, b in zip(before, after)),
              f"{what}: a train step left the parameters as they were")
    launches = linalg.chol_solve.launches
    branch_launches = dict(linalg.chol_solve.branch_launches)
    check_branch(linalg, what, env.model, launches, branch_launches)
    substeps = steps * env.n_sub_steps
    fast = fast_launches()
    if takes_fast(env):
        # each control step of the rollouts one launch (and each reset
        # that settles one more); chol_solve none
        check_fast(linalg, what, fast - warm_fast, steps * TRAIN_TIMED,
                   settle=bool(env.task.settle_steps))
        per_step = (fast - warm_fast) / TRAIN_TIMED
    else:
        per_step = (launches - warm_launches) / TRAIN_TIMED
        check(per_step >= min_solves * substeps,
              f"{what}: chol_solve launched {per_step} times a train step "
              f"of {substeps} substeps (expected >= {min_solves} a "
              f"substep)")
    values = {k: float(metrics[k]) for k in ("pi_loss", "v_loss",
                                             "approx_kl", "mean_reward")}
    check(all(np.isfinite(v) for v in values.values()),
          f"{what}: non-finite metrics {values}")
    check(all(bool(torch.isfinite(p).all())
              for p in state.module.parameters()),
          f"{what}: non-finite parameters")
    check(metrics["env_steps"] == batch * steps,
          f"{what}: env_steps {metrics['env_steps']}")
    return dict(domain=domain, task=task, batch=batch, steps=steps,
                launches=launches, branch_launches=branch_launches,
                fast=takes_fast(env), fast_launches=fast,
                per_step=per_step, substeps=substeps,
                min_solves=min_solves, init_s=init_s, warm_s=warm_s,
                env_steps_per_s=batch * steps * TRAIN_TIMED / sum(step_s),
                rollout_ms=rollout_ms, update_ms=update_ms,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9, **values)


def phase_train_selfcheck(suite, linalg, ppo, batch=64, steps=8):
    """One float64 train step of pendulum:swingup twice from one saved
    state (so with the same draws): through the fused-step kernel and
    through its plain version (``plain_version``).  Returns the largest
    parameter and observation differences and the kernel's launches in the
    first run."""
    env = suite.load_batch("pendulum", "swingup", dtype=torch.float64)
    cfg = ppo.PPOConfig(steps_per_batch=steps, update_epochs=2,
                        num_minibatches=4)
    rec = _TimedEnv(env, flatten=ppo.flatten_obs)
    train_step, optimizer = ppo.make_train_step(rec, cfg,
                                                obs_dtype=torch.float64)

    def fresh(seed):
        return ppo.init_train_state(
            env, torch.Generator(device="cuda").manual_seed(seed), batch,
            optimizer, obs_dtype=torch.float64)

    saved = io.BytesIO()
    ppo.save_train_state(saved, fresh(0))
    runs = []
    for plain in (False, True):
        saved.seek(0)
        state = ppo.restore_train_state(saved, fresh(1))
        rec.obs = []
        n0 = fast_launches()
        with plain_version(linalg, env) if plain else \
                contextlib.nullcontext():
            state, _ = train_step(state)
        runs.append((torch.cat([p.detach().flatten()
                                for p in state.module.parameters()]),
                     torch.stack(rec.obs), fast_launches() - n0))
    (p_k, obs_k, n_k), (p_p, obs_p, n_p) = runs
    check(takes_fast(env) and n_k >= steps and n_p == 0,
          f"train selfcheck: {n_k} fused-step launches through the kernel, "
          f"{n_p} through the plain version")
    dp = float((p_k - p_p).abs().max())
    dobs = float((obs_k - obs_p).abs().max())
    check(dp <= 1e-8 and dobs <= 1e-9,
          f"train selfcheck: kernel vs plain max |dparams| {dp:.3e} "
          f"(<= 1e-8), max |dobs| {dobs:.3e} (<= 1e-9)")
    return dp, dobs, n_k


def phase_env_golden(suite, domain, task):
    """One recorded single-environment episode on the card in float64:
    ``suite.load(domain, task, task_kwargs={"random": 11})``, its reset
    and the recorded actions, every timestep through the golden gate
    (``rl/golden.py::episode_gate``).  Returns the largest of each of the
    gate's two figures over the episode."""
    from dm_control_torch.rl import golden

    name = f"{domain}_{task}"
    with np.load(os.path.join(ROOT, "tests", "data",
                              f"torch_env_{name}_f64.npz"),
                 allow_pickle=False) as z:
        gold = {k: z[k] for k in z.files}
    env = suite.load(domain, task, task_kwargs={"random": ENV_SEED},
                     device="cuda", dtype=torch.float64)
    check(env.physics.model.device.type == "cuda", "load left the card")
    errs = golden.episode_errors(env, gold)
    figures, ok = golden.episode_gate(errs, gold, name)
    rest = max(f[0] for f in figures)
    rel = max(f[1] for t, f in enumerate(figures)
              if (name, t) not in golden.EPISODE_WARMSTART_MISSES)
    missed = [f"t={t}: {f[1]:.3e}" for t, f in enumerate(figures)
              if (name, t) in golden.EPISODE_WARMSTART_MISSES]
    check(ok, f"episode golden {name}: gate failed, figures "
              f"{[(f'{a:.3e}', f'{b:.3e}') for a, b in figures]}")
    return rest, rel, missed


def _idle_share(step, what):
    """(device kernels, device busy ms, wall ms) of one profiled call of
    ``step`` (``profiled``)."""
    kernels, wall = profiled(step, what)
    busy_us = sum(e.duration_ns() for e in kernels) / 1e3
    return len(kernels), busy_us / 1e3, wall * 1e3


def phase_single(suite, linalg):
    """The single-environment path: ``suite.load("humanoid", "run")`` on
    its default device in float32, a reset and ``SINGLE_STEPS`` control
    steps, with the kernel's launch count set to 0 just before the reset
    and read after the last step; then one more control step under
    ``torch.profiler``."""
    env = suite.load("humanoid", "run", task_kwargs={"random": 0},
                     dtype=torch.float32)
    check(env.physics.model.device.type == "cuda", "load left the card")
    spec = env.action_spec()
    rng = np.random.RandomState(1)

    def action():
        return rng.uniform(spec.minimum, spec.maximum)

    torch.cuda.synchronize()
    reset_counts(linalg)
    t0 = time.perf_counter()
    ts = env.reset()
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    reset_launches = linalg.chol_solve.launches
    times, rewards = [], []
    for _ in range(SINGLE_STEPS):
        t0 = time.perf_counter()
        ts = env.step(action())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rewards.append(ts.reward)
        check(all(np.isfinite(v).all() for v in ts.observation.values()),
              "single humanoid:run: non-finite observation")
    launches = linalg.chol_solve.launches
    branch_launches = dict(linalg.chol_solve.branch_launches)
    check_branch(linalg, "single humanoid:run", env.physics.model, launches,
                 branch_launches)
    check(int(ts.step_type) == 1 and np.isfinite(rewards).all()
          and all(0 <= r <= 1 for r in rewards),
          f"single humanoid:run: step type {ts.step_type}, rewards "
          f"{rewards}")
    substeps = SINGLE_STEPS * env._n_sub_steps
    check(launches - reset_launches >= 2 * substeps,
          f"single humanoid:run: chol_solve launched "
          f"{launches - reset_launches} times in {substeps} substeps")
    kernels, busy_ms, wall_ms = _idle_share(lambda: env.step(action()),
                                            "single humanoid:run")
    warm = times[1:]
    return dict(launches=launches, branch_launches=branch_launches,
                reset_launches=reset_launches,
                per_step=(launches - reset_launches) / SINGLE_STEPS,
                steps_per_s=len(warm) / sum(warm),
                first_ms=1e3 * times[0], reset_s=reset_s,
                rejection_rounds=env.last_reset_attempts - 1,
                kernels_per_step=kernels, busy_ms=busy_ms,
                profiled_ms=wall_ms, idle_share=1 - busy_ms / wall_ms)


def phase_single_selfcheck(suite, linalg, steps=2):
    """humanoid:run in float64 on the card, a reset and ``steps`` control
    steps, through the kernel and again under ``reference_solves()`` with
    the same seed and actions.  Returns the largest observation and reward
    difference, and the kernel's launches in each run."""
    runs = []
    for plain in (False, True):
        env = suite.load("humanoid", "run", task_kwargs={"random": 3},
                         dtype=torch.float64)
        spec = env.action_spec()
        rng = np.random.RandomState(2)
        n0 = linalg.chol_solve.launches
        with linalg.reference_solves() if plain else contextlib.nullcontext():
            out = [env.reset()]
            for _ in range(steps):
                out.append(env.step(rng.uniform(spec.minimum, spec.maximum)))
        runs.append((out, linalg.chol_solve.launches - n0))
    (k_out, n_k), (p_out, n_p) = runs
    check(n_k >= 2 * steps and n_p == 0,
          f"single selfcheck: {n_k} kernel launches through the kernel, "
          f"{n_p} under reference_solves()")
    dobs = max(float(np.abs(a.observation[k] - b.observation[k]).max())
               for a, b in zip(k_out, p_out) for k in a.observation)
    drew = max(abs(a.reward - b.reward) for a, b in zip(k_out[1:], p_out[1:]))
    check(dobs <= 1e-10 and drew <= 1e-10,
          f"single selfcheck: kernel vs plain max |dobs| {dobs:.3e}, "
          f"|dreward| {drew:.3e} (<= 1e-10)")
    return dobs, drew, n_k


def _rows(obs, reward, qpos, qvel):
    """One control step's result as (B, k) rows on the card, by group:
    the observations, the reward and the state (qpos, qvel)."""
    def flat(x):
        x = torch.as_tensor(x, device="cuda")
        return x.reshape(x.shape[0], -1)

    return {"obs": torch.cat([flat(v) for v in obs], 1),
            "reward": flat(reward),
            "state": torch.cat([flat(qpos), flat(qvel)], 1)}


def phase_golden_selfcheck(env, golden_name, linalg, what):
    """A float64 env on the card: one control step from each of its
    golden's start states with the golden's actions, through the kernel
    and again under ``reference_solves()``.  In each environment the
    kernel's step is held to the plain one within 1e-9; where the plain
    step itself is more than 1e-9 from the golden's recording, the
    kernel's step is held to the recording within 1e-9 instead.
    That happens where the Newton solver's line search and its accept
    test (``cost_new < cost``) decide on figures whose rounding exceeds
    what they decide (ROADMAP C): there the plain version's roundings
    may stop the step elsewhere than the recording's did.  Returns
    the largest observation, reward and state difference from what each
    environment is held to, the kernel's launches, and the environments
    held to the recording as (prefix, environment, the plain step's
    largest difference from the recording)."""
    from dm_control_torch.rl import golden

    gate = 1e-9
    with np.load(os.path.join(ROOT, "tests", "data",
                              f"torch_{golden_name}_golden_f64.npz"),
                 allow_pickle=False) as z:
        gold = {k: z[k] for k in z.files}
    worst = {"obs": 0.0, "reward": 0.0, "state": 0.0}
    held = []
    n_k = n_p = n_env = 0
    for prefix in golden.PREFIXES:
        state = golden.start_state(env, gold, prefix)
        action = torch.as_tensor(gold[f"{prefix}_actions"], device="cuda")
        n0 = linalg.chol_solve.launches
        s_k, ts_k = env.step(state, action)
        n1 = linalg.chol_solve.launches
        with linalg.reference_solves():
            s_p, ts_p = env.step(state, action)
        n_k += n1 - n0
        n_p += linalg.chol_solve.launches - n1
        kernel = _rows(ts_k.observation.values(), ts_k.reward,
                       s_k.data.qpos, s_k.data.qvel)
        plain = _rows(ts_p.observation.values(), ts_p.reward,
                      s_p.data.qpos, s_p.data.qvel)
        recorded = _rows([gold[f"{prefix}_obs_{k}"] for k in ts_k.observation],
                         *(gold[f"{prefix}_{f}"] for f in
                           ("reward", "step_qpos", "step_qvel")))
        off = torch.stack([(plain[g] - recorded[g]).abs().amax(1)
                           for g in plain]).amax(0)
        n_env += off.numel()
        for i in (off > gate).nonzero().flatten().tolist():
            held.append((prefix, i, float(off[i])))
        for g in worst:
            ref = torch.where((off > gate).unsqueeze(1), recorded[g],
                              plain[g])
            worst[g] = max(worst[g], float((kernel[g] - ref).abs().max()))
    steps = len(golden.PREFIXES)
    check(n_k >= 2 * steps * env.n_sub_steps and n_p == 0,
          f"{what} selfcheck: {n_k} kernel launches through the "
          f"kernel, {n_p} under reference_solves()")
    # a tie is rare: a plain version off the recording in many
    # environments is itself at fault
    check(len(held) <= n_env // 4,
          f"{what} selfcheck: the plain step is off the recording in "
          f"{held}")
    check(max(worst.values()) <= gate,
          f"{what} selfcheck: kernel vs plain (vs the recording at {held}) "
          f"{worst} (<= {gate:g})")
    return worst, n_k, held


def held_note(held):
    """The selfcheck's environments held to the recording, for its line."""
    return "".join(f"; {p} environment {i} held to the JAX recording (the "
                   f"plain step {d:.3e} from it)" for p, i, d in held)


def phase_manipulation(manipulation, suite, linalg, solver, ppo, card,
                       trains, started):
    """Phase 9, the batched manipulation path: the float64 goldens, the
    four float32 paths with a profiled step each, the kernel against
    ``reference_solves()`` and one PPO train step (appended to
    ``trains``).  Returns the four paths' runs."""
    t9 = time.perf_counter()
    for asset, task in MANIP_PATHS:
        env = manipulation.load_batch(task, dtype=torch.float64,
                                      autoreset=False)
        check(env.model.device.type == "cuda", "load_batch left the card")
        gerr, gworst, rest, rel, _ = phase_golden(
            suite, linalg, f"manipulation_{asset}", "manipulation", task,
            env=env)
        print(f"phase 9 golden: float64 {task} step on the card vs JAX "
              f"golden manipulation_{asset} (reset and later states), max "
              f"|d| {gerr:.3e} ({gworst}); gate: all but qacc_warmstart "
              f"{rest:.3e} <= 1e-9, qacc_warmstart {rel:.3e} of its scale "
              f"<= 1e-12; phase 9 at {time.perf_counter() - t9:.1f} s",
              flush=True)
    manips = []
    for asset, task in MANIP_PATHS:
        env = manipulation.load_batch(task, dtype=torch.float32)
        check(env.model.device.type == "cuda", "load_batch left the card")
        run = phase_main(suite, linalg, solver, "manipulation", task,
                         MANIP_BATCH, env=env, profile=True)
        manips.append(run)
        print(f"phase 9 main path: manipulation.load_batch({task!r}) "
              f"B={MANIP_BATCH} float32 nv={env.model.nv}, reset "
              f"{run['reset_s']:.2f} s, {MAIN_STEPS} steps "
              f"({run['substeps']} substeps), chol_solve launches "
              f"{run['launches']} (>= {run['min_solves']} a substep), "
              f"{run['env_steps_per_s']:.1f} env-steps/s after warm-up, "
              f"diverged share {run['diverged_share']:.4f}, mean reward "
              f"{run['mean_reward']:.4f}, step ms "
              f"{[round(t, 1) for t in run['step_ms']]}, peak "
              f"{run['peak_gb']:.2f} GB, contact cap {run['contact_cap']}; "
              f"one profiled control step: {run['kernels_per_step']} device "
              f"kernels, busy {run['busy_ms']:.3f} ms of "
              f"{run['profiled_ms']:.1f} ms, idle share "
              f"{run['idle_share']:.4f} (of the unprofiled steps' median "
              f"{run['step_median_ms']:.1f} ms: "
              f"{run['idle_share_unprofiled']:.4f}); phase 9 at "
              f"{time.perf_counter() - t9:.1f} s | {card}", flush=True)
    worst, n_k, held = phase_golden_selfcheck(
        manipulation.load_batch("reach_site_features", dtype=torch.float64,
                                autoreset=False),
        "manipulation_reach_site", linalg, "manipulation")
    print(f"phase 9 selfcheck: reach_site_features float64, one control "
          f"step from each of its golden's start states (B=4) through the "
          f"kernel ({n_k} launches) and under reference_solves(): max "
          f"|dobs| {worst['obs']:.3e}, |dreward| {worst['reward']:.3e}, "
          f"|dqpos, dqvel| {worst['state']:.3e} <= 1e-9{held_note(held)}; "
          f"phase 9 at {time.perf_counter() - t9:.1f} s | {card}",
          flush=True)
    mtask, mbatch, msteps = MANIP_TRAIN
    run = phase_train(suite, linalg, ppo, "manipulation", mtask, mbatch,
                      msteps, env=manipulation.load_batch(
                          mtask, dtype=torch.float32))
    trains.append(run)
    print(f"phase 9 train: ppo {mtask} B={mbatch} T={msteps} float32, 2 "
          f"epochs x 4 minibatches: {run['env_steps_per_s']:.1f} env-steps/s "
          f"through the learner over {TRAIN_TIMED} train steps after a "
          f"warm-up ({run['warm_s']:.2f} s), rollout ms "
          f"{[round(t, 1) for t in run['rollout_ms']]}, update ms "
          f"{[round(t, 1) for t in run['update_ms']]}, chol_solve launches "
          f"{run['per_step']:.1f} a train step, pi_loss "
          f"{run['pi_loss']:.4e} approx_kl {run['approx_kl']:.4e}, peak "
          f"{run['peak_gb']:.2f} GB; all phases in "
          f"{time.perf_counter() - started:.1f} s | {card}", flush=True)
    return manips


def locomotion_env(asset, dtype, autoreset=True):
    """The env of a locomotion asset on the card: soccer through
    ``soccer.load_batch``; tracking through ``compile_task`` of
    ``MultiClipMocapTracking`` as the JAX package builds it, the rolling
    ball on 4 synthetic clips of 120 frames (seeds 0-3) with threshold 50
    and a 10 s limit (its tracking bench rung), the CMU 2020 humanoid on 3
    (seeds 0-2) with ``ref_steps`` 1-5, ``min_steps`` 10 and a 30 s limit
    (its ``examples/cmu_2020_tracking.py``); the CoMic reward."""
    from dm_control_torch.composer import compile_task
    from dm_control_torch.locomotion import soccer

    if asset.startswith("soccer_"):
        return soccer.load_batch(team_size=int(asset[-1]), dtype=dtype,
                                 autoreset=autoreset)
    task, limit = tracking_task(asset)
    return compile_task(task, device="cuda", dtype=dtype, time_limit=limit,
                        autoreset=autoreset)


def tracking_task(asset):
    """(task, time limit) of a tracking asset, as ``locomotion_env`` says;
    phase 13 runs the same tasks on the host."""
    from dm_control_torch.locomotion.arenas import Floor
    from dm_control_torch.locomotion.mocap.loader import (
        synthetic_walking_trajectory,
    )
    from dm_control_torch.locomotion.mocap.types import ClipCollection
    from dm_control_torch.locomotion.tasks.reference_pose import (
        MultiClipMocapTracking,
    )
    from dm_control_torch.locomotion.walkers import (
        CMUHumanoidPositionControlledV2020, RollingBallWithHead,
    )

    if asset == "tracking_ball":
        walker = RollingBallWithHead()
        nq = 7 + len(walker.observable_joint_names)
        clips = {f"clip{i}": synthetic_walking_trajectory(
            nq=nq, nv=nq - 1, num_steps=120, seed=i) for i in range(4)}
        task = MultiClipMocapTracking(
            walker, Floor(), clips, dataset=ClipCollection(ids=tuple(clips)),
            termination_error_threshold=50.0, reward_type="comic")
        limit = 10.0
    else:
        walker = CMUHumanoidPositionControlledV2020()
        n = len(walker.mocap_joint_names)
        clips = {f"synthetic_walk_{k}": synthetic_walking_trajectory(
            nq=n + 7, nv=n + 6, seed=k, identifier=f"synthetic_walk_{k}")
            for k in range(3)}
        task = MultiClipMocapTracking(
            walker=walker, arena=Floor(), ref_path_or_trajectories=clips,
            ref_steps=(1, 2, 3, 4, 5), min_steps=10, reward_type="comic")
        limit = 30.0
    return task, limit


def check_goal_rewards(r):
    """Soccer's rewards (steps, B, players): each -1, 0 or 1, and summing
    to 0 over the players of each environment (as many a side)."""
    ok = (bool(((r == -1) | (r == 0) | (r == 1)).all())
          and bool((r.sum(-1) == 0).all()))
    return ok, "rewards outside {-1, 0, 1} or not summing to 0"


def check_finite(r):
    return True, "finite rewards"


def contacts_in_use(env, state):
    """Per condim group: (the most active candidate contacts in one
    environment, the mean over the batch, the candidates), at ``state``;
    active where the distance is under the margin.  Past the cap (64 in
    float32) compaction drops the shallowest."""
    from dm_control_torch.physics import engine
    from dm_control_torch.rl.control import apply_model_diff

    m = apply_model_diff(env.model, state.model_diff)
    con = engine.fwd_position(m, env._unstrip(state.data)).contact
    active = (con.dist - con.includemargin) < 0
    dims = np.array(con.dim)
    out = {}
    for c in sorted(set(con.dim)):
        n = active[:, torch.as_tensor(np.nonzero(dims == c)[0],
                                      device=active.device)].sum(-1)
        out[int(c)] = (int(n.max()), float(n.float().mean()),
                       int((dims == c).sum()))
    return out


def phase_locomotion(suite, linalg, solver, card):
    """Phase 10, the batched locomotion path: the four float64 goldens
    (soccer's later states scoring a goal), the three float32 paths with a
    profiled step each, and soccer 2v2 in float64 through the kernel
    against ``reference_solves()``.  Returns the paths' runs."""
    t10 = time.perf_counter()
    for asset in LOCO_GOLDENS:
        env = locomotion_env(asset, torch.float64, autoreset=False)
        check(env.model.device.type == "cuda", "the env left the card")
        gerr, gworst, rest, rel, _ = phase_golden(
            suite, linalg, f"locomotion_{asset}", "locomotion", asset,
            env=env)
        print(f"phase 10 golden: float64 {asset} (nv={env.model.nv}) step "
              f"on the card vs JAX golden locomotion_{asset} (reset and "
              f"later states), max |d| {gerr:.3e} ({gworst}); gate: all but "
              f"qacc_warmstart {rest:.3e} <= 1e-9, qacc_warmstart "
              f"{rel:.3e} of its scale <= 1e-12; phase 10 at "
              f"{time.perf_counter() - t10:.1f} s", flush=True)
    runs = []
    for asset, batch in LOCO_PATHS:
        env = locomotion_env(asset, torch.float32)
        check(env.model.device.type == "cuda", "the env left the card")
        soccer = asset.startswith("soccer_")
        run = phase_main(suite, linalg, solver, "locomotion", asset, batch,
                         env=env, profile=True,
                         check_rewards=(check_goal_rewards if soccer
                                        else check_finite),
                         inspect=contacts_in_use)
        runs.append(run)
        seen = "; ".join(
            f"{when}: " + ", ".join(
                f"condim {c} max {mx} mean {mean:.1f} of {n}"
                for c, (mx, mean, n) in v.items())
            for when, v in run["seen"].items())
        print(f"phase 10 main path: {asset} B={batch} float32 "
              f"nv={env.model.nv}, reset {run['reset_s']:.2f} s, "
              f"{MAIN_STEPS} steps ({run['substeps']} substeps), chol_solve "
              f"launches {run['launches']} (>= {run['min_solves']} a "
              f"substep), {run['env_steps_per_s']:.1f} env-steps/s after "
              f"warm-up, diverged share {run['diverged_share']:.4f}, mean "
              f"reward {run['mean_reward']:.4f}, step ms "
              f"{[round(t, 1) for t in run['step_ms']]}, peak "
              f"{run['peak_gb']:.2f} GB, contact cap {run['contact_cap']}, "
              f"contacts in use ({seen}); one profiled control step: "
              f"{run['kernels_per_step']} device kernels, busy "
              f"{run['busy_ms']:.3f} ms of {run['profiled_ms']:.1f} ms, "
              f"idle share {run['idle_share']:.4f} (of the unprofiled "
              f"steps' median {run['step_median_ms']:.1f} ms: "
              f"{run['idle_share_unprofiled']:.4f}); phase 10 at "
              f"{time.perf_counter() - t10:.1f} s | {card}", flush=True)
    worst, n_k, held = phase_golden_selfcheck(
        locomotion_env("soccer_2v2", torch.float64, autoreset=False),
        "locomotion_soccer_2v2", linalg, "soccer")
    print(f"phase 10 selfcheck: soccer_2v2 float64 (n = 38), one control "
          f"step from each of its golden's start states (B=4, a goal among "
          f"them) through the kernel ({n_k} launches) and under "
          f"reference_solves(): max |dobs| {worst['obs']:.3e}, |dreward| "
          f"{worst['reward']:.3e}, |dqpos, dqvel| {worst['state']:.3e} <= "
          f"1e-9{held_note(held)}; phase 10 in "
          f"{time.perf_counter() - t10:.1f} s | {card}", flush=True)
    return runs


def reference_variants(suite):
    """reference file name -> the ``Variant`` of a task that compiles its
    model (lqr's files hold its seed 0)."""
    out = {}
    for domain_name, domain in suite.DOMAINS.items():
        for task in domain.TASKS:
            variant, _ = domain.TASKS[task](**TASK_KWARGS.get(domain_name,
                                                             {}))
            out.setdefault(variant.name, variant)
    return out


def phase_compile_references(suite, card):
    """Every suite model variant with a reference file compiled onto the
    card in float64 (the compile cache emptied first) and held to the
    file: each model's compile time on the host clock and its largest
    ``set_const`` deviation."""
    from dm_control_torch.physics import model_io
    from dm_control_torch.suite import _domain, base

    names = sorted(f[:-len(".npz")] for f in os.listdir(
        os.path.dirname(base.asset_path("humanoid"))))
    check(len(names) == 32, f"{len(names)} reference files, not 32")
    variants = reference_variants(suite)
    _domain._MODEL_CACHE.clear()
    rows = []
    for name in names:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = variants[name].get_model("cuda", torch.float64)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        check(m.qpos0.device.type == "cuda" and m.dtype == torch.float64,
              f"compile {name}: model not float64 on the card")
        devs = model_io.deviations(m, base.load_model(name, "cuda",
                                                      torch.float64))
        exact = {k: v for k, v in devs.items()
                 if k not in model_io.SET_CONST_FIELDS and v}
        check(not exact, f"compile {name}: compiler fields differ from the "
                         f"reference: {exact}")
        field = max(model_io.SET_CONST_FIELDS, key=devs.get)
        check(devs[field] <= SET_CONST_REL,
              f"compile {name}: set_const field {field} off by "
              f"{devs[field]:.3e} of its largest entry (> {SET_CONST_REL})")
        rows.append(dict(name=name, compile_ms=ms, nv=m.nv,
                         set_const_rel=devs[field], field=field))
        print(f"phase 11 compile: {name} (nv={m.nv}) onto the card in "
              f"float64 in {ms:.1f} ms (host clock); compiler fields equal "
              f"the reference, set_const largest {devs[field]:.3e} of its "
              f"scale ({field}) <= {SET_CONST_REL:g} | {card}", flush=True)
    return rows


def phase_recipe(linalg):
    """The drive recipe: a sphere dropped on a plane, built with
    ``Physics.from_xml_string`` on the card (the default device), stepped
    ``RECIPE_STEPS`` times; its rest height is its radius."""
    from dm_control_torch import mjcf
    from dm_control_torch.physics.physics import Physics

    root = mjcf.Element("mujoco")
    wb = root.add("worldbody")
    wb.add("geom", type="plane", size="1 1 .1")
    body = wb.add("body", pos="0 0 1")
    body.add("freejoint")
    body.add("geom", type="sphere", size="0.1")
    physics = Physics.from_xml_string(root.to_xml_string())
    check(physics.model.qpos0.device.type == "cuda",
          "Physics.from_xml_string left the card")
    torch.cuda.synchronize()
    reset_counts(linalg)
    t0 = time.perf_counter()
    physics.step(RECIPE_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = linalg.chol_solve.launches
    branch_launches = dict(linalg.chol_solve.branch_launches)
    check_branch(linalg, "the dropped sphere", physics.model, launches,
                 branch_launches)
    height = float(physics.data.qpos[2])
    check(abs(height - 0.1) <= 1e-3,
          f"dropped sphere rests at {height:.6f}, not 0.1 +- 1e-3")
    check(launches >= RECIPE_STEPS,
          f"chol_solve launched {launches} times in {RECIPE_STEPS} steps")
    return dict(height=height, seconds=seconds, launches=launches,
                branch_launches=branch_launches)


def phase_compile(suite, linalg, solver, card):
    """Phase 11: the compiler on the card."""
    t11 = time.perf_counter()
    rows = phase_compile_references(suite, card)
    recipe = phase_recipe(linalg)
    print(f"phase 11 recipe: sphere on a plane by Physics.from_xml_string, "
          f"{RECIPE_STEPS} steps on the card in {recipe['seconds']:.2f} s "
          f"({recipe['launches']} chol_solve launches), rest height "
          f"{recipe['height']:.6f} (0.1 +- 1e-3) | {card}", flush=True)
    domain, task, kwargs, batch = COMPILE_PATH
    env = suite.load_batch(domain, task, device="cuda", dtype=torch.float32,
                           task_kwargs=kwargs)
    check(env.model.nv == 1 + kwargs["num_poles"],
          f"{task}({kwargs}): nv {env.model.nv}")
    run = phase_main(suite, linalg, solver, domain, task, batch, env=env,
                     profile=True)
    run.pop("env")
    run.pop("after_warmup")
    run.update(task=f"{task}({kwargs})", nv=env.model.nv)
    check(run["fast"], f"{task}({kwargs}): not on the fused fast path")
    print(f"phase 11 main path: {domain}:{task} num_poles="
          f"{kwargs['num_poles']} (nv={env.model.nv}, no reference file) "
          f"B={batch} float32, reset {run['reset_s']:.2f} s, {MAIN_STEPS} "
          f"steps: {run['env_steps_per_s']:.1f} env-steps/s after warm-up, "
          f"fused-step launches {run['fast_per_step']:.1f} a control step, "
          f"chol_solve launches {run['launches']}, "
          f"step ms {[round(t, 1) for t in run['step_ms']]}, one profiled "
          f"control step: {run['kernels_per_step']} device kernels, busy "
          f"{run['busy_ms']:.3f} ms, idle share {run['idle_share']:.4f} "
          f"(of the unprofiled median {run['idle_share_unprofiled']:.4f}), "
          f"diverged share {run['diverged_share']:.4f}, peak "
          f"{run['peak_gb']:.2f} GB; phase 11 in "
          f"{time.perf_counter() - t11:.1f} s | {card}", flush=True)
    return rows, recipe, run


def phase_host_goldens(manipulation, card):
    """Phase 12 (a): each host episode golden replayed in float64 on the
    card one control step at a time (``rl/golden.py``): the reset's draws
    exact (qpos, the stud radii), every timestep within the gate."""
    from dm_control_torch.rl import golden

    for name in HOST_GOLDENS:
        with np.load(os.path.join(ROOT, "tests", "data",
                                  f"torch_manipulation_env_{name}_f64.npz"),
                     allow_pickle=False) as z:
            gold = {k: z[k] for k in z.files}
        env = manipulation.load(name, seed=HOST_SEED, dtype=torch.float64)
        check(env.physics.model.device.type == "cuda",
              "manipulation.load left the card")
        t0 = time.perf_counter()
        errs = golden.host_episode_errors(env, gold)
        seconds = time.perf_counter() - t0
        figures, ok = golden.episode_gate(errs, gold, name)
        check(ok, f"host golden {name}: gate failed, figures "
                  f"{[(f'{a:.3e}', f'{b:.3e}') for a, b in figures]}")
        reset = {k: errs[0][k] for k in ("step_qpos", "model_geom_size",
                                         "model_geom_rbound")}
        check(not any(reset.values()),
              f"host golden {name}: the reset's draws differ: {reset}")
        rest = max(a for a, _ in figures)
        rel = max(b for _, b in figures)
        print(f"phase 12 golden: float64 manipulation.load({name!r}) "
              f"(nv={env.physics.model.nv}) on the card vs the JAX episode, "
              f"reset and {len(figures) - 1} control steps each from the "
              f"recorded state in {seconds:.1f} s: reset qpos and stud radii "
              f"exact; gate: all but qacc_warmstart {rest:.3e} <= 1e-9, "
              f"qacc_warmstart {rel:.3e} of its scale <= 1e-12 | {card}",
              flush=True)


def phase_host_compiles(card):
    """Phase 12 (b): each of the 11 entity trees compiled onto the card in
    float64 as ``load_batch`` compiles it, with its host milliseconds; a
    tree with a reference file is held to it (phase 11's gate)."""
    from dm_control_torch.composer.batch import task_model
    from dm_control_torch.manipulation.shared import registry

    rows = []
    for tree, name in HOST_TREES:
        task = registry.get(name)()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = task_model(task, "cuda", torch.float64)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        check(m.qpos0.device.type == "cuda" and m.dtype == torch.float64,
              f"compile {tree}: model not float64 on the card")
        path = os.path.join(ROOT, "dm_control_torch", "manipulation",
                            "assets", f"{tree}.npz")
        note = "no reference file"
        if os.path.exists(path):
            note = hold_to_reference(m, path, tree)
        rows.append(dict(tree=tree, nv=m.nv, compile_ms=ms))
        print(f"phase 12 compile: {tree} ({name}, nv={m.nv}) entity tree "
              f"onto the card in float64 in {ms:.1f} ms (host clock); "
              f"{note} | {card}", flush=True)
    return rows


def hold_to_reference(m, path, tree):
    """Holds a model compiled on the card to its reference file (phase 11's
    gate: compiler fields equal, each ``set_const`` field within
    ``SET_CONST_REL`` of its largest entry); returns the note to print."""
    from dm_control_torch.physics import model_io

    devs = model_io.deviations(m, model_io.load(path, "cuda", torch.float64))
    exact = {k: v for k, v in devs.items()
             if k not in model_io.SET_CONST_FIELDS and v}
    check(not exact, f"compile {tree}: compiler fields differ from the "
                     f"reference: {exact}")
    field = max(model_io.SET_CONST_FIELDS, key=devs.get)
    check(devs[field] <= SET_CONST_REL,
          f"compile {tree}: set_const field {field} off by "
          f"{devs[field]:.3e} of its largest entry")
    return (f"compiler fields equal the reference, set_const largest "
            f"{devs[field]:.3e} of its scale ({field}) <= "
            f"{SET_CONST_REL:g}")


@contextlib.contextmanager
def host_counters():
    """Counts, while open, the host seconds spent in the observation
    updater's methods, the named reads of the physics (each a copy from
    the card to the host), the environment's compiles of its tree and
    soccer's scans of the contacts (a copy from the card each): yields a
    dict the counts accumulate in."""
    from dm_control_torch.composer.observation.updater import Updater
    from dm_control_torch.physics.physics import Physics

    from dm_control_torch.composer.environment import Environment
    from dm_control_torch.locomotion.soccer.task import Task as SoccerTask

    counts = {"updater_s": 0.0, "reads": 0, "recompile_s": 0.0,
              "recompiles": 0, "contacts_s": 0.0, "contact_scans": 0}
    saved = {}

    def timed(cls, name, key, calls=None):
        fn = saved[(cls, name)] = getattr(cls, name)

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                if key == "reads":
                    counts["reads"] += 1
                else:
                    counts[key] += time.perf_counter() - t0
                if calls:
                    counts[calls] += 1
        setattr(cls, name, wrapper)

    for name in ("reset", "prepare_for_next_control_step", "update",
                 "get_observation"):
        timed(Updater, name, "updater_s")
    timed(Physics, "named_field", "reads")
    timed(Environment, "_recompile_physics", "recompile_s", "recompiles")
    timed(SoccerTask, "_update_ball_contacts", "contacts_s",
          "contact_scans")
    try:
        yield counts
    finally:
        for (cls, name), fn in saved.items():
            setattr(cls, name, fn)


def phase_host_rate(manipulation, linalg, card):
    """Phase 12 (c): ``manipulation.load(HOST_RATE)`` on the card in
    float32, a reset and the control steps with the kernel's launch count
    set to 0 just before the reset and read after the last step, the
    updater's host time and the named reads; then one more control step
    under ``torch.profiler``."""
    name, steps = HOST_RATE
    env = manipulation.load(name, seed=0, dtype=torch.float32)
    check(env.physics.model.device.type == "cuda",
          "manipulation.load left the card")
    spec = env.action_spec()
    rng = np.random.RandomState(1)

    def action():
        return rng.uniform(spec.minimum, spec.maximum)

    with host_counters() as counts:
        torch.cuda.synchronize()
        reset_counts(linalg)
        t0 = time.perf_counter()
        ts = env.reset()
        torch.cuda.synchronize()
        reset_s = time.perf_counter() - t0
        reset_launches = linalg.chol_solve.launches
        counts.update(updater_s=0.0, reads=0)
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            ts = env.step(action())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            check(np.isfinite(ts.reward) and all(
                np.isfinite(v).all() for v in ts.observation.values()),
                f"host {name}: non-finite reward or observation")
        launches = linalg.chol_solve.launches
        branch_launches = dict(linalg.chol_solve.branch_launches)
        check_branch(linalg, f"host {name}", env.physics.model, launches,
                     branch_launches)
        updater_ms = 1e3 * counts["updater_s"] / steps
        reads = counts["reads"] / steps
    check(int(ts.step_type) == 1, f"host {name}: step type {ts.step_type}")
    substeps = env._n_sub_steps
    per_step = (launches - reset_launches) / steps
    check(per_step >= 3 * substeps,
          f"host {name}: chol_solve launched {per_step} times a control "
          f"step of {substeps} substeps (< 3 a substep)")
    kernels, busy_ms, wall_ms = _idle_share(lambda: env.step(action()),
                                            f"host {name}")
    warm = times[1:]
    return dict(task=name, nv=env.physics.model.nv, launches=launches,
                branch_launches=branch_launches,
                reset_launches=reset_launches, per_step=per_step,
                substeps=substeps, steps_per_s=len(warm) / sum(warm),
                first_ms=1e3 * times[0], reset_s=reset_s,
                updater_ms=updater_ms, reads=reads,
                step_ms=1e3 * float(np.median(warm)),
                kernels_per_step=kernels, busy_ms=busy_ms,
                profiled_ms=wall_ms, idle_share=1 - busy_ms / wall_ms)


def phase_host_selfcheck(manipulation, linalg):
    """Phase 12 (d): ``manipulation.load(HOST_SELFCHECK)`` in float64 on
    the card, a reset and the control steps through the kernel, and again
    under ``reference_solves()`` with the same seed and actions.  Returns
    the largest reward difference, the largest observation difference
    (``HOST_SELFCHECK_SCALED``: over its scale, and absolute), the
    kernel's launches and nv."""
    name, seed, steps = HOST_SELFCHECK
    runs = []
    for plain in (False, True):
        env = manipulation.load(name, seed=seed, dtype=torch.float64)
        spec = env.action_spec()
        rng = np.random.RandomState(2)
        n0 = linalg.chol_solve.launches
        with linalg.reference_solves() if plain else contextlib.nullcontext():
            out = [env.reset()]
            for _ in range(steps):
                out.append(env.step(rng.uniform(spec.minimum,
                                                 spec.maximum)))
        runs.append((out, linalg.chol_solve.launches - n0))
    (k_out, n_k), (p_out, n_p) = runs
    nv = env.physics.model.nv
    check(n_k >= 3 * steps * env._n_sub_steps and n_p == 0,
          f"host selfcheck: {n_k} kernel launches through the kernel, "
          f"{n_p} under reference_solves()")
    dabs = {k: max(float(np.abs(a.observation[k] - b.observation[k]).max())
                   for a, b in zip(k_out, p_out))
            for k in k_out[0].observation}
    scaled = {k: dabs[k] / max(float(np.abs(ts.observation[k]).max())
                               for ts in k_out) for k in HOST_SELFCHECK_SCALED}
    worst = max((k for k in dabs if k not in scaled), key=dabs.get)
    drew = max(abs(a.reward - b.reward) for a, b in zip(k_out[1:], p_out[1:]))
    check(max(dabs[worst], drew, *scaled.values()) <= HOST_SELFCHECK_TOL,
          f"host selfcheck: kernel vs plain max |dobs| {dabs[worst]:.3e} "
          f"({worst}), |dreward| {drew:.3e}, {scaled} of their scale (<= "
          f"{HOST_SELFCHECK_TOL:g})")
    return dict(task=name, nv=nv, dobs=dabs[worst], worst=worst,
                scaled=scaled, scaled_abs={k: dabs[k] for k in scaled},
                drew=drew, launches=n_k)


def phase_host(manipulation, linalg, card):
    """Phase 12: composer's host path on the card."""
    t12 = time.perf_counter()
    phase_host_goldens(manipulation, card)
    compiles = phase_host_compiles(card)
    rate = phase_host_rate(manipulation, linalg, card)
    print(f"phase 12 host path: manipulation.load({rate['task']!r}) float32 "
          f"(nv={rate['nv']}) on the card, reset {rate['reset_s']:.2f} s "
          f"({rate['reset_launches']} chol_solve launches), "
          f"{HOST_RATE[1]} control steps: {rate['steps_per_s']:.3f} control "
          f"steps/s after the first ({rate['first_ms']:.1f} ms; median "
          f"{rate['step_ms']:.1f} ms), chol_solve launches "
          f"{rate['per_step']:.1f} a control step (>= 3 x "
          f"{rate['substeps']} substeps; {rate['launches']} in the path), "
          f"updater {rate['updater_ms']:.2f} ms of host time and "
          f"{rate['reads']:.1f} named reads of the physics a control step; "
          f"one profiled control step: {rate['kernels_per_step']} device "
          f"kernels, busy {rate['busy_ms']:.3f} ms of "
          f"{rate['profiled_ms']:.1f} ms, idle share "
          f"{rate['idle_share']:.4f} | {card}", flush=True)
    check_run = phase_host_selfcheck(manipulation, linalg)
    print(f"phase 12 selfcheck: manipulation.load({check_run['task']!r}) "
          f"float64 (nv={check_run['nv']}: the block kernel), reset and "
          f"{HOST_SELFCHECK[2]} control steps through "
          f"the kernel ({check_run['launches']} launches) vs "
          f"reference_solves(): max |dobs| {check_run['dobs']:.3e} "
          f"({check_run['worst']}), |dreward| {check_run['drew']:.3e}, "
          + ", ".join(f"{k} {v:.3e} of its scale ("
                      f"{check_run['scaled_abs'][k]:.3e} absolute)"
                      for k, v in check_run['scaled'].items())
          + f" <= {HOST_SELFCHECK_TOL:g}; "
          f"phase 12 in {time.perf_counter() - t12:.1f} s | {card}",
          flush=True)
    return compiles, rate, check_run


def loco_host_env(name, dtype=torch.float64):
    """The port's locomotion host environment of a golden's name on the
    card, as the JAX one was built (``tools/export_torch_assets.py``'s
    ``loco_env``): a soccer match from ``rl.golden.SOCCER_EPISODES``, the
    rest with seed ``LOCO_HOST_SEED``, an example's after numpy's global
    state is seeded with it (the corridors draw their layout from it)."""
    from dm_control_torch import composer
    from dm_control_torch.locomotion import soccer
    from dm_control_torch.rl import golden

    if name in golden.SOCCER_EPISODES:
        return soccer.load(**golden.SOCCER_EPISODES[name], dtype=dtype)
    if name in LOCO_EXAMPLES:
        from dm_control_torch.locomotion.examples import basic

        np.random.seed(LOCO_HOST_SEED)
        return getattr(basic, name)(random_state=LOCO_HOST_SEED,
                                    dtype=dtype)
    task, limit = tracking_task(name)
    return composer.Environment(task, time_limit=limit,
                                random_state=LOCO_HOST_SEED, dtype=dtype)


def phase_loco_goldens(linalg, card, names=LOCO_HOST_GOLDENS, phase=13):
    """Phase 13 (a), and 14 (b) for the examples: each locomotion host
    episode golden of ``names`` replayed in float64 on the card one control
    step at a time (``rl/golden.py``): the reset's draws exact (qpos, the
    drawn pitch's geom sizes, the placed targets), every timestep within
    the gate.  Returns the kernel's launches in each replay, counted from 0
    at its start, and the same by branch."""
    from dm_control_torch.rl import golden

    launches, branch_launches = {}, {}
    for name in names:
        with np.load(os.path.join(ROOT, "tests", "data",
                                  f"torch_locomotion_env_{name}_f64.npz"),
                     allow_pickle=False) as z:
            gold = {k: z[k] for k in z.files}
        env = loco_host_env(name)
        check(env.physics.model.device.type == "cuda",
              f"host golden {name}: the environment left the card")
        torch.cuda.synchronize()
        reset_counts(linalg)
        t0 = time.perf_counter()
        errs = golden.host_episode_errors(env, gold)
        seconds = time.perf_counter() - t0
        launches[name] = linalg.chol_solve.launches
        branch_launches[name] = dict(linalg.chol_solve.branch_launches)
        check_branch(linalg, f"host golden {name}", env.physics.model,
                     launches[name], branch_launches[name])
        figures, ok = golden.episode_gate(errs, gold, name)
        check(ok, f"host golden {name}: gate failed, figures "
                  f"{[(f'{a:.3e}', f'{b:.3e}') for a, b in figures]}")
        reset = {k: v for k, v in errs[0].items()
                 if k == "step_qpos" or k.startswith("model_")}
        check(not any(reset.values()),
              f"host golden {name}: the reset's draws differ: {reset}")
        check(launches[name] > 0,
              f"host golden {name}: chol_solve was not launched")
        rest = max(a for a, _ in figures)
        rel = max(b for _, b in figures)
        print(f"phase {phase} golden: float64 {name} (nv="
              f"{env.physics.model.nv}) on the card vs the JAX episode, "
              f"reset and {len(figures) - 1} control steps each from the "
              f"recorded state in {seconds:.1f} s ({launches[name]} "
              f"chol_solve launches, all on the "
              f"{linalg.kernel_branch(env.physics.model.nv, torch.float64)}"
              f" kernel): reset qpos and "
              f"{', '.join(k[6:] for k in reset if k != 'step_qpos')} exact; "
              f"gate: all but qacc_warmstart {rest:.3e} <= 1e-9, "
              f"qacc_warmstart {rel:.3e} of its scale <= 1e-12 | {card}",
              flush=True)
    return launches, branch_launches


def phase_loco_compiles(card):
    """Phase 13 (b): the four locomotion entity trees with reference files
    (soccer 1 and 2 a side as ``load_batch`` builds them, the two tracking
    tasks) compiled onto the card in float64 as ``compile_task`` compiles
    them, each held to its file, with its host milliseconds."""
    from dm_control_torch.composer.batch import task_model
    from dm_control_torch.locomotion import soccer

    rows = []
    for tree in LOCO_TREES:
        if tree.startswith("soccer"):
            task = soccer.Task(
                players=soccer.task.standard_players(int(tree[-1])),
                arena=soccer.Pitch(size=(12, 9), field_box=True),
                ball=soccer.SoccerBall())
        else:
            task = tracking_task(tree)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = task_model(task, "cuda", torch.float64)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        check(m.qpos0.device.type == "cuda" and m.dtype == torch.float64,
              f"compile {tree}: model not float64 on the card")
        note = hold_to_reference(m, os.path.join(
            ROOT, "dm_control_torch", "locomotion", "assets",
            f"{tree}.npz"), tree)
        rows.append(dict(tree=tree, nv=m.nv, compile_ms=ms))
        print(f"phase 13 compile: {tree} (nv={m.nv}) entity tree onto the "
              f"card in float64 in {ms:.1f} ms (host clock); {note} | "
              f"{card}", flush=True)
    return rows


def phase_loco_rate(linalg):
    """Phase 13 (c): ``soccer.load()`` (2 a side, a pitch drawn and
    compiled every episode) on the card in float32, a reset and
    ``LOCO_RATE_STEPS`` control steps with the kernel's launch count set
    to 0 just before the reset and read after the last step; the
    updater's host time, the named reads, the contact scans and the
    recompile; then one more control step under ``torch.profiler``."""
    from dm_control_torch.locomotion import soccer

    env = soccer.load(random_state=0, dtype=torch.float32)
    check(env.physics.model.device.type == "cuda",
          "soccer.load left the card")
    spec = env.action_spec()
    rng = np.random.RandomState(1)

    def action():
        return rng.uniform(spec.minimum, spec.maximum)

    steps = LOCO_RATE_STEPS
    with host_counters() as counts:
        torch.cuda.synchronize()
        reset_counts(linalg)
        t0 = time.perf_counter()
        ts = env.reset()
        torch.cuda.synchronize()
        reset_s = time.perf_counter() - t0
        reset_launches = linalg.chol_solve.launches
        check(counts["recompiles"] == 1,
              f"soccer.load(): {counts['recompiles']} compiles at the reset")
        recompile_ms = 1e3 * counts["recompile_s"]
        counts.update(updater_s=0.0, reads=0, contacts_s=0.0,
                      contact_scans=0)
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            ts = env.step(action())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            check(np.shape(ts.reward) == (4,) and np.isfinite(ts.reward).all()
                  and all(np.isfinite(v).all()
                          for v in ts.observation.values()),
                  "soccer.load(): bad reward or non-finite observation")
        launches = linalg.chol_solve.launches
        branch_launches = dict(linalg.chol_solve.branch_launches)
        check_branch(linalg, "soccer.load()", env.physics.model, launches,
                     branch_launches)
        updater_ms = 1e3 * counts["updater_s"] / steps
        reads = counts["reads"] / steps
        scans = counts["contact_scans"] / steps
        contacts_ms = 1e3 * counts["contacts_s"] / steps
    check(int(ts.step_type) == 1, f"soccer.load(): step type {ts.step_type}")
    substeps = env._n_sub_steps
    per_step = (launches - reset_launches) / steps
    check(per_step >= 3 * substeps,
          f"soccer.load(): chol_solve launched {per_step} times a control "
          f"step of {substeps} substeps (< 3 a substep)")
    kernels, busy_ms, wall_ms = _idle_share(lambda: env.step(action()),
                                            "soccer.load()")
    warm = times[1:]
    return dict(task="soccer.load()", nv=env.physics.model.nv,
                pitch=env.task.arena.size, launches=launches,
                branch_launches=branch_launches,
                reset_launches=reset_launches, per_step=per_step,
                substeps=substeps, steps_per_s=len(warm) / sum(warm),
                first_ms=1e3 * times[0], reset_s=reset_s,
                recompile_ms=recompile_ms, updater_ms=updater_ms,
                reads=reads, scans=scans, contacts_ms=contacts_ms,
                step_ms=1e3 * float(np.median(warm)),
                kernels_per_step=kernels, busy_ms=busy_ms,
                profiled_ms=wall_ms, idle_share=1 - busy_ms / wall_ms)


def phase_loco_selfcheck(linalg):
    """Phase 13 (d): ``LOCO_SELFCHECK``'s tracking task in float64 on the
    card through ``composer.Environment``, a reset and the control steps
    through the kernel, and again under ``reference_solves()`` with the
    same seed and actions.  Returns the largest reward difference, the
    largest observation difference over max(1, its largest entry), the
    kernel's launches and nv."""
    from dm_control_torch import composer

    asset, seed, steps = LOCO_SELFCHECK
    runs = []
    for plain in (False, True):
        task, limit = tracking_task(asset)
        env = composer.Environment(task, time_limit=limit, random_state=seed,
                                   dtype=torch.float64)
        spec = env.action_spec()
        rng = np.random.RandomState(2)
        n0 = linalg.chol_solve.launches
        with linalg.reference_solves() if plain else contextlib.nullcontext():
            out = [env.reset()]
            for _ in range(steps):
                out.append(env.step(rng.uniform(spec.minimum,
                                                 spec.maximum)))
        runs.append((out, linalg.chol_solve.launches - n0))
    (k_out, n_k), (p_out, n_p) = runs
    check(n_k >= 3 * steps * env._n_sub_steps and n_p == 0,
          f"tracking selfcheck: {n_k} kernel launches through the kernel, "
          f"{n_p} under reference_solves()")
    scaled = {}
    for k in k_out[0].observation:
        scale = max(1.0, max(float(np.abs(ts.observation[k]).max())
                             for ts in k_out))
        scaled[k] = max(float(np.abs(a.observation[k]
                                     - b.observation[k]).max())
                        for a, b in zip(k_out, p_out)) / scale
    worst = max(scaled, key=scaled.get)
    drew = max(abs(a.reward - b.reward) for a, b in zip(k_out[1:], p_out[1:]))
    check(scaled[worst] <= LOCO_SELFCHECK_TOL and drew <= LOCO_SELFCHECK_TOL,
          f"tracking selfcheck: kernel vs plain max |dobs| "
          f"{scaled[worst]:.3e} of max(1, scale) ({worst}), |dreward| "
          f"{drew:.3e} (<= {LOCO_SELFCHECK_TOL:g})")
    check(all(int(ts.step_type) == 1 for ts in k_out[1:]),
          "tracking selfcheck: the episode ended early")
    return dict(task=asset, nv=env.physics.model.nv, dobs=scaled[worst],
                worst=worst, drew=drew, launches=n_k)


def phase_loco(linalg, card):
    """Phase 13: locomotion's host path on the card."""
    t13 = time.perf_counter()
    golden_launches = phase_loco_goldens(linalg, card)
    compiles = phase_loco_compiles(card)
    rate = phase_loco_rate(linalg)
    print(f"phase 13 host path: soccer.load() float32 (nv={rate['nv']}, "
          f"pitch {rate['pitch'][0]:.2f} x {rate['pitch'][1]:.2f}) on the "
          f"card, reset {rate['reset_s']:.2f} s ({rate['reset_launches']} "
          f"chol_solve launches; the drawn pitch compiled in "
          f"{rate['recompile_ms']:.1f} ms), {LOCO_RATE_STEPS} control steps: "
          f"{rate['steps_per_s']:.3f} control steps/s after the first "
          f"({rate['first_ms']:.1f} ms; median {rate['step_ms']:.1f} ms), "
          f"chol_solve launches {rate['per_step']:.1f} a control step (>= 3 "
          f"x {rate['substeps']} substeps; {rate['launches']} in the path), "
          f"updater {rate['updater_ms']:.2f} ms of host time and "
          f"{rate['reads']:.1f} named reads of the physics a control step, "
          f"{rate['scans']:.1f} contact scans ({rate['contacts_ms']:.2f} ms) "
          f"a control step; one profiled control step: "
          f"{rate['kernels_per_step']} device kernels, busy "
          f"{rate['busy_ms']:.3f} ms of {rate['profiled_ms']:.1f} ms, idle "
          f"share {rate['idle_share']:.4f} | {card}", flush=True)
    check_run = phase_loco_selfcheck(linalg)
    print(f"phase 13 selfcheck: {check_run['task']} float64 (nv="
          f"{check_run['nv']}: the block kernel) through "
          f"composer.Environment, reset and {LOCO_SELFCHECK[2]} control "
          f"steps through the kernel ({check_run['launches']} launches) vs "
          f"reference_solves(): max |dobs| {check_run['dobs']:.3e} of "
          f"max(1, its scale) ({check_run['worst']}), |dreward| "
          f"{check_run['drew']:.3e} <= {LOCO_SELFCHECK_TOL:g}; phase 13 in "
          f"{time.perf_counter() - t13:.1f} s | {card}", flush=True)
    return golden_launches, compiles, rate, check_run


def phase_examples_rate(linalg, name, build=None):
    """Phase 14 (a), and 15 (a): one example environment (or the one
    ``build()`` gives) on the card in float32: its build (the tree
    compiled onto the card), a reset and ``LOCO_EXAMPLE_STEPS`` control
    steps with the kernel's launch count set to 0 just before the reset
    and read after the last step, finite rewards and observations; the
    steps before the last timed on the host's clock, the last under
    ``torch.profiler`` (a rat's control step takes seconds: one fewer
    keeps phase 14 within its time)."""
    from dm_control_torch.locomotion.examples import basic

    np.random.seed(0)  # the corridors' layout
    with host_counters() as counts:
        t0 = time.perf_counter()
        env = (build() if build is not None else
               getattr(basic, name)(random_state=0, dtype=torch.float32))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    m = env.physics.model
    check(m.qpos0.device.type == "cuda" and m.dtype == torch.float32,
          f"{name}: the model is not float32 on the card")
    check(counts["recompiles"] == 1,
          f"{name}: {counts['recompiles']} compiles at the build")
    spec = env.action_spec()
    rng = np.random.RandomState(1)

    def action():
        return rng.uniform(spec.minimum, spec.maximum)

    def finite(ts):
        return (np.all(np.isfinite(ts.reward)) and all(
            np.isfinite(np.asarray(v)).all()
            for v in ts.observation.values()))

    torch.cuda.synchronize()
    reset_counts(linalg)
    t0 = time.perf_counter()
    ts = env.reset()
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    reset_launches = linalg.chol_solve.launches
    check(all(np.isfinite(np.asarray(v)).all()
              for v in ts.observation.values()),
          f"{name}: a non-finite observation at the reset")
    times, steps = [], []
    for _ in range(LOCO_EXAMPLE_STEPS - 1):
        t0 = time.perf_counter()
        steps.append(env.step(action()))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    # a profiler retry steps once more: each step taken is checked, counted
    kernels, busy_ms, wall_ms = _idle_share(
        lambda: steps.append(env.step(action())), f"example {name}")
    kinds = [int(ts.step_type) for ts in steps]
    check(all(finite(ts) for ts in steps),
          f"{name}: a non-finite reward or observation")
    launches = linalg.chol_solve.launches
    branch_launches = dict(linalg.chol_solve.branch_launches)
    check_branch(linalg, name, env.physics.model, launches, branch_launches)
    substeps = env._n_sub_steps
    per_step = (launches - reset_launches) / len(steps)
    # the unprofiled steps' times, else the profiled step's wall
    step_ms = [1e3 * t for t in times] or [wall_ms]
    check(per_step >= 3 * substeps,
          f"{name}: chol_solve launched {per_step} times a control step of "
          f"{substeps} substeps (< 3 a substep)")
    return dict(task=name, nv=m.nv, pairs=len(m.collision_pairs),
                candidates=len(env.physics.data.contact.dim),
                substeps=substeps, build_s=build_s,
                compile_ms=1e3 * counts["recompile_s"], reset_s=reset_s,
                reset_launches=reset_launches, launches=launches,
                branch_launches=branch_launches,
                per_step=per_step, step_types=kinds,
                steps_per_s=1e3 * len(step_ms) / sum(step_ms),
                step_ms=step_ms, kernels_per_step=kernels,
                busy_ms=busy_ms, profiled_ms=wall_ms,
                idle_share=1 - busy_ms / wall_ms)


def _example_step(env, gold, t, plain, linalg):
    """One control step of ``env`` from the recording's state and action
    at timestep ``t`` (``_step_from``)."""
    from dm_control_torch.rl import golden

    return _step_from(env, {f: gold[f"t{t}_step_{f}"]
                            for f in golden.EPISODE_STATE_FIELDS},
                      gold["actions"][t], plain, linalg)


def _step_from(env, state, action, plain, linalg):
    """One control step of ``env`` from ``state`` (host arrays of
    ``EPISODE_STATE_FIELDS``) with ``action``, through the kernel or under
    ``reference_solves()``: (observations, reward, qpos and qvel) as
    float64 host arrays."""
    env.physics.set_data(**state)
    with linalg.reference_solves() if plain else contextlib.nullcontext():
        ts = env.step(action)
    d = env.physics.data
    return {"obs": np.concatenate([np.ravel(np.asarray(v, np.float64))
                                   for v in ts.observation.values()]),
            "reward": np.asarray([ts.reward], np.float64),
            "state": torch.cat([d.qpos, d.qvel]).double().cpu().numpy()}


def phase_examples_selfcheck(linalg):
    """Phase 14 (c): the rat's example (``LOCO_EXAMPLE_SELFCHECK``) on the
    card in float32 and float64: one environment reset, then each control
    step taken twice from the recording's state and action, through the
    kernel and under ``reference_solves()`` (the two-touch task's state
    stays as the reset left it: the rat is far from the target in these
    steps).  float64: the kernel
    held to the plain step within 1e-9 absolute, or, where the plain step
    is more than 1e-9 from the JAX recording, to the recording (as
    ``phase_golden_selfcheck``); float32: within ``LOCO_EXAMPLE_F32_TOL``
    of max(1, each group's largest |entry|).  Returns per type the largest
    figure of each group, the timesteps whose step is held to the
    recording (with the plain step's distance from it) and the kernel's
    launches."""
    name, steps = LOCO_EXAMPLE_SELFCHECK
    with np.load(os.path.join(ROOT, "tests", "data",
                              f"torch_locomotion_env_{name}_f64.npz"),
                 allow_pickle=False) as z:
        gold = {k: z[k] for k in z.files}
    out = {}
    for dtype in (torch.float32, torch.float64):
        env = loco_host_env(name, dtype=dtype)
        env.reset()
        worst = {"obs": 0.0, "reward": 0.0, "state": 0.0}
        held = []
        n_k = n_p = 0
        for t in steps:
            n0 = linalg.chol_solve.launches
            kernel = _example_step(env, gold, t, False, linalg)
            n1 = linalg.chol_solve.launches
            plain = _example_step(env, gold, t, True, linalg)
            n_k += n1 - n0
            n_p += linalg.chol_solve.launches - n1
            if dtype == torch.float64:
                recorded = {
                    "obs": np.concatenate([np.ravel(gold[k]) for k in gold
                                           if k.startswith(f"t{t + 1}_obs_")]),
                    "reward": np.asarray([gold[f"t{t + 1}_reward"]]),
                    "state": np.concatenate([gold[f"t{t + 1}_step_qpos"],
                                             gold[f"t{t + 1}_step_qvel"]])}
                off = max(float(np.abs(plain[g] - recorded[g]).max())
                          for g in plain)
                ref = plain
                if off > 1e-9:
                    held.append((t, off))
                    ref = recorded
                for g in worst:
                    worst[g] = max(worst[g], float(np.abs(
                        kernel[g] - ref[g]).max()))
            else:
                for g in worst:
                    worst[g] = max(worst[g], float(np.abs(
                        kernel[g] - plain[g]).max()) / max(
                            1.0, float(np.abs(plain[g]).max())))
        what = f"{name} {str(dtype).replace('torch.', '')} selfcheck"
        check(n_k >= 3 * len(steps) * env._n_sub_steps and n_p == 0,
              f"{what}: {n_k} kernel launches through the kernel, {n_p} "
              f"under reference_solves()")
        gate = 1e-9 if dtype == torch.float64 else LOCO_EXAMPLE_F32_TOL
        check(max(worst.values()) <= gate,
              f"{what}: kernel vs plain {worst} (<= {gate:g})")
        out[dtype] = dict(worst=worst, held=held, launches=n_k,
                          nv=env.physics.model.nv)
    return out


def phase_examples(linalg, card):
    """Phase 14: locomotion's example environments on the card."""
    t14 = time.perf_counter()
    rates = []
    for name in LOCO_EXAMPLES:
        r = phase_examples_rate(linalg, name)
        rates.append(r)
        print(f"phase 14 example: {name} float32 (nv={r['nv']}, "
              f"{r['pairs']} candidate pairs, {r['candidates']} contact "
              f"rows, {r['substeps']} substeps a control step) on the card: "
              f"built in {r['build_s']:.2f} s (the tree compiled in "
              f"{r['compile_ms']:.1f} ms), reset {r['reset_s']:.2f} s "
              f"({r['reset_launches']} chol_solve launches), "
              f"{len(r['step_types'])} control steps (step types "
              f"{r['step_types']}): {r['steps_per_s']:.3f} control steps/s "
              f"(ms {[round(t, 1) for t in r['step_ms']]}; the profiled "
              f"step's wall without another), chol_solve launches "
              f"{r['per_step']:.1f} a control "
              f"step ({r['launches']} in the path); the last control step "
              f"profiled: "
              f"{r['kernels_per_step']} device kernels, busy "
              f"{r['busy_ms']:.3f} ms of {r['profiled_ms']:.1f} ms, idle "
              f"share {r['idle_share']:.4f} | {card}", flush=True)
    golden_launches = phase_loco_goldens(linalg, card, LOCO_EXAMPLE_GOLDENS,
                                         14)
    checks = phase_examples_selfcheck(linalg)
    for dtype, c in checks.items():
        w = c["worst"]
        kind = ("absolute <= 1e-9" if dtype == torch.float64 else
                f"of max(1, scale) <= {LOCO_EXAMPLE_F32_TOL:g}")
        held = "".join(f"; timestep {t} held to the JAX recording (the "
                       f"plain step {d:.3e} from it)" for t, d in c["held"])
        print(f"phase 14 selfcheck: {LOCO_EXAMPLE_SELFCHECK[0]} "
              f"{str(dtype).replace('torch.', '')} (nv={c['nv']}: the "
              f"block kernel), control steps from the "
              f"recorded timesteps {LOCO_EXAMPLE_SELFCHECK[1]} through the "
              f"kernel ({c['launches']} launches) vs reference_solves(): "
              f"obs {w['obs']:.3e}, reward {w['reward']:.3e}, state "
              f"{w['state']:.3e} {kind}{held} | {card}", flush=True)
    print(f"phase 14 in {time.perf_counter() - t14:.1f} s | {card}",
          flush=True)
    return rates, golden_launches, checks


def _soccer_env(kwargs, dtype, seed=0):
    from dm_control_torch.locomotion import soccer

    return soccer.load(random_state=seed, dtype=dtype, **kwargs)


def phase_walkers_selfcheck(linalg):
    """Phase 15 (c): ``WALKER_SELFCHECK`` in float64 on the card, reset,
    then one control step from the reset's state taken twice, through the
    kernel (under ``profiled``: the card's busy time, and the global
    kernel's device time and share of it) and under ``reference_solves()``:
    every launch on the branch its nv names, none under the switch;
    observations, rewards and state within 1e-9 absolute.  Returns the
    largest difference of each group, the launches and nv, and the
    profile's figures."""
    from dm_control_torch.rl import golden

    env = _soccer_env(WALKER_SELFCHECK, torch.float64)
    env.reset()
    d = env.physics.data
    state = {f: getattr(d, f).cpu().numpy()
             for f in golden.EPISODE_STATE_FIELDS}
    spec = env.action_spec()
    action = np.random.RandomState(1).uniform(spec.minimum, spec.maximum)
    held = {}

    def kernel_step():  # a retry of the profile steps and counts anew
        reset_counts(linalg)
        held["kernel"] = _step_from(env, state, action, False, linalg)

    events, wall = profiled(kernel_step, "walker selfcheck's kernel step")
    kernel = held["kernel"]
    launches = linalg.chol_solve.launches
    branches = dict(linalg.chol_solve.branch_launches)
    solves = [e for e in events if "chol_solve_global_kernel" in e.name()]
    busy_ms = sum(e.duration_ns() for e in events) / 1e6
    global_ms = sum(e.duration_ns() for e in solves) / 1e6
    plain = _step_from(env, state, action, True, linalg)
    m = env.physics.model
    check_branch(linalg, "walker selfcheck", m, launches, branches)
    check(launches >= 3 * env._n_sub_steps
          and linalg.chol_solve.launches == launches,
          f"walker selfcheck: {launches} kernel launches through the "
          f"kernel, {linalg.chol_solve.launches - launches} under "
          f"reference_solves()")
    worst = {g: float(np.abs(kernel[g] - plain[g]).max()) for g in kernel}
    check(all(np.isfinite(v).all() for v in kernel.values()),
          "walker selfcheck: a non-finite value through the kernel")
    check(max(worst.values()) <= 1e-9,
          f"walker selfcheck: kernel vs plain {worst} (<= 1e-9)")
    return dict(worst=worst, launches=launches, branch_launches=branches,
                nv=m.nv, branch=linalg.kernel_branch(m.nv, m.dtype),
                busy_ms=busy_ms, profiled_ms=wall * 1e3, global_ms=global_ms,
                global_kernels=len(solves), global_share=global_ms / busy_ms)


def phase_large_match(linalg):
    """Phase 15 (d): ``LARGE_MATCH`` in float64 on the card: a reset and
    one control step, finite, every launch on the branch its nv names."""
    env = _soccer_env(LARGE_MATCH, torch.float64)
    reset_counts(linalg)
    t0 = time.perf_counter()
    ts = env.reset()
    spec = env.action_spec()
    ts = env.step(np.random.RandomState(1).uniform(spec.minimum,
                                                   spec.maximum))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    m = env.physics.model
    launches = linalg.chol_solve.launches
    branches = dict(linalg.chol_solve.branch_launches)
    check_branch(linalg, "large match", m, launches, branches)
    check(launches >= 3 * env._n_sub_steps,
          f"large match: {launches} chol_solve launches")
    check(ts.mid() and np.all(np.isfinite(ts.reward)) and all(
        np.isfinite(np.asarray(v)).all() for v in ts.observation.values()),
          "large match: a non-finite reward or observation")
    return dict(nv=m.nv, launches=launches, branch_launches=branches,
                seconds=seconds, branch=linalg.kernel_branch(m.nv, m.dtype),
                candidates=len(env.physics.data.contact.dim))


def phase_walkers(linalg, card):
    """Phase 15: soccer's ANT and HUMANOID players and the matches past
    the block kernel's first cap on the card."""
    t15 = time.perf_counter()
    name, kwargs = WALKER_RATE
    r = phase_examples_rate(linalg, name, lambda: _soccer_env(
        kwargs, torch.float32))
    branch = linalg.kernel_branch(r["nv"], torch.float32)
    print(f"phase 15 rate: {name} float32 (nv={r['nv']}: the {branch} "
          f"kernel, {r['pairs']} candidate pairs, {r['candidates']} contact "
          f"rows, {r['substeps']} substeps a control step) on the card: "
          f"built in {r['build_s']:.2f} s, reset {r['reset_s']:.2f} s "
          f"({r['reset_launches']} chol_solve launches), "
          f"{len(r['step_types'])} control steps: "
          f"{r['steps_per_s']:.3f} control steps/s (ms "
          f"{[round(t, 1) for t in r['step_ms']]}; the profiled step's "
          f"wall without another), "
          f"chol_solve launches {r['per_step']:.1f} a control step "
          f"({r['launches']} in the path, by branch "
          f"{r['branch_launches']}); the last control step profiled: "
          f"{r['kernels_per_step']} device kernels, busy "
          f"{r['busy_ms']:.3f} ms of {r['profiled_ms']:.1f} ms, idle "
          f"share {r['idle_share']:.4f} | {card}", flush=True)
    r["task"] = name
    golden_launches = phase_loco_goldens(linalg, card, WALKER_GOLDENS, 15)
    c = phase_walkers_selfcheck(linalg)
    w = c["worst"]
    print(f"phase 15 selfcheck: soccer humanoid 2v2 float64 (nv={c['nv']}: "
          f"the {c['branch']} kernel), one control step from the reset's "
          f"state through the kernel ({c['launches']} launches; profiled: "
          f"busy {c['busy_ms']:.3f} ms of {c['profiled_ms']:.1f} ms, the "
          f"global kernel {c['global_ms']:.3f} ms in {c['global_kernels']} "
          f"launches, {c['global_share']:.4f} of busy) vs "
          f"reference_solves(): obs {w['obs']:.3e}, reward "
          f"{w['reward']:.3e}, state {w['state']:.3e} absolute <= 1e-9 | "
          f"{card}", flush=True)
    big = phase_large_match(linalg)
    print(f"phase 15 large match: soccer BoxHead 10v10 float64 (nv="
          f"{big['nv']}: the {big['branch']} kernel, {big['candidates']} "
          f"contact rows) on its drawn pitch, reset and one control step in "
          f"{big['seconds']:.1f} s, {big['launches']} chol_solve launches, "
          f"finite | {card}", flush=True)
    print(f"phase 15 in {time.perf_counter() - t15:.1f} s | {card}",
          flush=True)
    big["task"] = "soccer boxhead 10v10"
    return r, golden_launches, c, big


def frame_profile(render, what):
    """One frame: ``render()`` under ``torch.profiler``, the window padded
    as ``profiled`` pads it.  Returns the frame, the card's kernels in it
    and the bytes copied from the card to the host, both read from the
    exported trace (the raw events carry no memory copy's size)."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            frame = render()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        kernels = sum(e.get("cat") == "kernel" for e in events)
        d2h = sum(int(e.get("args", {}).get("bytes", 0)) for e in events
                  if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"])
        if kernels:
            return frame, kernels, d2h
        print(f"chip_smoke: torch.profiler saw no kernel in {what} (attempt "
              f"{attempt} of {PROFILE_ATTEMPTS})", file=sys.stderr,
              flush=True)
    check(False, f"torch.profiler saw no kernel on the device in {what} "
                 f"({PROFILE_ATTEMPTS} attempts)")


def render_frames_fps(render, frames=RENDER_TIMED_FRAMES):
    """Frames a second of ``render`` (which returns a host array) on the
    host's clock after one warm-up frame."""
    render()
    t0 = time.perf_counter()
    for _ in range(frames):
        render()
    return frames / (time.perf_counter() - t0)


def cpu_twin(physics):
    """A ``Physics`` on the CPU with a copy of ``physics``' model and of
    its state (the batched Data behind the view)."""
    from dm_control_torch.physics import model_io
    from dm_control_torch.physics.model import map_tensors
    from dm_control_torch.physics.physics import Physics

    return Physics(model_io.to(physics.model, "cpu", physics.model.dtype),
                   map_tensors(physics._data, lambda t: t.cpu()))


def check_frames(ours, ref, what):
    """``ours`` (the card's) against ``ref`` within the render gate;
    returns the figures."""
    from dm_control_torch.rendering import golden

    fig = golden.frame_figures(ours, ref)
    check(golden.within_gate(fig),
          f"{what}: frames {fig} outside the gate {golden.GATE}")
    return fig


def render_item(camera, what, item):
    """Profiles one rgb frame of ``camera`` (kernels, bytes to the host),
    checks the bytes against the image's, times ``RENDER_TIMED_FRAMES``
    frames and holds the card's rgb, depth and segmentation of the state
    to the same camera's on the CPU twin of the physics: the figures
    land in ``item``."""
    from dm_control_torch.rendering import golden
    from dm_control_torch.rendering.camera import Camera, MovableCamera

    frame, kernels, d2h = frame_profile(camera.render, what)
    h, w = camera.height, camera.width
    check(frame.shape == (h, w, 3) and frame.dtype == np.uint8,
          f"{what}: a frame of {frame.shape} {frame.dtype}")
    check(h * w * 3 <= d2h <= frame.nbytes + RENDER_D2H_SLACK,
          f"{what}: {d2h} bytes from the card in a frame of "
          f"{frame.nbytes} bytes (allowed: the image and "
          f"{RENDER_D2H_SLACK})")
    fps = render_frames_fps(camera.render)
    twin = cpu_twin(camera._physics)
    if isinstance(camera, MovableCamera):
        cpu = MovableCamera(twin, h, w)
        cpu.set_pose(*camera.get_pose())
    else:
        cpu = Camera(twin, h, w, camera._camera_id)
    fig = check_frames(golden.camera_frames(camera),
                       golden.camera_frames(cpu), f"{what} against the CPU")
    item.update(kernels=kernels, d2h=d2h, image_bytes=frame.nbytes,
                render_fps=fps, cpu=fig, size=(h, w))
    return frame


def render_line(letter, what, item, card):
    h, w = item["size"]
    extra = "".join(f", {k} {v}" for k, v in item.get("notes", {}).items())
    print(f"phase 16 ({letter}) {what}: {h}x{w} frames, "
          f"{item['render_fps']:.2f} frames/s rendered, "
          f"{item['kernels']} device kernels and {item['d2h']} bytes to the "
          f"host a frame (the image {item['image_bytes']}), peak "
          f"{item['peak_gb']:.3f} GB; card vs CPU frames {item['cpu']}"
          f"{extra} | {card}", flush=True)


def _launches(linalg, what, model, item):
    launches = linalg.chol_solve.launches
    branches = dict(linalg.chol_solve.branch_launches)
    check_branch(linalg, what, model, launches, branches)
    item.update(launches=launches, branch_launches=branches)


def phase_render_pixels(linalg, item):
    """(a): ``pixels.Wrapper`` over humanoid_CMU:run in float32 on the
    card, camera 0: a reset and ``RENDER_STEPS`` control steps."""
    from dm_control_torch import suite
    from dm_control_torch.rendering.camera import Camera
    from dm_control_torch.suite.wrappers import pixels

    env = pixels.Wrapper(suite.load("humanoid_CMU", "run",
                                    task_kwargs={"random": 3},
                                    dtype=torch.float32))
    spec = env.action_spec()
    rng = np.random.RandomState(1)
    torch.cuda.synchronize()
    reset_counts(linalg)
    t0 = time.perf_counter()
    steps = [env.reset()]
    for _ in range(RENDER_STEPS):
        steps.append(env.step(rng.uniform(spec.minimum, spec.maximum)))
    seconds = time.perf_counter() - t0
    m = env.physics.model
    _launches(linalg, "render (a)", m, item)
    check(all(ts.observation["pixels"].shape == (240, 320, 3)
              and ts.observation["pixels"].dtype == np.uint8
              for ts in steps), "render (a): a pixels observation's spec")
    check(np.array_equal(steps[-1].observation["pixels"],
                         env.physics.render(240, 320, 0)),
          "render (a): the observation is not the physics' frame")
    render_item(Camera(env.physics, 240, 320, 0), "render (a)", item)
    item["notes"] = {
        "env frames/s (reset and steps, each observed in pixels)":
            round(len(steps) / seconds, 3),
        "chol_solve launches": item["launches"],
        "by branch": item["branch_launches"]}


def phase_render_hfield(item):
    """(b): quadruped:escape's physics.render of the height field's box,
    rgb, depth and segmentation, from the camera that frames it."""
    from dm_control_torch import suite
    from dm_control_torch.physics.model import GeomType
    from dm_control_torch.rendering.camera import Camera

    env = suite.load("quadruped", "escape", task_kwargs={"random": 3},
                     dtype=torch.float32)
    env.reset()
    m = env.physics.model
    cam = Camera(env.physics, 240, 320, "y")
    render_item(cam, "render (b)", item)
    seg = env.physics.render(240, 320, "y", segmentation=True)[..., 0]
    hfield = m.geom_type.index(int(GeomType.HFIELD))
    depth = env.physics.render(240, 320, "y", depth=True)
    check(bool((seg == hfield).any()) and np.all(
        (depth > 0) == (seg >= 0)), "render (b): the height field's box is "
                                    "not in the frame")
    item["notes"] = {"height field box pixels": int((seg == hfield).sum())}


def phase_render_manipulation(item):
    """(c): stack_3_bricks_vision with the front_close camera: an 84x84
    ``physics.render`` and a ``MujocoCamera`` observable of it, and an
    inline mesh model's k-DOP on the card (the Jaco here is built of
    primitives: no model of the port's tasks has a mesh)."""
    from dm_control_torch.composer.observation import MujocoCamera
    from dm_control_torch.physics.physics import Physics
    from dm_control_torch.rendering import golden
    from dm_control_torch.rendering.camera import Camera

    env, _ = golden.stack_3_bricks_vision("cuda", torch.float32, 3)
    env.reset()
    physics = env.physics
    frame = render_item(Camera(physics, 84, 84, "front_close"),
                        "render (c)", item)
    observed = MujocoCamera("front_close", height=84, width=84)(physics)
    check(np.array_equal(observed, frame),
          "render (c): the MujocoCamera observable is not the frame")
    mesh = Physics.from_xml_string(MESH_XML, dtype=torch.float32)
    mesh.forward()
    fig = check_frames(
        golden.camera_frames(Camera(mesh, 96, 96, 0)),
        golden.camera_frames(Camera(cpu_twin(mesh), 96, 96, 0)),
        "render (c) mesh against the CPU")
    seg = mesh.render(96, 96, 0, segmentation=True)[..., 0]
    item["notes"] = {"mesh k-DOP pixels": int((seg == 0).sum()),
                     "mesh card vs CPU": fig}


def phase_render_soccer(linalg, item):
    """(d): a soccer.Task two a side with a MultiplayerTrackingCamera at
    its default 1920x1080: a reset and ``RENDER_SOCCER_STEPS`` control
    steps, a frame after each."""
    from dm_control_torch.rendering import golden

    env, cam = golden.soccer_tracked("cuda", torch.float32, 3)
    spec = env.action_spec()
    rng = np.random.RandomState(1)
    torch.cuda.synchronize()
    reset_counts(linalg)
    t0 = time.perf_counter()
    env.reset()
    frames = [cam.render()]
    poses = [cam.camera.get_pose()]
    for _ in range(RENDER_SOCCER_STEPS):
        env.step(rng.uniform(spec.minimum, spec.maximum))
        frames.append(cam.render())
        poses.append(cam.camera.get_pose())
    seconds = time.perf_counter() - t0
    _launches(linalg, "render (d)", env.physics.model, item)
    check(all(f.shape == (1080, 1920, 3) for f in frames),
          "render (d): a tracking frame is not 1920x1080")
    check(len({p.distance for p in poses}) > 1,
          "render (d): the tracking camera did not move")
    render_item(cam.camera, "render (d)", item)
    item["notes"] = {
        "env frames/s (reset and steps, a 1080p frame each)":
            round(len(frames) / seconds, 3),
        "chol_solve launches": item["launches"],
        "by branch": item["branch_launches"]}


def phase_render_viewer(linalg, item):
    """(e): the headless viewer Application on cartpole:swingup for
    ``VIEWER_FRAMES`` frames, then a click-select and a perturbation on
    the card."""
    from dm_control_torch import suite, viewer
    from dm_control_torch.rendering.camera import MovableCamera
    from dm_control_torch.viewer.viewer import Viewer, apply_perturbation

    env = suite.load("cartpole", "swingup", task_kwargs={"random": 3})
    frames = []

    def on_frame(frame, runtime):
        frames.append(frame)
        if len(frames) == VIEWER_FRAMES:
            runtime.stop()

    app = viewer.Application(width=320, height=240)
    app.set_frame_callback(on_frame)
    torch.cuda.synchronize()
    reset_counts(linalg)
    t0 = time.perf_counter()
    app.launch(env, max_episodes=1)
    seconds = time.perf_counter() - t0
    check(len(frames) == VIEWER_FRAMES and all(f.shape == (240, 320, 3)
                                               for f in frames),
          f"render (e): {len(frames)} viewer frames")
    cam = MovableCamera(env.physics, 240, 320)
    view = Viewer(cam, env.physics, n_fixed_cameras=env.physics.model.ncam)
    body = view.select_at((160, 120))
    check(body is not None, "render (e): the click selected nothing")
    view.manipulator.set_move_horizontal_mode(True)
    view.manipulator.on_move((160, 120), (20.0, 0.0))
    bid, force = view.manipulator.perturbation_force
    check(apply_perturbation(env, bid, force), "render (e): no live state")
    xfrc = env.physics.data.xfrc_applied
    check(xfrc.device.type == "cuda" and float(xfrc[bid, 0]) == force[0],
          f"render (e): the perturbation is not on the card ({xfrc.device})")
    ts = env.step(np.zeros(1))
    check(np.isfinite(ts.reward), "render (e): the perturbed step")
    _launches(linalg, "render (e)", env.physics.model, item)
    render_item(cam, "render (e)", item)
    item["notes"] = {"viewer frames/s (steps and frames)":
                     round(len(frames) / seconds, 3),
                     "selected body": bid, "perturbation": force[:3].tolist(),
                     "chol_solve launches": item["launches"]}


def phase_render_goldens(card):
    """The four recorded scenes (``rendering.golden``) on the card against
    the JAX package's frames of them."""
    from dm_control_torch.rendering import golden

    for name in golden.SCENES:
        path = os.path.join(ROOT, "tests", "data", f"torch_render_{name}.npz")
        with np.load(path, allow_pickle=False) as z:
            gold = {k: z[k] for k in z.files}
        physics = golden.scene_physics(name, gold, "cuda")
        ours = golden.render_frames(physics, name, gold.get("pose"))
        fig = check_frames(ours, gold, f"render golden {name}")
        h, w = ours["depth"].shape
        print(f"phase 16 golden: {name} {h}x{w} on the card vs the JAX "
              f"frames of the recorded state: {fig} (gate "
              f"{golden.GATE}) | {card}", flush=True)


def phase_render(linalg, card):
    """Phase 16: rendering on the card."""
    from dm_control_torch.suite.wrappers import pixels

    t16 = time.perf_counter()
    items = {}
    for letter, what, run in (
            ("a", "pixels.Wrapper humanoid_CMU:run float32",
             lambda item: phase_render_pixels(linalg, item)),
            ("b", "quadruped:escape physics.render (height field box)",
             phase_render_hfield),
            ("c", "stack_3_bricks_vision front_close 84x84 and a mesh",
             phase_render_manipulation),
            ("d", "soccer 2v2 MultiplayerTrackingCamera 1920x1080",
             lambda item: phase_render_soccer(linalg, item)),
            ("e", "viewer Application cartpole:swingup",
             lambda item: phase_render_viewer(linalg, item))):
        item = items[letter] = {"task": what}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run(item)
        item["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        render_line(letter, what, item, card)
    check(pixels._RENDER_BACKEND is None,
          "render: something set pixels.set_render_backend")
    phase_render_goldens(card)
    print(f"phase 16 in {time.perf_counter() - t16:.1f} s | {card}",
          flush=True)
    return items


def write_clip_files(directory):
    """Phase 17 (a): ``MOCAP_IDS`` as synthetic clips of the CMU 2020
    humanoid (56 joints) written to ``cmu_2020_dfe3e9e0.h5`` in the
    reference's layout (where ``h5py`` imports) and to a protobuf bank
    (where ``protobuf`` does), each read back by the port's loader and
    held equal to the written arrays.  Returns which files were written,
    and the clips."""
    from dm_control_torch.locomotion.mocap import loader

    clips = {cid: loader.synthetic_walking_trajectory(
        nq=63, nv=62, num_steps=MOCAP_FRAMES, seed=k, identifier=cid)
        for k, cid in enumerate(MOCAP_IDS)}
    written = {}
    try:
        import h5py
    except ImportError:
        print("phase 17 (a): h5py does not import here; no h5 clip file",
              flush=True)
    else:
        path = os.path.join(directory, "cmu_2020_dfe3e9e0.h5")
        with h5py.File(path, "w") as f:
            for cid, clip in clips.items():
                group = f.create_group(cid)
                group.attrs["dt"] = clip.dt
                w = group.create_group("walkers/walker_0")
                qpos, qvel = clip["qpos"], clip["qvel"]
                for key, value in (("position", qpos[:, :3]),
                                   ("quaternion", qpos[:, 3:7]),
                                   ("joints", qpos[:, 7:]),
                                   ("velocity", qvel[:, :3]),
                                   ("angular_velocity", qvel[:, 3:6]),
                                   ("joints_velocity", qvel[:, 6:])):
                    w.create_dataset(key, data=value.T)
        written["h5"] = loader.HDF5TrajectoryLoader(path)
    try:
        import google.protobuf  # noqa: F401
    except ImportError:
        print("phase 17 (a): protobuf does not import here; no clip bank",
              flush=True)
    else:
        path = os.path.join(directory, "clips.pb")
        loader.save_trajectory_bank(path, clips)
        written["proto"] = loader.ProtoTrajectoryLoader(path)
    for kind, ldr in written.items():
        check(sorted(ldr.keys()) == sorted(MOCAP_IDS),
              f"phase 17 (a): the {kind} file's clips {ldr.keys()}")
        for cid, clip in clips.items():
            back = ldr.get_trajectory(cid)
            check(back.dt == clip.dt and all(
                np.array_equal(back[k], clip[k]) for k in ("qpos", "qvel")),
                f"phase 17 (a): {kind} clip {cid} read back otherwise")
    return written, clips


def phase_mocap_rate(linalg, written, clips):
    """Phase 17 (b): ``cmu_humanoid_tracking()`` on the card in float32
    (its clips from (a)'s h5 where one was written), a reset and
    ``MOCAP_STEPS`` control steps with random actions, the kernel's
    launch counts set to 0 just before the reset and read after the last
    step, the observation updater's host time and the named reads of the
    physics (each a copy from the card) counted over the steps; then one
    more control step under ``torch.profiler``."""
    from dm_control_torch.locomotion.examples import cmu_2020_tracking

    env = cmu_2020_tracking.cmu_humanoid_tracking(random_state=0,
                                                  dtype=torch.float32)
    check(env.physics.model.device.type == "cuda",
          "cmu_humanoid_tracking left the card")
    ids = list(env.task._trajectories)
    want = (sorted(MOCAP_IDS) if "h5" in written
            else [f"synthetic_walk_{k}" for k in range(3)])
    check(sorted(ids) == want, f"cmu_humanoid_tracking's clips {ids}")
    if "h5" in written:
        check(all(np.array_equal(env.task._trajectories[c]["qpos"],
                                 clips[c]["qpos"]) for c in ids),
              "cmu_humanoid_tracking: its clips are not the file's")
    spec = env.action_spec()
    low = np.maximum(spec.minimum, -1.0)
    high = np.minimum(spec.maximum, 1.0)
    rng = np.random.RandomState(1)
    torch.cuda.synchronize()
    reset_counts(linalg)
    t0 = time.perf_counter()
    ts = env.reset()
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    reset_launches = linalg.chol_solve.launches
    times = []
    with host_counters() as counts:
        for _ in range(MOCAP_STEPS):
            t0 = time.perf_counter()
            ts = env.step(rng.uniform(low, high))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            check(np.isfinite(ts.reward) and all(
                np.isfinite(v).all() for v in ts.observation.values()),
                "cmu_humanoid_tracking: non-finite reward or observation")
    launches = linalg.chol_solve.launches
    branch_launches = dict(linalg.chol_solve.branch_launches)
    check_branch(linalg, "cmu_humanoid_tracking", env.physics.model,
                 launches, branch_launches)
    substeps = env._n_sub_steps
    per_step = (launches - reset_launches) / MOCAP_STEPS
    check(per_step >= 3 * substeps,
          f"cmu_humanoid_tracking: chol_solve launched {per_step} times a "
          f"control step of {substeps} substeps (< 3 a substep)")
    kernels, busy_ms, wall_ms = _idle_share(
        lambda: env.step(rng.uniform(low, high)), "cmu_humanoid_tracking")
    warm = times[1:]
    return dict(task="cmu_humanoid_tracking", nv=env.physics.model.nv,
                clips=len(ids), launches=launches,
                branch_launches=branch_launches,
                reset_launches=reset_launches, per_step=per_step,
                substeps=substeps, reset_s=reset_s,
                first_ms=1e3 * times[0],
                steps_per_s=len(warm) / sum(warm),
                step_ms=1e3 * float(np.median(warm)),
                updater_ms=1e3 * counts["updater_s"] / MOCAP_STEPS,
                reads=counts["reads"] / MOCAP_STEPS,
                kernels_per_step=kernels, busy_ms=busy_ms,
                profiled_ms=wall_ms, idle_share=1 - busy_ms / wall_ms)


def phase_mocap_selfcheck(linalg):
    """Phase 17 (c): ``cmu_humanoid_tracking()`` in float64 on the card, a
    reset and ``MOCAP_SELFCHECK_STEPS`` control steps through the kernel,
    and again under ``reference_solves()`` with the same seed and
    actions: the largest observation difference over max(1, its largest
    entry) and the largest reward difference, both <=
    ``MOCAP_SELFCHECK_TOL``."""
    from dm_control_torch.locomotion.examples import cmu_2020_tracking

    runs = []
    for plain in (False, True):
        env = cmu_2020_tracking.cmu_humanoid_tracking(random_state=4,
                                                      dtype=torch.float64)
        spec = env.action_spec()
        rng = np.random.RandomState(2)
        reset_counts(linalg)
        with linalg.reference_solves() if plain else contextlib.nullcontext():
            out = [env.reset()]
            for _ in range(MOCAP_SELFCHECK_STEPS):
                out.append(env.step(rng.uniform(np.maximum(spec.minimum, -1),
                                                np.minimum(spec.maximum, 1))))
        runs.append((out, linalg.chol_solve.launches,
                     dict(linalg.chol_solve.branch_launches)))
    (k_out, n_k, b_k), (p_out, n_p, _) = runs
    check(n_k >= 3 * MOCAP_SELFCHECK_STEPS * env._n_sub_steps and n_p == 0,
          f"mocap selfcheck: {n_k} kernel launches through the kernel, "
          f"{n_p} under reference_solves()")
    check_branch(linalg, "mocap selfcheck", env.physics.model, n_k, b_k)
    scaled = {}
    for k in k_out[0].observation:
        scale = max(1.0, max(float(np.abs(ts.observation[k]).max())
                             for ts in k_out))
        scaled[k] = max(float(np.abs(a.observation[k]
                                     - b.observation[k]).max())
                        for a, b in zip(k_out, p_out)) / scale
    worst = max(scaled, key=scaled.get)
    drew = max(abs(a.reward - b.reward) for a, b in zip(k_out[1:], p_out[1:]))
    check(scaled[worst] <= MOCAP_SELFCHECK_TOL
          and drew <= MOCAP_SELFCHECK_TOL,
          f"mocap selfcheck: kernel vs plain max |dobs| {scaled[worst]:.3e} "
          f"of max(1, scale) ({worst}), |dreward| {drew:.3e} "
          f"(<= {MOCAP_SELFCHECK_TOL:g})")
    check(all(int(ts.step_type) == 1 for ts in k_out[1:]),
          "mocap selfcheck: the episode ended early")
    return dict(nv=env.physics.model.nv, dobs=scaled[worst], worst=worst,
                drew=drew, launches=n_k, branch_launches=b_k)


def phase_ppo_tracking(linalg):
    """Phase 17 (d): one epoch of ``scripts.ppo_tracking`` on the card
    (``PPO_TRACKING_ARGS``: a ``DummyVecEnv`` of two float32 tracking
    environments, 16 env steps, the policy and its update on the card),
    the kernel's launch counts set to 0 just before ``train()``."""
    from dm_control_torch.scripts import ppo_tracking

    trainer = ppo_tracking.make_trainer(
        ppo_tracking.parse_args(list(PPO_TRACKING_ARGS)))
    model = trainer.env.envs[0].physics.model
    check(model.device.type == "cuda" and trainer.device.type == "cuda"
          and next(trainer.policy.parameters()).is_cuda,
          "ppo_tracking left the card")
    before = [p.detach().clone() for p in trainer.policy.parameters()]
    torch.cuda.synchronize()
    reset_counts(linalg)
    (stats,) = trainer.train()
    launches = linalg.chol_solve.launches
    branch_launches = dict(linalg.chol_solve.branch_launches)
    check_branch(linalg, "ppo_tracking", model, launches, branch_launches)
    check(all(np.isfinite(stats[k]) for k in ("loss", "pg_loss", "v_loss",
                                              "entropy", "approx_kl")),
          f"ppo_tracking: non-finite losses {stats}")
    check(any(not torch.equal(a, b) for a, b in
              zip(before, trainer.policy.parameters())),
          "ppo_tracking: the update moved no parameter")
    substeps = trainer.env.envs[0]._n_sub_steps
    check(launches >= 3 * substeps * stats["env_steps"],
          f"ppo_tracking: {launches} chol_solve launches over "
          f"{stats['env_steps']} env steps of {substeps} substeps")
    return dict(stats, task="ppo_tracking", nv=model.nv, launches=launches,
                branch_launches=branch_launches,
                per_env_step=launches / stats["env_steps"])


def phase_vec_env(linalg):
    """Phase 17 (e): ``TorchVecEnv`` over pendulum:swingup at
    ``VEC_ENV_BATCH`` in float32, episodes of ``VEC_ENV_EPISODE`` control
    steps: every environment's episode ends at its third step and starts
    anew at the next; observations (B, 3) float32 on the host."""
    from dm_control_torch import suite
    from dm_control_torch.scripts.vec_env import TorchVecEnv

    env = suite.load_batch("pendulum", "swingup", dtype=torch.float32)
    dt = env.n_sub_steps * float(env.model.opt.timestep)
    venv = TorchVecEnv(env.model, env.task, VEC_ENV_BATCH, seed=0,
                       time_limit=VEC_ENV_EPISODE * dt, control_timestep=dt)
    torch.cuda.synchronize()
    reset_counts(linalg)
    t0 = time.perf_counter()
    obs = venv.reset()
    check(obs.shape == (VEC_ENV_BATCH, 3) and obs.dtype == np.float32,
          f"TorchVecEnv: observations {obs.shape} {obs.dtype}")
    dones, times = [], []
    rng = np.random.RandomState(3)
    for _ in range(VEC_ENV_EPISODE + 1):
        t1 = time.perf_counter()
        obs, rew, done, _ = venv.step(rng.uniform(-1, 1, (VEC_ENV_BATCH, 1)))
        times.append(time.perf_counter() - t1)
        check(np.isfinite(obs).all() and np.isfinite(rew).all(),
              "TorchVecEnv: non-finite observation or reward")
        dones.append(int(done.sum()))
    wall = time.perf_counter() - t0
    want = [0] * (VEC_ENV_EPISODE - 1) + [VEC_ENV_BATCH, 0]
    check(dones == want and int(venv._state.step_count.max()) == 0,
          f"TorchVecEnv: dones a step {dones} (want {want})")
    launches = linalg.chol_solve.launches
    branch_launches = dict(linalg.chol_solve.branch_launches)
    check_branch(linalg, "TorchVecEnv pendulum:swingup", env.model,
                 launches, branch_launches)
    check(venv._env._fast is not None,
          "TorchVecEnv: pendulum off the fused fast path")
    fast = check_fast(linalg, "TorchVecEnv pendulum:swingup",
                      fast_launches(), VEC_ENV_EPISODE + 1)
    return dict(task="pendulum:swingup", launches=launches, fast=True,
                fast_launches=fast,
                branch_launches=branch_launches, wall_s=wall,
                env_steps_per_s=VEC_ENV_BATCH * len(times[1:])
                / sum(times[1:]))


def phase_mocap(linalg, card):
    """Phase 17: the clip files, the CMU 2020 tracking environment and the
    tracking trainer on the card."""
    t17 = time.perf_counter()
    with tempfile.TemporaryDirectory() as directory:
        saved = os.environ.get("CMU_MOCAP_DIR")
        os.environ["CMU_MOCAP_DIR"] = directory
        try:
            written, clips = write_clip_files(directory)
            print(f"phase 17 (a) clip files: {len(MOCAP_IDS)} walk_tiny "
                  f"clips of {MOCAP_FRAMES} frames written to and read back "
                  f"from {', '.join(sorted(written)) or 'no file'} equal "
                  f"| {card}", flush=True)
            rate = phase_mocap_rate(linalg, written, clips)
            print(f"phase 17 (b) cmu_humanoid_tracking float32 (nv="
                  f"{rate['nv']}, {rate['clips']} clips) on the card, reset "
                  f"{rate['reset_s']:.2f} s ({rate['reset_launches']} "
                  f"chol_solve launches), {MOCAP_STEPS} control steps: "
                  f"{rate['steps_per_s']:.3f} control steps/s after the "
                  f"first ({rate['first_ms']:.1f} ms; median "
                  f"{rate['step_ms']:.1f} ms), chol_solve launches "
                  f"{rate['per_step']:.1f} a control step (>= 3 x "
                  f"{rate['substeps']} substeps; by branch "
                  f"{rate['branch_launches']}), updater "
                  f"{rate['updater_ms']:.2f} ms of host time and "
                  f"{rate['reads']:.1f} named reads of the physics a control "
                  f"step; one profiled control step: "
                  f"{rate['kernels_per_step']} device kernels, busy "
                  f"{rate['busy_ms']:.3f} ms of {rate['profiled_ms']:.1f} "
                  f"ms, idle share {rate['idle_share']:.4f} | {card}",
                  flush=True)
            selfcheck = phase_mocap_selfcheck(linalg)
            print(f"phase 17 (c) cmu_humanoid_tracking float64 (nv="
                  f"{selfcheck['nv']}: the "
                  f"{linalg.kernel_branch(selfcheck['nv'], torch.float64)} "
                  f"kernel), reset and {MOCAP_SELFCHECK_STEPS} control steps "
                  f"through the kernel ({selfcheck['launches']} launches) vs "
                  f"reference_solves(): max |dobs| {selfcheck['dobs']:.3e} "
                  f"of max(1, its scale) ({selfcheck['worst']}), |dreward| "
                  f"{selfcheck['drew']:.3e} <= {MOCAP_SELFCHECK_TOL:g} | "
                  f"{card}", flush=True)
        finally:
            if saved is None:
                del os.environ["CMU_MOCAP_DIR"]
            else:
                os.environ["CMU_MOCAP_DIR"] = saved
    train = phase_ppo_tracking(linalg)
    print(f"phase 17 (d) ppo_tracking float32 on the card: one epoch of "
          f"{train['env_steps']} env steps over 2 environments in "
          f"{train['time']:.2f} s ({train['env_steps'] / train['time']:.2f} "
          f"env steps/s): environments {train['env_s']:.2f} s "
          f"({train['env_s'] / train['time']:.3f}), policy actions and their "
          f"copies {train['policy_s']:.3f} s "
          f"({train['policy_s'] / train['time']:.4f}), update "
          f"{train['update_s']:.3f} s ({train['update_s'] / train['time']:.4f};"
          f" {train['grad_steps']} gradient steps); loss "
          f"{train['loss']:.4e} approx_kl {train['approx_kl']:.4e}, chol_solve "
          f"launches {train['launches']} ({train['per_env_step']:.1f} an env "
          f"step; by branch {train['branch_launches']}) | {card}", flush=True)
    vec = phase_vec_env(linalg)
    print(f"phase 17 (e) TorchVecEnv pendulum:swingup B={VEC_ENV_BATCH} "
          f"float32: episodes of {VEC_ENV_EPISODE} control steps end "
          f"together and start anew at the next step, "
          f"{vec['env_steps_per_s']:.1f} env-steps/s after the first, "
          f"fused-step launches {vec['fast_launches']} (one a control "
          f"step), chol_solve launches {vec['launches']} (by branch "
          f"{vec['branch_launches']}); phase 17 in "
          f"{time.perf_counter() - t17:.1f} s | {card}", flush=True)
    return rate, selfcheck, train, vec


def cartpole_env(dtype=torch.float32):
    """Phase 18's environment: ``suite.load("cartpole", "swingup")`` on
    the card, seed 0."""
    from dm_control_torch import suite

    return suite.load("cartpole", "swingup", task_kwargs={"random": 0},
                      dtype=dtype)


def counted(linalg, what, model):
    """The kernel's launches and launches by branch since the last
    ``reset_launch_counts``, held to the branch that (nv, type) names."""
    launches = linalg.chol_solve.launches
    branch_launches = dict(linalg.chol_solve.branch_launches)
    check_branch(linalg, what, model, launches, branch_launches)
    check(launches > 0, f"{what}: no chol_solve launch")
    return launches, branch_launches


def phase_cem_rate(linalg):
    """Phase 18 (a): ``CEMSolver.for_environment`` on cartpole:swingup in
    float32 (the JAX package's defaults but ``CEM_ITERATIONS``), ``solve``
    of ``CEM_STEPS`` actions, the kernel's launch counts set to 0 just
    before; then one profiled CEM iteration's candidate returns."""
    from dm_control_torch.scripts.solver import CEMSolver

    env = cartpole_env()
    env.reset()
    solver = CEMSolver.for_environment(env, n_iterations=CEM_ITERATIONS)
    model = solver.model
    check(model.device.type == "cuda", "CEM: the model left the card")
    segments = -(-CEM_STEPS // solver.segment_length)
    torch.cuda.synchronize()
    reset_counts(linalg)
    t0 = time.perf_counter()
    actions = solver.solve(env.physics.data, CEM_STEPS, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, branch_launches = counted(linalg, "CEM cartpole:swingup", model)
    check(actions.shape == (CEM_STEPS, model.nu)
          and np.isfinite(actions).all(), f"CEM actions {actions.shape}")
    steps = segments * solver.segment_length * solver.n_sub_steps
    check(launches >= steps * (solver.n_iterations + 1),
          f"CEM: {launches} chol_solve launches over {segments} segments")
    gen = torch.Generator(device=model.device).manual_seed(1)
    cands = torch.clamp(0.3 * torch.randn(
        (solver.population, solver.segment_length, model.nu), generator=gen,
        device=model.device, dtype=model.dtype), solver._lo, solver._hi)
    kernels, busy_ms, wall_ms = _idle_share(
        lambda: solver.batch_returns(env.physics.data, cands),
        "one CEM iteration on cartpole:swingup")
    candidate_steps = segments * solver.n_iterations * solver.population \
        * solver.segment_length
    return dict(actions=actions, launches=launches,
                branch_launches=branch_launches, wall_s=wall,
                segment_s=wall / segments,
                candidate_steps_per_s=candidate_steps / wall,
                kernels=kernels, busy_ms=busy_ms, profiled_ms=wall_ms,
                idle_share=1 - busy_ms / wall_ms, nv=model.nv)


def phase_cem_humanoid(linalg):
    """Phase 18 (b): one CEM iteration (``solve_segment``) on humanoid:walk
    at the defaults in float32, timed, the launches counted; then in
    float64 one iteration's candidate returns over ``CEM_SELFCHECK_STEPS``
    control steps through the kernel and under ``reference_solves()``:
    the largest difference over max(1, the returns' scale) <=
    ``CEM_SELFCHECK_TOL``."""
    from dm_control_torch import suite
    from dm_control_torch.scripts.solver import CEMSolver

    env = suite.load("humanoid", "walk", task_kwargs={"random": 0},
                     dtype=torch.float32)
    env.reset()
    solver = CEMSolver.for_environment(
        env, n_iterations=1, segment_length=CEM_HUMANOID_STEPS)
    torch.cuda.synchronize()
    reset_counts(linalg)
    t0 = time.perf_counter()
    _, ret = solver.solve_segment(
        env.physics.data,
        torch.Generator(device=solver.model.device).manual_seed(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, branch_launches = counted(linalg, "CEM humanoid:walk",
                                        solver.model)
    check(np.isfinite(ret), f"CEM humanoid:walk: return {ret}")
    env64 = suite.load("humanoid", "walk", task_kwargs={"random": 0},
                       dtype=torch.float64)
    env64.reset()
    check64 = CEMSolver.for_environment(
        env64, segment_length=CEM_SELFCHECK_STEPS)
    gen = torch.Generator(device=check64.model.device).manual_seed(2)
    cands = torch.clamp(check64.init_std * torch.randn(
        (check64.population, CEM_SELFCHECK_STEPS, check64.model.nu),
        generator=gen, device=check64.model.device, dtype=torch.float64),
        check64._lo, check64._hi)
    reset_counts(linalg)
    kernel = check64.batch_returns(env64.physics.data, cands)
    n_k, b_k = counted(linalg, "CEM selfcheck humanoid:walk float64",
                       check64.model)
    reset_counts(linalg)
    with linalg.reference_solves():
        plain = check64.batch_returns(env64.physics.data, cands)
    check(linalg.chol_solve.launches == 0,
          "CEM selfcheck: launches under reference_solves()")
    diff = (kernel - plain).abs()
    scale = max(1.0, float(plain.abs().max()))
    worst = int(diff.argmax())
    rel = float(diff.max()) / scale
    check(bool(torch.isfinite(kernel).all()) and rel <= CEM_SELFCHECK_TOL,
          f"CEM selfcheck: kernel vs plain candidate returns differ by "
          f"{rel:.3e} of max(1, scale) at candidate {worst} "
          f"(<= {CEM_SELFCHECK_TOL:g})")
    return dict(nv=solver.model.nv, wall_s=wall, ret=ret, launches=launches,
                branch_launches=branch_launches, substeps=solver.n_sub_steps,
                candidate_steps_per_s=solver.population
                * solver.segment_length / wall,
                check=dict(launches=n_k, branch_launches=b_k, rel=rel,
                           worst=worst, scale=scale))


def phase_bc_dataset(linalg, directory, actions):
    """Phase 18 (c): (a)'s actions and seeded uniform random ones written
    as ``opt_acts_*.npy`` and replayed by ``create_dataset`` on the card,
    each in a fresh environment: (a)'s return must beat the random
    actions' by ``CEM_MARGIN``.  Where ``h5py`` imports, the HDF5 file is
    written and read back through ``TrajectoryDataset`` and held equal to
    the rows, else the dataset is built from the rows (``from_arrays``).
    Returns the dataset (blocks of 4), each file's steps and return, and
    whether a file was written."""
    from dm_control_torch.scripts import create_dataset, solver
    from dm_control_torch.scripts.dataset import TrajectoryDataset

    files = [os.path.join(directory, f"opt_acts_{k}.npy") for k in (0, 1)]
    solver.save_actions(files[0], actions)
    solver.save_actions(files[1], np.random.RandomState(0).uniform(
        -1, 1, actions.shape))
    check(create_dataset.gather_action_files([directory]) == files,
          "create_dataset: the action files")
    try:
        import h5py  # noqa: F401
    except ImportError:
        written = False
    else:
        written = True
    torch.cuda.synchronize()
    reset_counts(linalg)
    make_env = lambda path: cartpole_env()  # noqa: E731
    if written:
        path = os.path.join(directory, "trajectory_dataset.hdf5")
        obs, acts, dones, rewards = create_dataset.create_dataset(
            make_env, files, path)
    else:
        print("phase 18 (c): h5py does not import here; the dataset is "
              "built from the replayed rows", flush=True)
        obs, acts, dones, rewards = create_dataset.replay_files(make_env,
                                                               files)
    launches, branch_launches = counted(
        linalg, "create_dataset cartpole:swingup",
        cartpole_env().physics.model)
    flat = np.concatenate([obs[k].reshape(len(acts), -1)
                           for k in sorted(obs)], axis=1)
    if written:
        ds = TrajectoryDataset(path, 4)
        check(np.array_equal(ds.observations, flat)
              and np.array_equal(ds.actions, acts)
              and np.array_equal(ds.dones, dones),
              "TrajectoryDataset: the HDF5 file's rows differ from the "
              "replay's")
    else:
        ds = TrajectoryDataset.from_arrays(flat, acts, dones, 4)
    ends = np.flatnonzero(dones) + 1
    per_file = [(int(b - a), float(rewards[a:b].sum()))
                for a, b in zip(np.r_[0, ends[:-1]], ends)]
    check(len(per_file) == 2 and all(n == len(actions) for n, _ in per_file),
          f"create_dataset: episodes {per_file}")
    check(np.isfinite(flat).all() and np.isfinite(rewards).all(),
          "create_dataset: non-finite rows")
    (_, cem), (_, rand) = per_file
    check(cem > rand + CEM_MARGIN,
          f"CEM: replayed return {cem:.4f} does not beat random actions' "
          f"{rand:.4f} by {CEM_MARGIN}")
    return dict(dataset=ds, per_file=per_file, rewards=rewards,
                written=written, launches=launches,
                branch_launches=branch_launches)


def train_step_ms(trainer, batches, what):
    """Each step's CUDA-event milliseconds (the batch's copy to the card
    and the update) and loss over ``batches``."""
    times, losses = [], []
    for obs, act in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = trainer._train_step(*trainer._prep(obs, act), 1.0)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        losses.append(float(loss))
    check(np.isfinite(losses).all(), f"{what}: non-finite loss {losses}")
    return times, losses


def phase_bc_train(directory, dataset):
    """Phase 18 (d) and (g): the GPT at ``train.py``'s defaults on the
    card, one epoch over (c)'s dataset; then ``BC_TIMED_STEPS`` timed steps
    over a seeded synthetic dataset of cartpole's widths through the
    native loader (``num_workers``: built by g++ at first use); a
    checkpoint saved and loaded equal bit for bit; one step traced by
    ``profiling.trace`` with a CUDA kernel in the trace."""
    from dm_control_torch import native
    from dm_control_torch.scripts import train
    from dm_control_torch.scripts.dataset import TrajectoryDataset
    from dm_control_torch.scripts.model import GPT, GPTConfig
    from dm_control_torch.scripts.trainer import Trainer, TrainerConfig
    from dm_control_torch.utils import profiling

    args = train.parse_args([])
    config = GPTConfig(dataset.observation_size, dataset.action_size,
                       args.block_size, n_layer=args.gpt_layers,
                       n_head=args.gpt_heads, n_embd=args.gpt_embd)
    config_path = os.path.join(directory, "config.json")
    ckpt = os.path.join(directory, "model.pt")
    config.to_json(config_path)
    trainer = Trainer(GPT(config), dataset, None, TrainerConfig(
        max_epochs=1, batch_size=BC_BATCH, learning_rate=args.learning_rate,
        grad_norm_clip=args.grad_norm_clip, ckpt_path=ckpt,
        num_workers=BC_WORKERS))
    check(next(trainer.model.parameters()).is_cuda, "Trainer left the card")
    ((epoch_loss, _),) = trainer.train()
    check(np.isfinite(epoch_loss), f"BC epoch: loss {epoch_loss}")
    rng = np.random.RandomState(0)
    n_eps, length = BC_SYNTHETIC_EPISODES
    obs = rng.randn(n_eps * length, dataset.observation_size).astype(
        np.float32)
    act = np.tanh(obs @ rng.randn(dataset.observation_size,
                                  dataset.action_size)).astype(np.float32)
    dones = np.zeros(n_eps * length, bool)
    dones[length - 1::length] = True
    synthetic = TrajectoryDataset.from_arrays(obs, act, dones,
                                              config.block_size)
    check(len(synthetic) >= BC_TIMED_STEPS * BC_BATCH,
          f"synthetic dataset of {len(synthetic)} blocks")
    batches = trainer._epoch_batches(synthetic, np.random.RandomState(1))
    first = [next(batches)]  # the loader built and started
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    times, losses = train_step_ms(
        trainer, first + [next(batches) for _ in range(BC_TIMED_STEPS - 1)],
        "BC timed steps")
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    batches.close()
    trainer.save_checkpoint()
    saved = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    restored = GPT(config).to(trainer.device)
    restored.load_state_dict(torch.load(ckpt, map_location=trainer.device,
                                        weights_only=True))
    check(all(torch.equal(v, saved[k])
              for k, v in restored.state_dict().items()),
          "checkpoint: parameters differ after a save and load")
    logdir = os.path.join(directory, "trace")
    obs_b, act_b = synthetic.batches(np.random.RandomState(2),
                                     BC_BATCH).__next__()
    with profiling.trace(logdir):
        with profiling.annotate("bc_train_step"):
            trainer._train_step(*trainer._prep(obs_b, act_b), 1.0)
        torch.cuda.synchronize()
    traces = glob.glob(os.path.join(logdir, "*.json"))
    check(len(traces) == 1, f"profiling.trace wrote {traces}")
    with open(traces[0]) as f:
        events = json.load(f).get("traceEvents", [])
    cuda_kernels = sum(1 for e in events if e.get("cat") == "kernel")
    check(cuda_kernels > 0, "profiling.trace: no CUDA kernel in the trace")
    median = float(np.median(times))
    return dict(epoch_loss=epoch_loss, params=sum(
        p.numel() for p in trainer.model.parameters()),
        step_ms=median, steps_wall_s=wall,
        tokens_per_s=BC_BATCH * config.block_size / (median / 1e3),
        peak_gb=peak_gb, first_loss=losses[0], last_loss=losses[-1],
        build_s=native.build_seconds.get("trajloader.cc"),
        blocks=len(synthetic), trace_kernels=cuda_kernels,
        config_path=config_path, ckpt=ckpt)


def phase_bc_eval(linalg, train, actions, recorded):
    """Phase 18 (e): ``load_model`` on (d)'s config and checkpoint, then
    ``evaluate`` with ``actions`` ((a)'s first ``BC_EVAL_STEPS``) as the
    reference and ``BC_CONTEXT_STEPS`` of context
    (``comprehensive_eval``'s default), the launch counts set to 0 just
    before; ``actions`` replayed by ``validate_reference_actions``
    reproduce ``recorded`` ((c)'s recorded return of them) within the JAX
    package's 1e-3."""
    from dm_control_torch.scripts import evaluate

    model, config = evaluate.load_model(train["config_path"], train["ckpt"])
    check(next(model.parameters()).is_cuda, "load_model left the card")
    env = cartpole_env()
    torch.cuda.synchronize()
    reset_counts(linalg)
    t0 = time.perf_counter()
    out = evaluate.evaluate(env, model, config, reference_actions=actions,
                            context_steps=BC_CONTEXT_STEPS)
    wall = time.perf_counter() - t0
    launches, branch_launches = counted(linalg, "evaluate cartpole:swingup",
                                        env.physics.model)
    check(np.isfinite([out["policy_return"], out["action_mse"],
                       out["reference_return"]]).all(), f"evaluate: {out}")
    ok, total = evaluate.validate_reference_actions(cartpole_env(), actions,
                                                    recorded)
    check(ok, f"validate_reference_actions: replay {total:.6f} against the "
              f"recorded {recorded:.6f}")
    return dict(out, replayed=total, launches=launches,
                branch_launches=branch_launches, wall_s=wall)


def phase_ppo_box2d(linalg):
    """Phase 18 (f): ``ppo_box2d``'s suite smoke on the card (gym does not
    import there), its mean rewards finite."""
    import types

    from dm_control_torch.scripts import ppo_box2d

    check(not ppo_box2d._gym_available(),
          "ppo_box2d: gym imports here; the suite smoke would not run")
    torch.cuda.synchronize()
    reset_counts(linalg)
    t0 = time.perf_counter()
    rewards = ppo_box2d.main(list(PPO_BOX2D_ARGS))
    wall = time.perf_counter() - t0
    launches = linalg.chol_solve.launches
    branch_launches = dict(linalg.chol_solve.branch_launches)
    check_branch(linalg, "ppo_box2d cartpole:swingup",
                 types.SimpleNamespace(nv=2, dtype=torch.float32), launches,
                 branch_launches)
    # cartpole's BatchEnv takes the fused fast path: a launch a control
    # step of the rollouts and the evaluations, chol_solve none
    fast = fast_launches()
    check(launches == 0 and fast > 0,
          f"ppo_box2d: {fast} fused-step launches, {launches} chol_solve")
    check(len(rewards) == 3 and np.isfinite(rewards).all(),
          f"ppo_box2d: mean rewards {rewards}")
    return dict(rewards=rewards, wall_s=wall, launches=launches,
                branch_launches=branch_launches, fast=True,
                fast_launches=fast)


def phase_bc(linalg, card):
    """Phase 18: the behaviour-cloning pipeline on the card."""
    t18 = time.perf_counter()
    marks = [t18]

    def lap():
        """Seconds since the last item ended, for its line."""
        marks.append(time.perf_counter())
        return f"{marks[-1] - marks[-2]:.1f} s"

    cem = phase_cem_rate(linalg)
    print(f"phase 18 (a) CEM cartpole:swingup float32 (population 128, "
          f"segments of 20, {CEM_ITERATIONS} iterations): {CEM_STEPS} "
          f"actions in {cem['wall_s']:.2f} s ({cem['segment_s']:.2f} s a "
          f"segment, "
          f"{cem['candidate_steps_per_s']:.1f} candidate control steps/s), "
          f"chol_solve launches {cem['launches']} (by branch "
          f"{cem['branch_launches']}); one profiled CEM iteration: "
          f"{cem['kernels']} device kernels, busy {cem['busy_ms']:.3f} ms "
          f"of {cem['profiled_ms']:.1f} ms, idle share "
          f"{cem['idle_share']:.4f}; {lap()} | {card}", flush=True)
    hum = phase_cem_humanoid(linalg)
    c = hum["check"]
    print(f"phase 18 (b) CEM humanoid:walk float32 (nv={hum['nv']}, "
          f"{hum['substeps']} substeps): one iteration of 128 candidates x "
          f"{CEM_HUMANOID_STEPS} control steps in {hum['wall_s']:.2f} s "
          f"({hum['candidate_steps_per_s']:.1f} candidate control steps/s), "
          f"chol_solve launches {hum['launches']} (by branch "
          f"{hum['branch_launches']}); float64 selfcheck, one iteration's "
          f"candidate returns over {CEM_SELFCHECK_STEPS} control steps "
          f"through the kernel ({c['launches']} launches, by branch "
          f"{c['branch_launches']}) vs reference_solves(): max |dreturn| "
          f"{c['rel']:.3e} of max(1, {c['scale']:.3e}) (candidate "
          f"{c['worst']}) <= {CEM_SELFCHECK_TOL:g}; {lap()} | {card}",
          flush=True)
    with tempfile.TemporaryDirectory() as directory:
        data = phase_bc_dataset(linalg, directory, cem["actions"])
        source = ("HDF5 written and read back equal" if data["written"]
                  else "no h5py: from_arrays")
        print(f"phase 18 (c) create_dataset cartpole:swingup float32: "
              + ", ".join(f"opt_acts_{k}.npy {n} steps return {r:.4f}"
                          for k, (n, r) in enumerate(data["per_file"]))
              + f" ((a)'s beat the random actions' by > {CEM_MARGIN}); "
              f"{source}, "
              f"{len(data['dataset'])} blocks of 4, chol_solve launches "
              f"{data['launches']} (by branch {data['branch_launches']}); "
              f"{lap()} | {card}", flush=True)
        train = phase_bc_train(directory, data["dataset"])
        build = ("already built" if train["build_s"] is None
                 else f"built by g++ in {train['build_s']:.2f} s")
        print(f"phase 18 (d) BC GPT (8 layers, 8 heads, n_embd 512, "
              f"{train['params']} parameters) float32 batch {BC_BATCH} x 4 "
              f"on the card: one epoch over (c)'s dataset, loss "
              f"{train['epoch_loss']:.4f}; {BC_TIMED_STEPS} steps over "
              f"{train['blocks']} synthetic blocks through the native "
              f"loader ({BC_WORKERS} threads, {build}): median "
              f"{train['step_ms']:.3f} ms a step by CUDA events "
              f"({train['tokens_per_s']:.0f} tokens/s; "
              f"{train['steps_wall_s']:.3f} s of wall), peak "
              f"{train['peak_gb']:.3f} GB, loss {train['first_loss']:.4f} -> "
              f"{train['last_loss']:.4f}; checkpoint round trip equal; "
              f"(g) profiling.trace of one step: {train['trace_kernels']} "
              f"CUDA kernels in the trace; {lap()} | {card}", flush=True)
        recorded = float(data["rewards"][:BC_EVAL_STEPS].sum())
        ev = phase_bc_eval(linalg, train, cem["actions"][:BC_EVAL_STEPS],
                           recorded)
        print(f"phase 18 (e) evaluate cartpole:swingup (load_model, "
              f"evaluate with (a)'s first {BC_EVAL_STEPS} actions as the "
              f"reference, context {BC_CONTEXT_STEPS}): policy return "
              f"{ev['policy_return']:.4f} "
              f"against the reference's {ev['reference_return']:.4f}, "
              f"action_mse {ev['action_mse']:.4e} in {ev['wall_s']:.2f} s, "
              f"chol_solve launches {ev['launches']} (by branch "
              f"{ev['branch_launches']}); validate_reference_actions "
              f"{ev['replayed']:.6f} against (c)'s {recorded:.6f} (<= "
              f"1e-3); {lap()} | {card}",
              flush=True)
    box = phase_ppo_box2d(linalg)
    print(f"phase 18 (f) ppo_box2d suite smoke cartpole:swingup B=256 "
          f"float32: 3 updates in {box['wall_s']:.2f} s, mean reward "
          + " -> ".join(f"{r:.5f}" for r in box["rewards"])
          + f", fused-step launches {box['fast_launches']}, chol_solve "
          f"launches {box['launches']} (by branch "
          f"{box['branch_launches']}); {lap()}; phase 18 in "
          f"{time.perf_counter() - t18:.1f} s | {card}", flush=True)
    return cem, hum, data, ev, box


def features_task():
    """Phase 19's task on the engine-features model: episodes start at
    qpos0 with N(0, 0.1^2) joint velocities; the observation is the
    sensors and qpos, the reward the torso's height."""
    import collections

    from dm_control_torch.rl.control import Task

    class FeaturesTask(Task):
        def init(self, m, qpos, qvel, rc, diff):
            return qpos, 0.1 * rc.randn(m.nv), diff

        def observation(self, m, d):
            return collections.OrderedDict(sensordata=d.sensordata,
                                           qpos=d.qpos)

        def reward(self, m, d):
            return d.xpos[:, 1, 2]

    return FeaturesTask()


def phase_features_golden(linalg, gold):
    """Phase 19 (a): one float64 ``engine.step`` on the card of each of the
    features recording's start states (Euler and RK4, in the air and on
    the floor) under the golden gate, then the contact states' steps
    through the kernel against ``reference_solves()``."""
    from dm_control_torch.physics import constraints, engine
    from dm_control_torch.rl import golden

    out = {"gate": [], "selfcheck": 0.0}
    reset_counts(linalg)
    for prefix in golden.FEATURES_PREFIXES:
        m = golden.features_model(ROOT, prefix, "cuda", torch.float64)
        check(m.device.type == "cuda", "features: the model left the card")
        errs = golden.features_step_errors(m, gold, prefix)
        rest, rel = golden.gate_figures(errs, gold, prefix)
        check(rest <= golden.ABS_GATE and rel <= golden.REL_GATE,
              f"features {prefix}: gate rest {rest:.3e}, qacc_warmstart "
              f"{rel:.3e} of its scale")
        out["gate"].append((prefix, rest, rel))
    out["launches"], out["branch_launches"] = counted(
        linalg, "features golden float64", m)
    for prefix in ("euler_contact", "rk4_contact"):
        m = golden.features_model(ROOT, prefix, "cuda", torch.float64)
        state = {k: gold[f"{prefix}_{k}"]
                 for k in golden.STATE_FIELDS + ("actions",)}
        d = golden.features_data(m, state)
        got = engine.step(m, d)
        with linalg.reference_solves():
            want = engine.step(m, d)
        for f in golden.FEATURES_STEP_FIELDS:
            a, b = getattr(got, f), getattr(want, f)
            scale = max(1.0, float(b.abs().max()))
            out["selfcheck"] = max(out["selfcheck"],
                                   float((a - b).abs().max()) / scale)
    check(out["selfcheck"] <= FEATURES_SELFCHECK_TOL,
          f"features selfcheck: {out['selfcheck']:.3e} of max(1, scale)")
    out["efc_rows"] = {}
    for prefix in ("euler_reset", "euler_contact"):
        state = {k: gold[f"{prefix}_{k}"]
                 for k in golden.STATE_FIELDS + ("actions",)}
        d = engine.fwd_position(m, golden.features_data(m, state))
        efc = constraints.make_constraint(m, engine.fwd_velocity(m, d))
        active = int((efc.D > 0).sum(-1).max())
        out["efc_rows"][prefix.split("_")[1]] = (efc.nefc, efc.ne, active)
    out["nv"], out["branch"] = m.nv, linalg.kernel_branch(m.nv, m.dtype)
    return out


def phase_features_rate(linalg):
    """Phase 19 (a): the features model through ``BatchEnv`` at B =
    ``MAIN_BATCH`` in float32 (``FEATURES_STEPS`` control steps after the
    reset, launches by branch, one profiled control step), and at B = 1
    through ``Physics.step`` in float64."""
    from dm_control_torch.physics.physics import Physics
    from dm_control_torch.rl import golden
    from dm_control_torch.rl.batch_env import BatchEnv

    m = golden.features_model(ROOT, "euler_reset", "cuda", torch.float32)
    env = BatchEnv(m, features_task(), control_timestep=FEATURES_CONTROL_DT)
    gen = torch.Generator(device=m.device).manual_seed(0)
    state, ts = env.reset(MAIN_BATCH, gen)
    action = torch.zeros(MAIN_BATCH, m.nu, device=m.device)
    state, ts = env.step(state, action)  # warm-up
    torch.cuda.synchronize()
    reset_counts(linalg)
    t0 = time.perf_counter()
    for i in range(FEATURES_STEPS):
        action = torch.rand(MAIN_BATCH, m.nu, generator=gen,
                            device=m.device) * 2 - 1
        state, ts = env.step(state, action)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, branch_launches = counted(linalg, "features BatchEnv float32",
                                        m)
    substeps = FEATURES_STEPS * env.n_sub_steps
    check(launches >= substeps, f"features: {launches} launches over "
                                f"{substeps} substeps")
    diverged = float((ts.discount == 0).float().mean())
    check(bool(torch.isfinite(ts.reward).all()), "features: reward")
    kernels, busy_ms, wall_ms = _idle_share(
        lambda: env.step(state, action), "one features control step")
    with open(os.path.join(ROOT, *golden.FEATURES_XML)) as f:
        physics = Physics.from_xml_string(f.read())
    check(physics.model.device.type == "cuda", "features Physics left the "
                                               "card")
    torch.cuda.synchronize()
    reset_counts(linalg)
    t1 = time.perf_counter()
    physics.step(FEATURES_PHYSICS_STEPS)
    torch.cuda.synchronize()
    physics_s = time.perf_counter() - t1
    p_launches, p_branch = counted(linalg, "features Physics.step float64",
                                   physics.model)
    check(np.isfinite(physics.get_state()).all(), "features Physics state")
    return dict(task="features", launches=launches,
                branch_launches=branch_launches, substeps=substeps,
                steps_per_s=FEATURES_STEPS / wall,
                env_steps_per_s=FEATURES_STEPS * MAIN_BATCH / wall,
                per_step=launches / FEATURES_STEPS, diverged_share=diverged,
                kernels=kernels, busy_ms=busy_ms, profiled_ms=wall_ms,
                idle_share=1 - busy_ms / wall_ms,
                physics=dict(launches=p_launches, branch_launches=p_branch,
                             steps_per_s=FEATURES_PHYSICS_STEPS / physics_s,
                             nv=physics.model.nv))


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh_ppo(ppo, env, mesh):
    """One PPO train step of the suite smoke's settings from seed 0, with
    or without ``mesh``: (state after it, its metrics, wall seconds)."""
    cfg = ppo.PPOConfig(steps_per_batch=16, num_minibatches=4,
                        update_epochs=2)
    train_step, opt = ppo.make_train_step(env, cfg, mesh=mesh)
    gen = torch.Generator(device=env.model.device).manual_seed(0)
    state = ppo.init_train_state(env, gen, MESH_PPO_BATCH, opt, mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = train_step(state)
    torch.cuda.synchronize()
    return state, metrics, time.perf_counter() - t0, train_step


def phase_mesh(linalg):
    """Phase 19 (b): ``parallel`` at world size 1 over NCCL: one PPO train
    step of the suite smoke with the mesh and one without, equal within
    ``MESH_TOL``; the mesh's env step profiled, no NCCL kernel in it; the
    NCCL kernels of a profiled mesh train step; a BC ``Trainer`` step with
    the mesh and one without, equal within ``MESH_TOL``."""
    import torch.distributed as dist

    from dm_control_torch import parallel, suite
    from dm_control_torch.rl import ppo
    from dm_control_torch.scripts import model as bc_model
    from dm_control_torch.scripts import trainer as bc_trainer

    parallel.initialize(f"127.0.0.1:{_free_port()}", 1, 0, backend="nccl",
                        timeout=120)
    try:
        mesh = parallel.make_mesh()
        check(mesh.distributed and mesh.device.type == "cuda"
              and dist.get_backend() == "nccl", f"mesh {mesh}")
        env = suite.load_batch("cartpole", "swingup", dtype=torch.float32)
        plain, _, plain_s, _ = _mesh_ppo(ppo, env, None)
        reset_counts(linalg)
        meshed, metrics, mesh_s, train_step = _mesh_ppo(ppo, env, mesh)
        launches = linalg.chol_solve.launches
        branch_launches = dict(linalg.chol_solve.branch_launches)
        check(takes_fast(env), "mesh ppo: cartpole off the fused fast path")
        fast = check_fast(linalg, "mesh ppo cartpole:swingup",
                          fast_launches(), 16)
        err = 0.0
        for k, v in plain.module.state_dict().items():
            w = meshed.module.state_dict()[k]
            err = max(err, float((v - w).abs().max()))
        err = max(err, float((plain.env_state.data.qpos
                              - meshed.env_state.data.qpos).abs().max()))
        check(err <= MESH_TOL, f"mesh PPO: max |d| {err:.3e}")
        step = parallel.shard_env_map(mesh, env.step)
        action = torch.zeros(MESH_PPO_BATCH, env.model.nu,
                             device=mesh.device)
        events, _ = profiled(lambda: step(meshed.env_state, action),
                             "the mesh's env step")
        nccl = [e for e in events if "nccl" in e.name().lower()]
        check(not nccl, f"mesh env step: {len(nccl)} NCCL kernels")
        gather_ms = _gather_ms(parallel, mesh, meshed, env)
        losses, params = [], []
        for m in (None, mesh):
            net = bc_model.FFNet(bc_model.FFConfig(4, 2, hidden_size=64))
            tr = bc_trainer.Trainer(net, None, None,
                                    bc_trainer.TrainerConfig(), mesh=m,
                                    device=mesh.device)
            tr.init()
            gen = torch.Generator(device=mesh.device).manual_seed(1)
            obs = torch.randn(64, 4, generator=gen, device=mesh.device)
            act = torch.randn(64, 2, generator=gen, device=mesh.device)
            losses.append(float(tr._train_step(*tr._prep(obs, act), 1.0)))
            params.append({k: v.clone() for k, v in net.state_dict().items()})
        bc_err = max(float((v - params[1][k]).abs().max())
                     / max(1.0, float(v.abs().max()))
                     for k, v in params[0].items())
        bc_err = max(bc_err, abs(losses[0] - losses[1]))
        check(bc_err <= MESH_TOL, f"mesh Trainer: {bc_err:.3e}")
    finally:
        dist.destroy_process_group()
    return dict(task="cartpole:swingup", launches=launches,
                branch_launches=branch_launches, fast=True,
                fast_launches=fast, err=err, plain_s=plain_s,
                mesh_s=mesh_s, env_kernels=len(events), gather_ms=gather_ms,
                bc_err=bc_err, mean_reward=float(metrics["mean_reward"]))


def _gather_ms(parallel, mesh, state, env, reps=20):
    """The gathers of one mesh PPO train step of the suite smoke (the
    rollout's seven fields and the last values, ``all_gather_rows`` over
    the batch), timed by CUDA events: the median of ``reps``."""
    T, B, act = 16, MESH_PPO_BATCH, env.model.nu
    obs = state.last_obs.shape[-1]
    dev = mesh.device
    fields = [torch.zeros(T, B, *shape, device=dev, dtype=dtype)
              for shape, dtype in (((obs,), torch.float32),
                                   ((act,), torch.float32),
                                   ((), torch.float32), ((), torch.float32),
                                   ((), torch.float32), ((), torch.bool),
                                   ((), torch.bool))]
    last = torch.zeros(B, device=dev)

    def gathers():
        for x in fields:
            parallel.all_gather_rows(mesh, x, 1)
        parallel.all_gather_rows(mesh, last)

    return time_ms(gathers, reps)


def phase_duplo(linalg, gold):
    """Phase 19 (c): ``measure_separation_force`` of two bricks in float64
    on the card at ``DUPLO_ARGS``, timed, beside the JAX recording's force;
    one probe at ``DUPLO_PROBE_FORCE`` through the kernel and under
    ``reference_solves()``, its heights within ``DUPLO_TOL`` of each other
    and of the recording, and the force equal to the recording's."""
    from dm_control_torch.entities.props import duplo
    from dm_control_torch.entities.props.duplo import utils

    torch.cuda.synchronize()
    reset_counts(linalg)
    t0 = time.perf_counter()
    force = utils.measure_separation_force(duplo.Duplo(), duplo.Duplo(),
                                           **DUPLO_ARGS)
    wall = time.perf_counter() - t0
    physics, frame = utils.separation_physics(duplo.Duplo(), duplo.Duplo())
    launches, branch_launches = counted(
        linalg, "duplo measure_separation_force", physics.model)
    check(physics.model.device.type == "cuda", "duplo: the pair left the "
                                               "card")
    n_steps = len(gold["probe_heights"]) - 1
    runs = []
    for reference in (False, True):
        heights = []
        ctx = linalg.reference_solves() if reference \
            else contextlib.nullcontext()
        with ctx:
            utils.separates(physics, physics.bind(frame), DUPLO_PROBE_FORCE,
                            n_steps, heights=heights)
        runs.append(np.array(heights))
    err = float(np.abs(runs[0] - runs[1]).max())
    err_jax = float(np.abs(runs[0] - gold["probe_heights"]).max())
    check(err <= DUPLO_TOL and err_jax <= DUPLO_TOL,
          f"duplo probe heights: kernel vs plain {err:.3e}, vs JAX "
          f"{err_jax:.3e}")
    # the same bisection over probes whose heights agree: the same force
    check(force == float(gold["force"]),
          f"duplo separation force {force} N, JAX's {float(gold['force'])}")
    return dict(task="duplo pair", force=force,
                jax_force=float(gold["force"]), wall_s=wall,
                launches=launches, branch_launches=branch_launches,
                nv=physics.model.nv, err=err, err_jax=err_jax)


def phase_features(linalg, card):
    """Phase 19: the engine features, the mesh and the Duplo pair."""
    from dm_control_torch.rl import golden

    t19 = time.perf_counter()
    with np.load(os.path.join(ROOT, *golden.FEATURES_GOLDEN)) as z:
        gold = {k: z[k] for k in z.files}
    g = phase_features_golden(linalg, gold)
    gates = ", ".join(f"{p} {rest:.3e}/{rel:.3e}"
                      for p, rest, rel in g["gate"])
    rows = ", ".join(f"{k} {n} rows ({ne} equality, {a} active at most)"
                     for k, (n, ne, a) in g["efc_rows"].items())
    print(f"phase 19 (a) features golden: float64 engine.step on the card "
          f"vs the JAX recording (nv={g['nv']}: the {g['branch']} kernel; "
          f"{rows}), gate rest/qacc_warmstart: {gates} (<= 1e-9/1e-12); "
          f"chol_solve launches {g['launches']} (by branch "
          f"{g['branch_launches']}); contact states through the kernel vs "
          f"reference_solves(): {g['selfcheck']:.3e} of max(1, scale) <= "
          f"{FEATURES_SELFCHECK_TOL:g}; phase 19 at "
          f"{time.perf_counter() - t19:.1f} s | {card}", flush=True)
    r = phase_features_rate(linalg)
    p = r["physics"]
    print(f"phase 19 (a) features BatchEnv float32 B={MAIN_BATCH}: "
          f"{FEATURES_STEPS} control steps ({r['substeps']} substeps) at "
          f"{r['env_steps_per_s']:.1f} env-steps/s "
          f"({r['steps_per_s']:.2f} control steps/s), chol_solve launches "
          f"{r['per_step']:.1f} a control step (by branch "
          f"{r['branch_launches']}), diverged share "
          f"{r['diverged_share']:.4f}; one profiled control step: "
          f"{r['kernels']} device kernels, busy {r['busy_ms']:.3f} ms of "
          f"{r['profiled_ms']:.1f} ms, idle share {r['idle_share']:.4f}; "
          f"Physics.step float64 B=1: {FEATURES_PHYSICS_STEPS} steps at "
          f"{p['steps_per_s']:.1f} steps/s, chol_solve launches "
          f"{p['launches']} (by branch {p['branch_launches']}); phase 19 "
          f"at {time.perf_counter() - t19:.1f} s | {card}", flush=True)
    mesh = phase_mesh(linalg)
    print(f"phase 19 (b) mesh of 1 rank over NCCL: PPO suite smoke "
          f"cartpole:swingup B={MESH_PPO_BATCH} T=16 float32 one train step "
          f"with the mesh ({mesh['mesh_s']:.2f} s) vs without "
          f"({mesh['plain_s']:.2f} s): max |d| params, qpos "
          f"{mesh['err']:.3e} <= {MESH_TOL:g}; fused-step launches "
          f"{mesh['fast_launches']} (one a control step), chol_solve "
          f"launches {mesh['launches']} (by branch "
          f"{mesh['branch_launches']}); the "
          f"mesh's env step profiled: {mesh['env_kernels']} device events, "
          f"none NCCL; a train step's gathers (8 all_gather_rows) "
          f"{mesh['gather_ms']:.4f} ms by CUDA events; Trainer(mesh=) "
          f"FFNet step vs without: "
          f"{mesh['bc_err']:.3e} <= {MESH_TOL:g}; phase 19 at "
          f"{time.perf_counter() - t19:.1f} s | {card}", flush=True)
    dup = phase_duplo(linalg, gold_duplo())
    print(f"phase 19 (c) duplo measure_separation_force float64 "
          f"(nv={dup['nv']}, time_limit {DUPLO_ARGS['time_limit']} s, "
          f"tolerance {DUPLO_ARGS['tolerance']} N): {dup['force']:.4f} N "
          f"(the JAX recording's {dup['jax_force']:.4f} N) in "
          f"{dup['wall_s']:.2f} s, chol_solve launches {dup['launches']} "
          f"(by branch {dup['branch_launches']}); probe at "
          f"{DUPLO_PROBE_FORCE:g} N heights kernel vs reference_solves() "
          f"{dup['err']:.3e}, vs JAX {dup['err_jax']:.3e} <= {DUPLO_TOL:g}; "
          f"phase 19 in {time.perf_counter() - t19:.1f} s | {card}",
          flush=True)
    return g, r, mesh, dup


def gold_duplo():
    path = os.path.join(ROOT, "tests", "data",
                        "torch_duplo_separation_f64.npz")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    started = time.perf_counter()
    sys.path.insert(0, ROOT)
    from dm_control_torch import manipulation, suite
    from dm_control_torch.ops import _cuda_build, linalg
    from dm_control_torch.physics import engine, fastpath, solver
    from dm_control_torch.physics.model import make_data
    from dm_control_torch.rl import ppo

    card = card_line()
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 1 device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    # the two sources build at once, one nvcc each
    t0 = time.perf_counter()
    builds = {}

    def build(name, fn):
        fn()
        builds[name] = time.perf_counter() - t0

    workers = [threading.Thread(target=build, args=item) for item in (
        ("chol_solve.cu", linalg.build), ("fastpath_step.cu", fastpath.build))]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    check(len(builds) == 2, f"a build failed: built {sorted(builds)}")
    build_s = builds["chol_solve.cu"]
    ptxas = ptxas_kernels(_cuda_build.ptxas_report.get("chol_solve.cu", ""))
    fast_ptxas = ptxas_kernels(_cuda_build.ptxas_report.get(
        "fastpath_step.cu", ""))
    ctas = {dtype: linalg.cluster_ctas(dtype, 1)
            for dtype in (torch.float32, torch.float64)}
    held = {dtype: linalg.global_active_clusters(dtype, c)
            for dtype, c in ctas.items()}
    print(f"phase 2 build: chol_solve.cu in {build_s:.2f} s (nvcc "
          f"{_cuda_build.build_seconds.get('chol_solve.cu', 0.0):.2f} s); "
          f"ptxas: {' | '.join(ptxas)}; global kernel: clusters of "
          f"{ctas[torch.float64]} CTAs a system at B = 1 (float32 "
          f"{ctas[torch.float32]}), {held[torch.float64]} of them on the "
          f"card at once in float64 ({held[torch.float32]} in float32)",
          flush=True)
    print(f"phase 2 build: fastpath_step.cu in "
          f"{builds['fastpath_step.cu']:.2f} s (nvcc "
          f"{_cuda_build.build_seconds.get('fastpath_step.cu', 0.0):.2f} s, "
          f"beside chol_solve.cu's); ptxas: {' | '.join(fast_ptxas)}; "
          f"both built in {time.perf_counter() - t0:.2f} s", flush=True)

    t3 = time.perf_counter()
    worst = phase_kernel(linalg)
    checked_s = time.perf_counter() - t3
    timed = time_shapes(linalg, [(b, n, torch.float32) for b, n in
                                 TIMED_SHAPES] + list(TIMED_SINGLE))
    shapes, singles = timed[:len(TIMED_SHAPES)], timed[len(TIMED_SHAPES):]
    timed_s = time.perf_counter() - t3 - checked_s
    print(f"phase 3 kernel vs plain: ok over n in {KERNEL_NS}, B in "
          f"{KERNEL_BS} ({KERNEL_BS_LARGE} from n = {LARGE_N}), branches "
          f"{dict(linalg.chol_solve.branch_launches)}, shared matrix "
          f"(stride 0) n in {SHARED_NS}, lower triangle only n in "
          f"{LOWER_NS}, max |dx| f32 "
          f"{worst[torch.float32]:.3e} f64 {worst[torch.float64]:.3e}, "
          f"non-SPD row NaN only n in {NON_SPD_NS}; checks {checked_s:.1f} "
          f"s, timings {timed_s:.1f} s | {card}", flush=True)
    for k in shapes + singles:
        print(f"phase 3 timing B={k['B']} n={k['n']} {k['dtype']} A warm "
              f"in L2: "
              f"{k['branch']} kernel {k['ms']:.4f} ms per call (device "
              f"{k['device_ms']:.5f} ms by torch.profiler), bound "
              f"{k['bound_ms']:.3e} ms by {k['bound_by']} "
              f"({k['dense_bound_ms']:.3e} ms were the dense a counted), "
              f"plain {k['plain_ms']:.4f} ms, torch.linalg.solve "
              f"{k['library_ms']:.4f} ms (device "
              f"{k['library_device_ms']:.5f} ms), cholesky_ex + "
              f"cholesky_solve {k['library_cholesky_ms']:.4f} ms (device "
              f"{k['library_cholesky_device_ms']:.5f} ms), max |dx| "
              f"{k['max_abs_err']:.3e} (runs "
              + " ".join(f"{name} {v[0]:.4f}/{v[1]:.4f}"
                         for name, v in k["runs"].items())
              + f") | {card}", flush=True)

    t4 = time.perf_counter()
    golden_fast = {}
    for golden_name, domain, task in GOLDENS:
        gerr, gworst, rest, rel, n_fast = phase_golden(
            suite, linalg, golden_name, domain, task)
        through = (f"through the fused-step kernel ({n_fast} launches)"
                   if n_fast else "through engine.step")
        if n_fast:
            golden_fast[f"golden {golden_name}"] = n_fast
        check(bool(n_fast) == (domain in FAST_DOMAINS),
              f"golden {golden_name}: {n_fast} fused-step launches")
        print(f"phase 4 golden: float64 {domain}:{task} step on the card "
              f"{through} vs JAX golden {golden_name} (reset and later "
              f"states), max |d| {gerr:.3e} ({gworst}); gate: all but "
              f"qacc_warmstart {rest:.3e} <= 1e-9, qacc_warmstart "
              f"{rel:.3e} of its scale <= 1e-12", flush=True)
    print(f"phase 4 in {time.perf_counter() - t4:.1f} s", flush=True)

    t5 = time.perf_counter()
    runs, fast_checks, fast_timed = [], {}, {}
    for domain, task, batch in MAIN_PATHS:
        run = phase_main(suite, linalg, solver, domain, task, batch,
                         profile=domain in FAST_DOMAINS)
        env, warm_state = run.pop("env"), run.pop("after_warmup")
        runs.append(run)
        if run["fast"]:
            c = phase_fast_check(suite, fastpath, domain, task, env,
                                 warm_state)
            fast_checks[f"{domain}:{task}"] = c
            timed = ""
            if (domain, task) in FAST_TIMED:
                t1 = time.perf_counter()
                t = time_fast(fastpath, engine, env, warm_state)
                t["seconds"] = time.perf_counter() - t1
                fast_timed[f"{domain}:{task}"] = t
                timed = (f"; timed: kernel {1e3 * t['ms']:.1f} us a launch "
                         f"(device {1e3 * t['device_ms']:.1f} us by "
                         f"torch.profiler), bound {1e3 * t['bound_ms']:.3f} "
                         f"us by {t['bound_by']} ({t['ops']:.3e} operations "
                         f"on this run's {t['newton_iterations']:.2f} Newton "
                         f"iterations an environment: "
                         f"{1e3 * t['flop_ms']:.3f} us; {t['bytes']} bytes: "
                         f"{1e3 * t['byte_ms']:.3f} us), plain version "
                         f"{t['plain_ms']:.2f} ms, engine.step for the same "
                         f"{t['substeps']} substeps {t['engine_step_ms']:.2f} "
                         f"ms, no library call; the timing "
                         f"{t['seconds']:.1f} s")
            print(f"phase 5 fused step: {domain}:{task} one control step "
                  f"from the state after the warm-up step, kernel vs plain "
                  f"called directly: float32 B={batch} largest deviation "
                  f"{c['err32']:.3e} of the scale (<= 2e-4 in "
                  f"{batch - c['coarse']} environments; in {c['coarse']} "
                  f"where float32 itself is off the float64 step by more, "
                  f"kernel/plain distance to it {c['coarse_ratio']:.2f} "
                  f"<= {FAST_F32_FACTOR}; plain float32 vs float64 "
                  f"{c['plain32_vs_64']:.3e}), float64 B={FAST_B64} "
                  f"{c['err64']:.3e} of the scale (<= 1e-10); the check "
                  f"{c['seconds']:.1f} s{timed} | {card}", flush=True)
        drop = "" if run["drop_rounds"] is None else \
            f", {run['drop_rounds']} rounds of _drop_to_ground"
        if run["rejection_rounds"]:
            drop += f", {run['rejection_rounds']} rejection rounds"
        extra = f", peak {run['peak_gb']:.2f} GB"
        if run["contact_cap"]:
            extra += f", contact cap {run['contact_cap']}"
        if run["noslip_slots_per_substep"] is not None:
            extra += (f", noslip sweep {run['noslip_slots_per_substep']:.1f}"
                      f" contacts a substep (gathered K over its spans)")
        if run["fast"]:
            launched = (
                f"fused-step launches {run['fast_reset_launches']} in the "
                f"reset and {run['fast_per_step']:.1f} a control step, "
                f"chol_solve launches {run['launches']}")
        else:
            launched = (f"chol_solve launches {run['launches']} (>= "
                        f"{run['min_solves']} a substep)")
        if "kernels_per_step" in run:
            extra += (f", one profiled control step: "
                      f"{run['kernels_per_step']} device kernels, busy "
                      f"{run['busy_ms']:.3f} ms of {run['profiled_ms']:.1f} "
                      f"ms, idle share "
                      f"{run['idle_share']:.4f} (of the unprofiled median "
                      f"{run['idle_share_unprofiled']:.4f})")
        print(f"phase 5 main path: {domain}:{task} B={batch} float32, reset "
              f"{run['reset_s']:.2f} s ({run['reset_launches']} chol_solve "
              f"launches{drop}), {MAIN_STEPS} steps ({run['substeps']} "
              f"substeps), {launched}, "
              f"{run['env_steps_per_s']:.1f} env-steps/s after warm-up, "
              f"diverged share {run['diverged_share']:.4f}, mean reward "
              f"{run['mean_reward']:.4f}, step ms "
              f"{[round(t, 1) for t in run['step_ms']]}{extra} | {card}",
              flush=True)
    check(set(fast_checks) == {f"{d}:{t}" for d, t, _ in MAIN_PATHS
                               if d in FAST_DOMAINS},
          f"the fused step ran on {sorted(fast_checks)}, not on the six "
          f"domains {FAST_DOMAINS}")
    print(f"phase 5 in {time.perf_counter() - t5:.1f} s", flush=True)

    dq = phase_selfcheck(suite, linalg, engine, make_data)
    print(f"phase 6 selfcheck: humanoid B=256, 5 engine.steps, kernel vs "
          f"plain max |dqpos| {dq:.3e} <= 1e-4", flush=True)

    trains = []
    for domain, task, batch, steps in TRAIN_PATHS:
        run = phase_train(suite, linalg, ppo, domain, task, batch, steps)
        trains.append(run)
        print(f"phase 7 train: ppo {domain}:{task} B={batch} T={steps} "
              f"float32, 2 epochs x 4 minibatches: "
              f"{run['env_steps_per_s']:.1f} env-steps/s through the learner "
              f"over {TRAIN_TIMED} train steps after a warm-up "
              f"({run['warm_s']:.2f} s; init_train_state "
              f"{run['init_s']:.2f} s), rollout ms "
              f"{[round(t, 1) for t in run['rollout_ms']]}, update ms "
              f"{[round(t, 1) for t in run['update_ms']]}, "
              + (f"fused-step launches {run['per_step']:.1f} a train step "
                 f"of {steps} control steps ({run['fast_launches']} in the "
                 f"path), chol_solve launches {run['launches']}"
                 if run["fast"] else
                 f"chol_solve launches {run['per_step']:.1f} a train step "
                 f"(>= {run['min_solves']} x {run['substeps']} substeps; "
                 f"{run['launches']} in the path)")
              + f", pi_loss "
              f"{run['pi_loss']:.4e} v_loss {run['v_loss']:.4e} approx_kl "
              f"{run['approx_kl']:.4e} mean_reward {run['mean_reward']:.4f}, "
              f"parameters changed, peak {run['peak_gb']:.2f} GB | {card}",
              flush=True)
    dp, dobs, n_k = phase_train_selfcheck(suite, linalg, ppo)
    print(f"phase 7 train selfcheck: pendulum:swingup B=64 T=8 float64, one "
          f"train step from one saved state, fused-step kernel ({n_k} "
          f"launches) vs its plain version: max |dparams| {dp:.3e} <= 1e-8, "
          f"max |dobs| "
          f"{dobs:.3e} <= 1e-9 | {card}", flush=True)

    for domain, task in ENV_GOLDENS:
        rest, rel, missed = phase_env_golden(suite, domain, task)
        note = (f"; recorded miss {', '.join(missed)} of its own scale, "
                f"within 1e-12 of the episode's" if missed else "")
        print(f"phase 8 single env golden: float64 {domain}:{task} reset "
              f"and 5 steps on the card vs the JAX episode, gate: all but "
              f"qacc_warmstart {rest:.3e} <= 1e-9, qacc_warmstart "
              f"{rel:.3e} of its scale <= 1e-12{note} | {card}", flush=True)
    single = phase_single(suite, linalg)
    print(f"phase 8 single env: humanoid:run float32 B=1, reset "
          f"{single['reset_s']:.2f} s ({single['rejection_rounds']} "
          f"rejection rounds, {single['reset_launches']} chol_solve "
          f"launches), {SINGLE_STEPS} control steps: "
          f"{single['steps_per_s']:.2f} control steps/s after the first "
          f"({single['first_ms']:.1f} ms), chol_solve launches "
          f"{single['per_step']:.1f} a control step; one profiled control "
          f"step: {single['kernels_per_step']} device kernels, busy "
          f"{single['busy_ms']:.3f} ms of {single['profiled_ms']:.1f} ms, "
          f"idle share {single['idle_share']:.4f} | {card}", flush=True)
    dobs, drew, n_k = phase_single_selfcheck(suite, linalg)
    print(f"phase 8 single env selfcheck: humanoid:run float64, reset and 2 "
          f"steps, kernel ({n_k} launches) vs reference_solves(): max "
          f"|dobs| {dobs:.3e}, |dreward| {drew:.3e} <= 1e-10; phases 1-8 in "
          f"{time.perf_counter() - started:.1f} s | {card}", flush=True)

    manips = phase_manipulation(manipulation, suite, linalg, solver, ppo,
                                card, trains, started)
    locos = phase_locomotion(suite, linalg, solver, card)
    _, recipe, compiled = phase_compile(suite, linalg, solver, card)
    print(f"phases 1-11 in {time.perf_counter() - started:.1f} s | {card}",
          flush=True)
    _, host_rate, _ = phase_host(manipulation, linalg, card)
    print(f"phases 1-12 in {time.perf_counter() - started:.1f} s | {card}",
          flush=True)
    loco_goldens, _, loco_rate, _ = phase_loco(linalg, card)
    print(f"phases 1-13 in {time.perf_counter() - started:.1f} s | {card}",
          flush=True)
    examples, example_goldens, _ = phase_examples(linalg, card)
    print(f"phases 1-14 in {time.perf_counter() - started:.1f} s | {card}",
          flush=True)
    walker_rate, walker_goldens, walker_check, large = phase_walkers(
        linalg, card)
    print(f"phases 1-15 in {time.perf_counter() - started:.1f} s | {card}",
          flush=True)
    renders = phase_render(linalg, card)
    print(f"phases 1-16 in {time.perf_counter() - started:.1f} s | {card}",
          flush=True)
    mocap_rate, mocap_check, mocap_train, vec = phase_mocap(linalg, card)
    print(f"phases 1-17 in {time.perf_counter() - started:.1f} s | {card}",
          flush=True)
    bc_cem, bc_humanoid, bc_data, bc_eval, bc_box = phase_bc(linalg, card)
    print(f"phases 1-18 in {time.perf_counter() - started:.1f} s | {card}",
          flush=True)
    feat_gold, feat_rate, mesh_run, duplo_run = phase_features(linalg, card)
    print(f"phases 1-19 in {time.perf_counter() - started:.1f} s | {card}",
          flush=True)

    k = shapes[0]  # humanoid's shape heads the line; the others follow
    shape_keys = ("B", "n", "dtype", "branch", "max_abs_err", "ms",
                  "plain_ms", "bound_ms", "dense_bound_ms", "bound_by",
                  "library_ms", "library_cholesky_ms", "device_ms",
                  "library_device_ms", "library_cholesky_device_ms")
    # path -> (launches, its launches by branch)
    paths = {
        **{f"{r['domain']}:{r['task']}": r for r in runs},
        **{f"ppo {r['domain']}:{r['task']}": r for r in trains},
        "single humanoid:run": single,
        **{f"manipulation:{r['task']}": r for r in manips},
        **{f"locomotion:{r['task']}": r for r in locos},
        f"compile cartpole:{compiled['task']}": compiled,
        "compile recipe Physics.from_xml_string": recipe,
        f"manipulation host:{host_rate['task']}": host_rate,
        f"locomotion host:{loco_rate['task']}": loco_rate,
        **{f"locomotion example:{r['task']}": r for r in examples},
        f"soccer walkers:{walker_rate['task']}": walker_rate,
        "soccer walkers selfcheck:humanoid 2v2 float64": walker_check,
        f"soccer walkers:{large['task']} float64": large,
        **{f"render ({k}) {r['task']}": r for k, r in renders.items()
           if "launches" in r},
        "mocap:cmu_humanoid_tracking": mocap_rate,
        "mocap selfcheck:cmu_humanoid_tracking float64": mocap_check,
        "scripts ppo_tracking epoch": mocap_train,
        "scripts TorchVecEnv pendulum:swingup": vec,
        "bc CEM cartpole:swingup": bc_cem,
        "bc CEM humanoid:walk": bc_humanoid,
        "bc CEM selfcheck humanoid:walk float64": bc_humanoid["check"],
        "bc create_dataset cartpole:swingup": bc_data,
        "bc evaluate cartpole:swingup": bc_eval,
        "bc ppo_box2d cartpole:swingup": bc_box,
        "features golden float64": feat_gold,
        "features BatchEnv float32": feat_rate,
        "features Physics.step float64": feat_rate["physics"],
        "mesh ppo cartpole:swingup": mesh_run,
        "duplo measure_separation_force": duplo_run}
    counts = {name: (r["launches"], r["branch_launches"])
              for name, r in paths.items()}
    for kind, (launches, blocks) in (("locomotion host golden", loco_goldens),
                                     ("locomotion example golden",
                                      example_goldens),
                                     ("soccer walker golden",
                                      walker_goldens)):
        counts.update({f"{kind}:{name}": (n, blocks[name])
                       for name, n in launches.items()})
    block64 = linalg._BLOCK_MAX_N[torch.float64]
    block32 = linalg._BLOCK_MAX_N[torch.float32]
    fast_counts = {name: r["fast_launches"] for name, r in paths.items()
                   if r.get("fast")}
    fast_counts.update(golden_fast)
    head = fast_timed["cartpole:swingup"]
    fast_entry = {
        "name": "fastpath_step", "route": "cuda",
        "source": "dm_control_torch/csrc/fastpath_step.cu",
        "replaces": "dm_control_tpu/physics/fastpath.py:190 (XLA-fused; no "
                    "Pallas kernel)",
        "launches": fast_counts["cartpole:swingup"],
        "launches_by_path": fast_counts,
        "max_abs_err": fast_checks["cartpole:swingup"]["max_abs_err"],
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "device_ms": head["device_ms"],
        "engine_step_ms": head["engine_step_ms"], "ptxas": fast_ptxas,
        "checks": fast_checks,
        "shapes": [dict(path=name, **t) for name, t in fast_timed.items()]}
    print(json.dumps({"kernels": [{
        "name": "chol_solve", "route": "cuda",
        "source": "dm_control_torch/csrc/chol_solve.cu",
        "replaces": "dm_control_tpu/ops/linalg.py:69",
        "launches": runs[0]["launches"],
        "branches": {
            "register": "chol_solve_reg_kernel: n <= 32, and n <= 64 in "
                        "float32",
            "block": f"chol_solve_block_kernel: 33 <= n <= {block64} in "
                     f"float64, 65 <= n <= {block32} in float32",
            "global": f"chol_solve_global_kernel: {block64} < n <= "
                      f"{linalg._MAX_N} in float64, {block32} < n <= "
                      f"{linalg._MAX_N} in float32"},
        "launches_by_path": {name: c[0] for name, c in counts.items()},
        "branch_launches_by_path": {name: c[1]
                                    for name, c in counts.items()},
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "dense_bound_ms": k["dense_bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        "library_call": "torch.linalg.solve",
        "library_cholesky_ms": k["library_cholesky_ms"],
        "device_ms": k["device_ms"],
        "shapes": [{key: x[key] for key in shape_keys}
                   for x in shapes + singles]}, fast_entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(2)
