"""Writes the PyTorch port's model assets and its float64 golden files.

The port (``dm_control_torch``) compiles its suite models itself
(``mjcf.compile_model``); the suite's ``.npz`` files written here are the
JAX compiler's output for the same variants, the references its compiler
is tested against; so are the manipulation and locomotion files, since
the port's entities build their own MJCF trees.  Nothing in the port
loads one at run time.  This tool lives outside the port because it
imports ``dm_control_tpu`` and JAX.

    JAX_PLATFORMS=cpu python tools/export_torch_assets.py [domain ...]

(``golden:NAME``, ``golden:quadruped_fetch`` say, writes that golden file
alone, ``golden:features`` the engine-features recording,
``duplo_golden`` the Duplo separation recording, ``fastpath_golden``
the fused fast path's recording of the contact models; ``env_golden:NAME``, ``env_golden:cartpole_swingup`` say, one
single-environment episode of ``ENV_GOLDENS``, and ``env_goldens`` all
six; ``manipulation`` the four manipulation models and their goldens;
``manip_env_golden:NAME`` one host episode of ``MANIP_ENV_GOLDENS``, and
``manip_env_goldens`` all four; ``soccer`` and ``tracking`` the
locomotion models and their goldens; ``loco_env_golden:NAME`` one host
episode of ``LOCO_ENV_GOLDENS`` or ``LOCO_EXAMPLE_GOLDENS``,
``loco_env_goldens`` the first four and ``loco_example_goldens`` the
second four).

It writes, for every ported domain (or only the ones named),

- ``dm_control_torch/suite/assets/<asset>.npz`` for each compiled model of
  the domain (``ASSETS``: cartpole has one per pole count, reacher one per
  target size), through ``model_io.from_jax_model`` and ``model_io.save``;
- ``tests/data/torch_<golden>_golden_f64.npz`` for each golden of the
  domain (``GOLDEN_TASKS``; most domains have one, named like the domain;
  quadruped has three, manipulator and dog two, ``GOLDEN_DOMAINS``; lqr's
  task is seeded, ``GOLDEN_TASK_KWARGS``): float64 start states of the
  golden's task for 4 environments,
  ``reset_*`` from a JAX ``BatchEnv.reset`` (key ``GOLDEN_KEY``, or the
  golden's own in ``GOLDEN_KEYS``; for dog,
  whose JAX task draws its start on the host, numpy seeds as in the JAX
  single-environment reset: ``_host_reset``) and
  ``contact_*`` after ``FALL_STEPS[golden]`` further control steps (for
  the domains with a floor: lying or standing on it, contacts active; for
  ball_in_cup: the string taut; for quadruped_fetch: the ball on the
  floor too; for finger: the spinner touching the finger; for
  manipulator: the ball in the hand; for manipulator_insert_peg: the peg
  against the slot; for stacker: a box on a box, boxes flat on the floor;
  for humanoid_CMU: on the floor in every environment; for dog: feet
  loaded and the noslip sweep moving qacc; for dog_fetch: the ball in
  flight.  The counts of finger, manipulator, stacker and dog were
  picked among the states that reach the new code as ones where a step's
  result does not jump with rounding: at some states, manipulator's
  after 95 steps say, a relative change of 1e-12 in qvel moves the next
  control step's qacc by 1e3); for each, the
  per-episode model
  overrides (``<prefix>_diff_<field>``), actions drawn with numpy seed
  ``GOLDEN_SEED`` and the JAX state, observation, reward, discount and
  step type after one control step (keys ``<prefix>_actions``,
  ``<prefix>_step_*``, ``<prefix>_obs_*``, ``<prefix>_reward``, ...);
- on request (``manipulation``),
  ``dm_control_torch/manipulation/assets/<asset>.npz`` for each distinct
  physics of the batchable manipulation tasks (``MANIPULATION_ASSETS``:
  a task's vision variant shares its features variant's model), built as
  the JAX package's ``composer.batch.compile_task`` builds it (the root
  entity's MJCF with ``option/timestep`` set to the task's physics
  timestep, then ``compile_model``), and a golden for each,
  ``tests/data/torch_manipulation_<asset>_golden_f64.npz``, in the format
  above: the JAX ``manipulation.load_batch`` in float64 without contact
  compaction, its ``contact_*`` states ``FALL_STEPS`` control steps in
  (the arm on its way and, with a prop, the prop resting on the floor:
  prop-floor contacts active, its frame sensors nonzero) and the
  per-episode ``site_pos`` (reach_site) or ``_target_height`` (lift);
- on request (``soccer``, ``tracking``),
  ``dm_control_torch/locomotion/assets/<asset>.npz`` for each batched
  locomotion task (``LOCOMOTION_ASSETS``: BoxHead soccer 1 and 2 a side on
  the (12, 9) pitch, as the JAX package's ``soccer.load_batch`` builds it;
  mocap tracking with the rolling ball, as the JAX package's tracking
  bench rung builds it, and with the CMU 2020 humanoid, as its
  ``examples/cmu_2020_tracking.py`` does, both on synthetic clips), built
  as ``compile_task`` builds it (references: the port compiles these
  trees itself and is held to them), and a golden for each,
  ``tests/data/torch_locomotion_<asset>_golden_f64.npz``, in the format
  above (float64, no contact compaction; tracking's ``_clip`` and
  ``_start`` among the overrides).  In the soccer goldens' later states
  environment 0's ball rolls into the away goal and environment 1's into
  the home goal during the recorded step (``_score``);
- on request, ``tests/data/torch_env_<domain>_<task>_f64.npz`` for the
  single-environment episodes of ``ENV_GOLDENS``: the JAX package's
  ``suite.load(domain, task, task_kwargs={"random": ENV_SEED})`` in
  float64, its reset and ``ENV_STEPS`` control steps with actions drawn
  from ``numpy.random.RandomState(ENV_ACTION_SEED)`` uniform within the
  action spec's bounds, -1 and 1 where a bound is infinite
  (``actions``); for each timestep ``t`` its step type, reward and
  discount (not at the reset, where they are None), every observation
  and the physics state after it (``t<t>_step_type``, ``t<t>_reward``,
  ``t<t>_obs_<name>``, ``t<t>_step_<field>``, ...);
- on request, ``tests/data/torch_manipulation_env_<name>_f64.npz`` for the
  host episodes of ``MANIP_ENV_GOLDENS``: the JAX package's
  ``manipulation.load(name, seed=MANIP_ENV_SEED)`` (a
  ``composer.Environment``) in float64, its reset and ``MANIP_ENV_STEPS``
  control steps with actions drawn as above, in the format above, with
  the compiled model's ``geom_size`` and ``geom_rbound`` after the reset
  (``model_geom_size``, ``model_geom_rbound``: the Duplo bricks' stud
  radii, which the reset draws).  The manipulation models of
  ``MANIPULATION_ASSETS`` are references since the port compiles its
  entity trees: its compiles are held to them;
- on request, ``tests/data/torch_locomotion_env_<name>_f64.npz`` for the
  host episodes of ``LOCO_ENV_GOLDENS`` (``loco_env``: the JAX package's
  ``soccer.load`` one a side on its ``RandomizedPitch``, two a side on
  a fixed (12, 9) pitch with the field box, and the two tracking tasks
  through ``composer.Environment``), seed ``LOCO_ENV_SEED``, in the
  format of the manipulation host goldens (``model_geom_size`` holds the
  pitch drawn at the reset);
- on request, the same for the locomotion example environments of
  ``LOCO_EXAMPLE_GOLDENS`` (the JAX package's
  ``locomotion.examples.basic.<name>(random_state=LOCO_ENV_SEED)``, built
  after ``numpy.random.seed(LOCO_ENV_SEED)``: the corridors draw their
  layout from numpy's global state), with the compiled model's
  ``body_pos`` after the reset beside the geom fields
  (``model_body_pos``: the targets the maze and two-touch resets place).
  ``JAX_PLATFORMS=cpu python tools/export_torch_assets.py
  loco_example_goldens`` (or ``loco_env_golden:rodent_two_touch``, say)
  writes them;
- on request, the same for the soccer matches of other players in
  ``LOCO_WALKER_GOLDENS`` (``soccer.load`` with ANT players two a side on
  a fixed (12, 9) pitch, and with HUMANOID players one a side on the
  pitch drawn from the humanoids' areas, with the regulation ball; every
  soccer recording's arguments and seed are the port's
  ``rl.golden.SOCCER_EPISODES``): ``JAX_PLATFORMS=cpu python
  tools/export_torch_assets.py loco_walker_goldens``;
- on request, ``tests/data/torch_render_<name>.npz`` for each recorded
  scene of the port's ``rendering.golden.SCENES`` (``render_goldens``, or
  ``render_golden:<name>`` for one): the scene run on the CPU in float32
  by the port (``golden.record``: its reset and control steps), the
  model fields and state a frame reads, and the JAX package's frames of
  that state (rgb, plane depth, the segmentation's geom ids), rendered
  by ``tools/jax_render.py`` (XLA without fused multiply-add), compressed.
"""

from __future__ import annotations

import functools
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET_DIR = os.path.join(ROOT, "dm_control_torch", "suite", "assets")
MANIPULATION_ASSET_DIR = os.path.join(ROOT, "dm_control_torch",
                                      "manipulation", "assets")
GOLDEN_KEY = 7
GOLDEN_SEED = 11
GOLDEN_BATCH = 4
PREFIXES = ("reset", "contact")
STATE_FIELDS = ("qpos", "qvel", "qacc_warmstart", "time")

#: golden -> the task its file steps
GOLDEN_TASKS = {
    "humanoid": "run", "pendulum": "swingup", "acrobot": "swingup",
    "cartpole": "swingup", "reacher": "easy", "walker": "run",
    "cheetah": "run", "hopper": "hop", "point_mass": "hard",
    "ball_in_cup": "catch", "quadruped": "walk",
    "quadruped_escape": "escape", "quadruped_fetch": "fetch",
    "fish": "swim", "swimmer": "swimmer6", "finger": "turn_hard",
    "manipulator": "bring_ball", "manipulator_insert_peg": "insert_peg",
    "stacker": "stack_4", "humanoid_CMU": "run", "lqr": "lqr_6_2",
    "dog": "run", "dog_fetch": "fetch",
}
#: golden -> the keyword arguments of its task (lqr's model is seeded)
GOLDEN_TASK_KWARGS = {"lqr": {"random": 0}}
#: golden -> its domain, where the two names differ
GOLDEN_DOMAINS = {"quadruped_escape": "quadruped",
                  "quadruped_fetch": "quadruped",
                  "manipulator_insert_peg": "manipulator",
                  "dog_fetch": "dog"}
#: golden -> control steps between the ``reset_*`` and ``contact_*`` states
FALL_STEPS = {
    "humanoid": 40, "pendulum": 10, "acrobot": 10, "cartpole": 10,
    "reacher": 10, "walker": 40, "cheetah": 10, "hopper": 40,
    "point_mass": 10, "ball_in_cup": 30, "quadruped": 50,
    "quadruped_escape": 25, "quadruped_fetch": 200, "fish": 10,
    "swimmer": 10, "finger": 95, "manipulator": 65,
    "manipulator_insert_peg": 429, "stacker": 55, "humanoid_CMU": 40,
    "lqr": 10, "dog": 60, "dog_fetch": 20,
}
#: domain -> {asset name: arguments of the JAX domain's get_model}
ASSETS = {
    "humanoid": {"humanoid": ()}, "pendulum": {"pendulum": ()},
    "acrobot": {"acrobot": ()},
    "cartpole": {"cartpole": (1,), "cartpole_2": (2,), "cartpole_3": (3,)},
    "reacher": {"reacher_easy": (0.05,), "reacher_hard": (0.015,)},
    "walker": {"walker": ()}, "cheetah": {"cheetah": ()},
    "hopper": {"hopper": ()}, "point_mass": {"point_mass": ()},
    "ball_in_cup": {"ball_in_cup": ()},
    "quadruped": {
        "quadruped_walk": dict(floor_size=10.0),
        "quadruped_run": dict(floor_size=100),
        "quadruped_escape": dict(floor_size=40, terrain=True,
                                 rangefinders=True),
        "quadruped_fetch": dict(walls_and_ball=True)},
    "fish": {"fish": ()},
    "swimmer": {"swimmer6": (6,), "swimmer15": (15,)},
    "finger": {"finger": ()},
    "manipulator": {
        "manipulator_bring_ball": (False, False),
        "manipulator_bring_peg": (True, False),
        "manipulator_insert_ball": (False, True),
        "manipulator_insert_peg": (True, True)},
    "stacker": {"stacker_2": (2,), "stacker_4": (4,)},
    "humanoid_CMU": {"humanoid_CMU": ()},
    # (bodies, actuators, seed): the files hold seed 0's model
    "lqr": {"lqr_2_1": (2, 1, 0), "lqr_6_2": (6, 2, 0)},
    # stand's and walk's floor; trot and run compile floors of their own
    "dog": {"dog": dict(floor_size=15, remove_ball=True),
            "dog_fetch": dict(floor_size=10, remove_ball=False)},
}
DOMAINS = tuple(ASSETS)
#: manipulation asset -> the registry task whose physics it is
MANIPULATION_ASSETS = {
    "reach_site": "reach_site_features",
    "reach_duplo": "reach_duplo_features",
    "lift_brick": "lift_brick_features",
    "lift_large_box": "lift_large_box_features"}
#: manipulation golden -> the registry task its file steps
MANIPULATION_GOLDENS = {f"manipulation_{a}": t
                        for a, t in MANIPULATION_ASSETS.items()}
GOLDEN_TASKS.update(MANIPULATION_GOLDENS)
#: golden -> the key of its reset where it is not ``GOLDEN_KEY``.  The Jaco
#: arm's hand touches link 4 in every state, with forces of 1e4-1e5 on
#: light finger links: at the resets of key 7 a relative nudge of 2.2e-16
#: in qpos and qvel moves the next control step's qacc_warmstart by up to
#: 3.4e-9 of its largest entry, far past the golden gate.  Key 3's resets
#: move by at most 7.7e-14 of it and their qpos and qvel by 9e-12 (the
#: same nudge, every manipulation model; 60 keys searched).
GOLDEN_KEYS = {g: 3 for g in MANIPULATION_GOLDENS}
GOLDEN_DOMAINS.update({g: "manipulation" for g in MANIPULATION_GOLDENS})
#: the manipulation goldens' later states (from the resets of key 3, see
#: ``GOLDEN_KEYS``): reach_site's arm 5 steps in; the Duplo brick 4 steps
#: in, landed flat from up to 8 cm and still sliding; the large box 8 steps
#: in, back on the floor in every environment after the floor pushed it
#: out (it spawns up to 4 cm deep), one still sliding.  Of the first 30
#: steps these are states where a relative nudge of 2.2e-16 in qpos and
#: qvel moves the next step's qacc_warmstart by at most 1.8e-13 of its
#: largest entry and its qpos and qvel by 2.8e-10; at others the same
#: nudge moves them by up to 1.8e-7 and 2e-4.
FALL_STEPS.update({"manipulation_reach_site": 5,
                   "manipulation_reach_duplo": 4,
                   "manipulation_lift_brick": 4,
                   "manipulation_lift_large_box": 8})
LOCOMOTION_ASSET_DIR = os.path.join(ROOT, "dm_control_torch", "locomotion",
                                    "assets")
#: locomotion asset -> its family (the argument that exports it)
LOCOMOTION_ASSETS = {"soccer_1v1": "soccer", "soccer_2v2": "soccer",
                     "tracking_ball": "tracking",
                     "tracking_cmu2020": "tracking"}
#: locomotion golden -> its asset
LOCOMOTION_GOLDENS = {f"locomotion_{a}": a for a in LOCOMOTION_ASSETS}
GOLDEN_TASKS.update({g: a for g, a in LOCOMOTION_GOLDENS.items()})
GOLDEN_DOMAINS.update({g: "locomotion" for g in LOCOMOTION_GOLDENS})
#: the locomotion goldens' later states: soccer's ball landed, the
#: BoxHeads moving (then ``_score`` sets two balls rolling into the goals);
#: the rolling ball on the floor in every environment; the CMU humanoid
#: fallen on the floor in every environment (its episodes truncated).
#: Picked on the port alone among the first 40-60 steps as states where
#: every environment touches the floor and a relative nudge of 2.2e-16 in
#: qpos and qvel moves the next step's qacc_warmstart by at most 4.4e-14
#: of its largest entry and its qpos and qvel by at most 9.2e-14; the
#: rolling ball bounces (it touches the floor in all four environments at
#: 28 steps, not at 25), and at some states the same nudge moves the
#: ball's step by 8.6e-11 and the humanoid's by 7e-12
FALL_STEPS.update({"locomotion_soccer_1v1": 20, "locomotion_soccer_2v2": 20,
                   "locomotion_tracking_ball": 28,
                   "locomotion_tracking_cmu2020": 24})
#: the tracking configurations' time limits
TRACKING_TIME_LIMITS = {"tracking_ball": 10.0, "tracking_cmu2020": 30.0}
#: the soccer goldens' scoring environments: (environment, x of the ball,
#: its speed along x); the ball rolls on the floor at y = 0.5 and crosses
#: the goal line (x = +-10) by about 0.1 m during the step
SOCCER_SCORES = ((0, 9.85, 10.0), (1, -9.85, -10.0))
#: how far the scoring ball starts in the floor: a ball just touching it
#: (depth 0) sits at the contact's onset, where a change of one rounding in
#: qpos moves the next step's vertical speed by 3e-2; the ball at rest
#: sinks 6.4e-5
SOCCER_BALL_DEPTH = 1e-4
GOLDENS = tuple(GOLDEN_TASKS)
#: (domain, task) of each single-environment episode golden: RK4
#: (cartpole), 200 settle steps (cheetah), the rejection loop at the
#: slice's full width (humanoid), touch sensors at the reset (hopper), the
#: host choice of the start (manipulator), a drawn target (swimmer)
ENV_GOLDENS = (("cartpole", "swingup"), ("cheetah", "run"),
               ("humanoid", "run"), ("hopper", "hop"),
               ("manipulator", "bring_ball"), ("swimmer", "swimmer6"))
ENV_SEED = 11
ENV_ACTION_SEED = 1
ENV_STEPS = 5
#: the physics state recorded after each timestep of an episode golden
ENV_STATE_FIELDS = ("qpos", "qvel", "act", "qacc_warmstart", "time")
#: the host episode goldens: the manipulation tasks whose
#: ``manipulation.load`` episode is recorded, its seed and its steps
MANIP_ENV_GOLDENS = ("reach_site_features", "lift_large_box_features",
                     "place_cradle_features",
                     "stack_3_bricks_random_order_features")
MANIP_ENV_SEED = 11
MANIP_ENV_STEPS = 3
#: the locomotion host episode goldens: name -> how the JAX package builds
#: the environment (``loco_env``), its seed and its steps
LOCO_ENV_GOLDENS = ("soccer_1v1", "soccer_2v2_fixed", "tracking_ball",
                    "tracking_cmu2020")
LOCO_ENV_SEED = 11
LOCO_ENV_STEPS = 3
#: the locomotion example environments whose host episodes are recorded
#: (``loco_env``): gaps (about 45 platforms), a maze with its targets, the
#: bowl's height field, two-touch's state machine
LOCO_EXAMPLE_GOLDENS = ("cmu_humanoid_run_gaps", "cmu_humanoid_maze_forage",
                        "rodent_escape_bowl", "rodent_two_touch")
#: soccer matches of other players whose host episodes are recorded
#: (``loco_env``): ants two a side on a fixed pitch, humanoids one a side
LOCO_WALKER_GOLDENS = ("soccer_ant_2v2", "soccer_humanoid_1v1")


def golden_domain(golden):
    return GOLDEN_DOMAINS.get(golden, golden)


def goldens_of(domain):
    return tuple(g for g in GOLDENS if golden_domain(g) == domain)


def asset_path(asset):
    where = (MANIPULATION_ASSET_DIR if asset in MANIPULATION_ASSETS
             else LOCOMOTION_ASSET_DIR if asset in LOCOMOTION_ASSETS
             else ASSET_DIR)
    return os.path.join(where, asset + ".npz")


def golden_path(domain):
    return os.path.join(ROOT, "tests", "data",
                        f"torch_{domain}_golden_f64.npz")


def env_golden_name(domain, task):
    return f"{domain}_{task}"


def env_golden_path(name):
    return os.path.join(ROOT, "tests", "data", f"torch_env_{name}_f64.npz")


def make_env_golden(domain, task):
    """One float64 episode of the JAX package's ``suite.load``: the reset
    and ``ENV_STEPS`` control steps (see the module's docstring)."""
    from dm_control_tpu import suite

    env = suite.load(domain, task, task_kwargs={"random": ENV_SEED})
    spec = env.action_spec()
    low = np.where(np.isfinite(spec.minimum), spec.minimum, -1.0)
    high = np.where(np.isfinite(spec.maximum), spec.maximum, 1.0)
    rng = np.random.RandomState(ENV_ACTION_SEED)
    return _episode(env, np.stack([rng.uniform(low, high)
                                   for _ in range(ENV_STEPS)]))


def _episode(env, actions):
    """The reset and one control step per action of a JAX environment:
    each timestep's step type, reward and discount (not at the reset),
    observations and physics state, keyed as the module's docstring
    says."""
    out = {"actions": actions}
    for t in range(actions.shape[0] + 1):
        ts = env.step(actions[t - 1]) if t else env.reset()
        out[f"t{t}_step_type"] = np.asarray(int(ts.step_type))
        if t:
            out[f"t{t}_reward"] = np.asarray(ts.reward)
            out[f"t{t}_discount"] = np.asarray(ts.discount)
        out.update({f"t{t}_obs_{k}": np.asarray(v)
                    for k, v in ts.observation.items()})
        data = env.physics.data
        out.update({f"t{t}_step_{f}": np.asarray(getattr(data, f))
                    for f in ENV_STATE_FIELDS})
    return out


def make_manip_env_golden(name):
    """One float64 host episode of the JAX package's
    ``manipulation.load``: the reset and ``MANIP_ENV_STEPS`` control steps,
    with the stud radii of its reset (see the module's docstring; only a
    reset writes them)."""
    from dm_control_tpu import manipulation

    env = manipulation.load(name, seed=MANIP_ENV_SEED)
    spec = env.action_spec()
    rng = np.random.RandomState(ENV_ACTION_SEED)
    out = _episode(env, np.stack([rng.uniform(spec.minimum, spec.maximum)
                                  for _ in range(MANIP_ENV_STEPS)]))
    m = env.physics.model
    out.update({f"model_{f}": np.asarray(getattr(m, f))
                for f in ("geom_size", "geom_rbound")})
    return out


def loco_env(name, seed=None):
    """The JAX package's locomotion host environment of a name of
    ``LOCO_ENV_GOLDENS``, ``LOCO_EXAMPLE_GOLDENS`` or
    ``LOCO_WALKER_GOLDENS``: a soccer match of the port's
    ``rl.golden.SOCCER_EPISODES`` (``soccer.load`` with its arguments: one
    a side on its default ``RandomizedPitch``, drawn and compiled every
    episode; two a side on a fixed (12, 9) pitch with the field box; ants
    two a side on that pitch; humanoids one a side), the two tracking
    tasks of ``locomotion_task`` through ``composer.Environment`` with
    their time limits and seed ``LOCO_ENV_SEED``, or the example
    environment, built after numpy's global state is seeded with
    ``LOCO_ENV_SEED``.  ``seed`` takes the place of the recording's."""
    from dm_control_torch.rl.golden import SOCCER_EPISODES

    if name in SOCCER_EPISODES:
        from dm_control_tpu.locomotion import soccer

        kwargs = dict(SOCCER_EPISODES[name])
        if seed is not None:
            kwargs["random_state"] = seed
        return soccer.load(**kwargs)
    seed = LOCO_ENV_SEED if seed is None else seed
    if name in LOCO_EXAMPLE_GOLDENS:
        from dm_control_tpu.locomotion.examples import basic

        np.random.seed(seed)
        return getattr(basic, name)(random_state=seed)
    from dm_control_tpu import composer

    return composer.Environment(locomotion_task(name),
                                time_limit=TRACKING_TIME_LIMITS[name],
                                random_state=seed)


def make_loco_env_golden(name, seed=None):
    """One float64 host episode of ``loco_env(name, seed)``: the reset and
    ``LOCO_ENV_STEPS`` control steps with actions drawn as for the
    manipulation host goldens, with the compiled model's ``geom_size``
    and ``geom_rbound`` after the reset (the drawn pitch's size), and
    ``body_pos`` for the example environments (the placed targets)."""
    env = loco_env(name, seed)
    spec = env.action_spec()
    rng = np.random.RandomState(ENV_ACTION_SEED)
    out = _episode(env, np.stack([rng.uniform(spec.minimum, spec.maximum)
                                  for _ in range(LOCO_ENV_STEPS)]))
    m = env.physics.model
    fields = ("geom_size", "geom_rbound") + (
        ("body_pos",) if name in LOCO_EXAMPLE_GOLDENS else ())
    out.update({f"model_{f}": np.asarray(getattr(m, f)) for f in fields})
    return out


def loco_env_golden_path(name):
    return os.path.join(ROOT, "tests", "data",
                        f"torch_locomotion_env_{name}_f64.npz")


def write_loco_env_golden(name):
    np.savez(loco_env_golden_path(name), **make_loco_env_golden(name))
    print("wrote", os.path.relpath(loco_env_golden_path(name), ROOT),
          flush=True)


def render_golden_path(name):
    return os.path.join(ROOT, "tests", "data", f"torch_render_{name}.npz")


def jax_render_tool():
    """``tools/jax_render.py`` as a module."""
    import importlib.util

    path = os.path.join(ROOT, "tools", "jax_render.py")
    spec = importlib.util.spec_from_file_location("jax_render", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_render_frames(name, physics, recording):
    """The JAX package's frames of scene ``name``'s recorded state (the
    recording's ``state_*`` and ``pose``) on the model of ``physics``."""
    from dm_control_torch.rendering import golden

    scene = golden.SCENES[name]
    camera = scene.camera
    if isinstance(camera, str):
        camera = physics.model.names.camera[camera]
    tool = jax_render_tool()
    job = tool.scene_job(
        physics, scene.height, scene.width,
        camera_id=-1 if camera is None else camera,
        pose=recording.get("pose"),
        state={f: recording[f"state_{f}"] for f in golden.STATE_FIELDS})
    frames, = tool.render([job])
    return dict(rgb=frames["rgb"], depth=frames["depth"],
                seg=frames["seg"].astype(np.int16))


def make_render_golden(name):
    """Scene ``name`` recorded by the port on the CPU and framed by the JAX
    package's renderer (module docstring)."""
    from dm_control_torch.rendering import golden

    physics, out = golden.record(name)
    out.update(jax_render_frames(name, physics, out))
    return out


def write_render_golden(name):
    np.savez_compressed(render_golden_path(name), **make_render_golden(name))
    print("wrote", os.path.relpath(render_golden_path(name), ROOT),
          flush=True)


def manip_env_golden_path(name):
    return os.path.join(ROOT, "tests", "data",
                        f"torch_manipulation_env_{name}_f64.npz")


def write_manip_env_golden(name):
    np.savez(manip_env_golden_path(name), **make_manip_env_golden(name))
    print("wrote", os.path.relpath(manip_env_golden_path(name), ROOT),
          flush=True)


def write_env_golden(name):
    pairs = {env_golden_name(*p): p for p in ENV_GOLDENS}
    np.savez(env_golden_path(name), **make_env_golden(*pairs[name]))
    print("wrote", os.path.relpath(env_golden_path(name), ROOT), flush=True)


def _manipulation_task(name):
    """The JAX package's composer task of a manipulation registry name."""
    from dm_control_tpu import manipulation  # noqa: F401 (fills the registry)
    from dm_control_tpu.manipulation.shared import registry

    return registry.get(name)().task


def manipulation_model(asset):
    """The compiled model of a manipulation asset, built as
    ``dm_control_tpu/composer/batch.py::compile_task`` builds it."""
    from dm_control_tpu.mjcf.compiler import compile_model

    task = _manipulation_task(MANIPULATION_ASSETS[asset])
    root = task.root_entity.mjcf_model
    opt = root.first("option")
    if opt is None:
        opt = root.add("option")
    opt.attrib["timestep"] = str(task.physics_timestep)
    return compile_model(root)


def locomotion_task(asset):
    """The JAX package's composer task of a locomotion asset: soccer as its
    ``soccer.load_batch`` builds it, ball tracking as its tracking bench
    rung (``bench.py``), CMU tracking as ``examples/cmu_2020_tracking.py``
    (synthetic clips)."""
    from dm_control_tpu.locomotion.arenas.floors import Floor
    from dm_control_tpu.locomotion.mocap.loader import (
        synthetic_walking_trajectory,
    )
    from dm_control_tpu.locomotion.mocap.types import ClipCollection
    from dm_control_tpu.locomotion.tasks.reference_pose import (
        MultiClipMocapTracking,
    )

    if asset.startswith("soccer_"):
        from dm_control_tpu.locomotion.soccer import loader, pitch, task
        from dm_control_tpu.locomotion.soccer.soccer_ball import SoccerBall

        return task.Task(
            players=loader._make_players(int(asset[-1]),
                                         loader.WalkerType.BOXHEAD),
            arena=pitch.Pitch(size=(12, 9),
                              field_box=loader.enable_field_box_default()),
            ball=SoccerBall())
    if asset == "tracking_ball":
        from dm_control_tpu.locomotion.walkers.jumping_ball import (
            RollingBallWithHead,
        )

        walker = RollingBallWithHead()
        nq = 7 + len(walker.observable_joint_names)
        trajs = {f"clip{i}": synthetic_walking_trajectory(
            nq=nq, nv=nq - 1, num_steps=120, seed=i) for i in range(4)}
        return MultiClipMocapTracking(
            walker, Floor(), trajs,
            dataset=ClipCollection(ids=tuple(trajs)),
            termination_error_threshold=50.0, reward_type="comic")
    if asset == "tracking_cmu2020":
        from dm_control_tpu.locomotion.walkers.cmu_humanoid import (
            CMUHumanoidPositionControlledV2020,
        )

        walker = CMUHumanoidPositionControlledV2020()
        njoint = len(walker.mocap_joint_names)
        trajs = {f"synthetic_walk_{k}": synthetic_walking_trajectory(
            nq=njoint + 7, nv=njoint + 6, seed=k,
            identifier=f"synthetic_walk_{k}") for k in range(3)}
        return MultiClipMocapTracking(
            walker=walker, arena=Floor(), ref_path_or_trajectories=trajs,
            ref_steps=(1, 2, 3, 4, 5), min_steps=10, reward_type="comic")
    raise KeyError(asset)


def locomotion_model(asset):
    """The compiled model of a locomotion asset, built as
    ``dm_control_tpu/composer/batch.py::compile_task`` builds it."""
    from dm_control_tpu.mjcf.compiler import compile_model

    task = locomotion_task(asset)
    root = task.root_entity.mjcf_model
    opt = root.first("option")
    if opt is None:
        opt = root.add("option")
    opt.attrib["timestep"] = str(task.physics_timestep)
    return compile_model(root)


def jax_model(asset):
    """The JAX package's compiled model behind an asset name."""
    import importlib

    import numpy as np

    if asset in MANIPULATION_ASSETS:
        return manipulation_model(asset)
    if asset in LOCOMOTION_ASSETS:
        return locomotion_model(asset)
    for domain, assets in ASSETS.items():
        if asset in assets:
            module = importlib.import_module(f"dm_control_tpu.suite.{domain}")
            args = assets[asset]
            if domain == "lqr":
                return module.get_model(*args[:2], np.random.RandomState(
                    args[2]))
            if domain == "dog":
                return module._make_model(**args)
            if isinstance(args, dict):
                return module.get_model(**args)
            return module.get_model(*args)
    raise KeyError(asset)


def export_model(asset):
    from dm_control_torch.physics import model_io

    model_io.save(asset_path(asset), model_io.from_jax_model(
        jax_model(asset)))


def _jax_env(golden):
    from dm_control_tpu import suite

    if golden in LOCOMOTION_GOLDENS:
        # float64: no contact compaction, as for manipulation
        import jax.numpy as jnp

        asset = LOCOMOTION_GOLDENS[golden]
        if asset.startswith("soccer_"):
            from dm_control_tpu.locomotion import soccer

            return soccer.load_batch(team_size=int(asset[-1]),
                                     dtype=jnp.float64, autoreset=False)
        from dm_control_tpu.composer.batch import compile_task

        return compile_task(locomotion_task(asset),
                            time_limit=TRACKING_TIME_LIMITS[asset],
                            dtype=jnp.float64, autoreset=False)

    if golden in MANIPULATION_GOLDENS:
        # float64 asks for no contact compaction (the JAX BatchEnv engages
        # it without a dtype); the port's float64 runs without it too
        import jax.numpy as jnp

        from dm_control_tpu import manipulation

        return manipulation.load_batch(MANIPULATION_GOLDENS[golden],
                                       dtype=jnp.float64, autoreset=False)
    env = suite.load_batch(golden_domain(golden), GOLDEN_TASKS[golden],
                           task_kwargs=GOLDEN_TASK_KWARGS.get(golden),
                           autoreset=False)
    if golden_domain(golden) == "dog":
        # the JAX dog task computes its pose constants on the host, once
        # per model, before anything traces them
        from dm_control_tpu.suite import dog

        dog._pose_consts(env.model)
    return env


def _state_fields(m):
    """The recorded state fields: ``act`` only where the model has one."""
    return STATE_FIELDS + (("act",) if m.na else ())


def _snapshot(state, prefix, fields):
    out = {f"{prefix}_{f}": np.asarray(getattr(state.data, f))
           for f in fields}
    out.update({f"{prefix}_diff_{k}": np.asarray(v)
                for k, v in state.model_diff.items()})
    return out


def _host_reset(env):
    """Start states drawn as the JAX single-environment reset draws them,
    on the host with numpy (one ``RandomState`` a environment, seeded
    ``GOLDEN_KEY * 1000 + i``): ``init``, then ``init_act``.  For tasks
    whose ``init`` runs on the host only (dog's), where the JAX
    ``BatchEnv.reset`` cannot trace it."""
    import jax
    import jax.numpy as jnp

    from dm_control_tpu.physics.model import make_data
    from dm_control_tpu.rl.control import EnvState, RandomContext

    m, task = env.model, env.task
    rows = []
    for i in range(GOLDEN_BATCH):
        rc = RandomContext(np_random=np.random.RandomState(
            GOLDEN_KEY * 1000 + i))
        qpos, qvel, _ = task.init(m, np.asarray(m.qpos0).copy(),
                                  np.zeros(m.nv), rc,
                                  task.initial_model_diff(m))
        rows.append((qpos, qvel, task.init_act(m, rc)))
    data = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (GOLDEN_BATCH,) + x.shape),
        env._strip(make_data(m)))
    data = data.replace(**{f: jnp.asarray(np.stack([r[k] for r in rows]))
                           for k, f in enumerate(("qpos", "qvel", "act"))})
    return EnvState(data=data, model_diff={},
                    rng=jax.random.split(jax.random.PRNGKey(GOLDEN_KEY),
                                         GOLDEN_BATCH),
                    step_count=jnp.zeros(GOLDEN_BATCH, jnp.int32),
                    needs_reset=jnp.zeros(GOLDEN_BATCH, bool))


def golden_states(domain):
    """The float64 start states: ``reset_*`` from a JAX reset (for dog's
    goldens ``_host_reset``), and ``contact_*``, the same environments
    ``FALL_STEPS[domain]`` control steps later."""
    import jax
    import jax.numpy as jnp

    env = _jax_env(domain)
    if golden_domain(domain) == "dog":
        state = _host_reset(env)
    else:
        state, _ = env.reset(jax.random.split(
            jax.random.PRNGKey(GOLDEN_KEYS.get(domain, GOLDEN_KEY)),
            GOLDEN_BATCH))
    fields = _state_fields(env.model)
    out = _snapshot(state, "reset", fields)
    rng = np.random.default_rng(GOLDEN_SEED + 1)
    for _ in range(FALL_STEPS[domain]):
        state, _ = env.step(state, jnp.asarray(rng.uniform(
            -1.0, 1.0, (GOLDEN_BATCH, env.model.nu))))
    out.update(_snapshot(state, "contact", fields))
    if domain in ("locomotion_soccer_1v1", "locomotion_soccer_2v2"):
        _score(env, out)
    return out


def _score(env, out):
    """Sets the ball of each of ``SOCCER_SCORES``' environments in the
    ``contact_*`` states rolling on the floor toward a goal, to cross its
    line during the next control step."""
    m = env.model
    j = next(j for n, j in m.names.joint.items()
             if n.startswith("soccer_ball") and n.endswith("_root"))
    a, v = int(m.jnt_qposadr[j]), int(m.jnt_dofadr[j])
    radius = float(m.geom_size[int(m.body_geomadr[int(m.jnt_bodyid[j])]),
                               0])
    for e, x, speed in SOCCER_SCORES:
        for f in ("qpos", "qvel", "qacc_warmstart"):
            out[f"contact_{f}"] = np.array(out[f"contact_{f}"])
        out["contact_qpos"][e, a:a + 7] = [x, 0.5, radius - SOCCER_BALL_DEPTH,
                                           1, 0, 0, 0]
        # rolling without slip: spin about y of speed / radius
        out["contact_qvel"][e, v:v + 6] = [speed, 0, 0, 0, speed / radius,
                                           0]
        out["contact_qacc_warmstart"][e, v:v + 6] = 0.0


def golden_step(domain, states, prefix):
    """One JAX control step from the start states ``states[prefix_*]``
    with actions drawn from numpy seed ``GOLDEN_SEED``."""
    import jax.numpy as jnp

    from dm_control_torch.rl.golden import model_diff
    from dm_control_tpu.physics.model import make_data
    from dm_control_tpu.rl.control import EnvState

    env = _jax_env(domain)
    m = env.model
    B = states[f"{prefix}_qpos"].shape[0]
    actions = np.random.default_rng(GOLDEN_SEED).uniform(
        -1.0, 1.0, (B, m.nu))
    fields = _state_fields(m)
    data = env._strip(make_data(m).replace(
        **{f: jnp.asarray(states[f"{prefix}_{f}"]) for f in fields}))
    diff = {k: jnp.asarray(v)
            for k, v in model_diff(states, prefix).items()}
    state = EnvState(data=data, model_diff=diff, rng=None,
                     step_count=jnp.zeros(B, jnp.int32),
                     needs_reset=jnp.zeros(B, bool))
    state, ts = env.step(state, jnp.asarray(actions))
    out = {f"{prefix}_actions": actions,
           f"{prefix}_reward": np.asarray(ts.reward),
           f"{prefix}_discount": np.asarray(ts.discount),
           f"{prefix}_step_type": np.asarray(ts.step_type)}
    out.update({f"{prefix}_step_{f}": np.asarray(getattr(state.data, f))
                for f in fields})
    out.update({f"{prefix}_obs_{k}": np.asarray(v)
                for k, v in ts.observation.items()})
    return out


#: environments a start-state kind of the features recording
FEATURES_BATCH = 4
#: the features recording's torso height in each kind of start state: in
#: the air, and with the box's lower corners and the chain in the floor
FEATURES_HEIGHT = {"reset": 0.3, "contact": 0.045}


def features_states(m, prefix, batch, seed=3):
    """Start states of the features model (numpy, float64): qpos0 with
    every scalar joint moved by N(0, 0.05^2), every quaternion turned by
    a rotation of N(0, 0.1^2) per axis, the torso at ``FEATURES_HEIGHT``
    of the prefix's kind, N(0, 0.3^2) velocities and U(-1, 1) controls;
    ``qacc_warmstart`` and ``time`` 0."""
    from dm_control_torch.physics.model import JointType

    rng = np.random.RandomState(seed)
    qpos = np.tile(m.qpos0.cpu().numpy().astype(np.float64), (batch, 1))
    for j in range(m.njnt):
        a, jtype = m.jnt_qposadr[j], m.jnt_type[j]
        if jtype in (int(JointType.HINGE), int(JointType.SLIDE)):
            qpos[:, a] += 0.05 * rng.randn(batch)
            continue
        if jtype == int(JointType.FREE):
            qpos[:, a:a + 3] += 0.05 * rng.randn(batch, 3)
            a += 3
        rot = 0.1 * rng.randn(batch, 3)
        half = 0.5 * np.linalg.norm(rot, axis=1, keepdims=True)
        dq = np.concatenate([np.cos(half), np.sinc(half / np.pi) * 0.5 * rot],
                            axis=1)
        q = qpos[:, a:a + 4]
        w1, v1, w2, v2 = q[:, :1], q[:, 1:], dq[:, :1], dq[:, 1:]
        prod = np.concatenate([w1 * w2 - np.sum(v1 * v2, 1, keepdims=True),
                               w1 * v2 + w2 * v1 + np.cross(v1, v2)], 1)
        qpos[:, a:a + 4] = prod / np.linalg.norm(prod, axis=1, keepdims=True)
        if jtype == int(JointType.FREE):
            qpos[:, a - 1] = FEATURES_HEIGHT[prefix.split("_")[-1]]
    return dict(qpos=qpos, qvel=0.3 * rng.randn(batch, m.nv),
                qacc_warmstart=np.zeros((batch, m.nv)),
                time=np.zeros(batch),
                actions=rng.uniform(-1.0, 1.0, (batch, m.nu)))


def features_golden_path():
    from dm_control_torch.rl import golden

    return os.path.join(ROOT, *golden.FEATURES_GOLDEN)


def make_features_golden():
    """The features recording (``rl/golden.py``, ``FEATURES_PREFIXES``):
    the port's float64 compile of ``tests/data/torch_features.xml``, held
    field by field in a JAX ``Model`` (``tests/_torch_helpers.py::
    jax_model_from_port``), stepped once by the JAX engine from each
    prefix's start states."""
    import jax
    import jax.numpy as jnp
    import torch

    from dm_control_tpu.physics import engine as jengine
    from dm_control_tpu.physics.model import make_data as jmake_data
    from dm_control_torch.rl import golden

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_helpers import jax_model_from_port

    out = {}
    for prefix in golden.FEATURES_PREFIXES:
        m = golden.features_model(ROOT, prefix, "cpu", torch.float64)
        jm = jax_model_from_port(m)
        state = features_states(m, prefix, FEATURES_BATCH)

        def one(qpos, qvel, warm, time, ctrl):
            d = jmake_data(jm).replace(qpos=qpos, qvel=qvel,
                                       qacc_warmstart=warm, time=time,
                                       ctrl=ctrl)
            d = jengine.step(jm, d)
            return {f: getattr(d, f) for f in golden.FEATURES_STEP_FIELDS}

        args = [jnp.asarray(state[k]) for k in (
            "qpos", "qvel", "qacc_warmstart", "time", "actions")]
        got = jax.jit(jax.vmap(one))(*args)
        out.update({f"{prefix}_{k}": v for k, v in state.items()})
        out.update({f"{prefix}_step_{k}": np.asarray(v)
                    for k, v in got.items()})
        if prefix.startswith("euler_"):
            stages = jax.jit(jax.vmap(functools.partial(
                features_stages, jm)))(*args)
            out.update({f"{prefix}_stage_{k}": np.asarray(v)
                        for k, v in stages.items()})
    return out


def features_stages(m, qpos, qvel, warm, time, ctrl):
    """The pipeline's stages at one start state, by name
    (``rl/golden.py::FEATURES_STAGES``), through the module functions of
    the JAX package (``tests/test_torch_engine_features.py`` calls the
    port's of the same names)."""
    from dm_control_tpu.physics import constraints, engine, sensors
    from dm_control_tpu.physics.model import make_data

    d = make_data(m).replace(qpos=qpos, qvel=qvel, qacc_warmstart=warm,
                             time=time, ctrl=ctrl)
    return features_stage_fields(engine, sensors, constraints, m, d)


def features_stage_fields(engine, sensors, constraints, m, d):
    """``features_stages``' fields from either package's modules."""
    from dm_control_torch.rl import golden

    pv = sensors.sensor_vel(m, engine.fwd_velocity(
        m, sensors.sensor_pos(m, engine.fwd_position(m, d))))
    efc = constraints.make_constraint(m, pv)
    fw = engine.forward(m, d)
    out = {f: getattr(pv, f) for f in golden.FEATURES_STAGES}
    out.update({f"efc_{f}": getattr(efc, f)
                for f in ("J", "D", "R", "aref", "pos")})
    out.update({f"contact_{f}": getattr(pv.contact, f)
                for f in ("dist", "pos", "frame")})
    out.update({f"forward_{f}": getattr(fw, f)
                for f in golden.FEATURES_FORWARD})
    return out


#: the fast path's recording (``fastpath_golden``): the contact models
#: whose fused step is recorded, the golden states it starts from and the
#: steps recorded from each
FASTPATH_ASSETS = ("cheetah", "walker")
FASTPATH_PREFIXES = ("reset", "contact")
FASTPATH_STEPS = 10


def fastpath_golden_path():
    return os.path.join(ROOT, "tests", "data",
                        "torch_fastpath_contacts_f64.npz")


def make_fastpath_golden():
    """The JAX package's ``fastpath.build_step`` of each of
    ``FASTPATH_ASSETS`` (the checked-in asset held in a JAX ``Model``,
    ``tests/_torch_helpers.py::jax_model_from_asset``), stepped
    ``FASTPATH_STEPS`` times from each golden start state of
    ``FASTPATH_PREFIXES`` (cheetah after its 200 settle steps and 10
    control steps later, walker after its reset and 40 control steps later;
    lying or standing on the floor) with the golden's actions held fixed:
    ``<asset>_<prefix>_<field>`` (steps + 1, B, n) for qpos, qvel and the
    warm start, and ``<asset>_<prefix>_ctrl`` (B, nu)."""
    import jax
    import jax.numpy as jnp

    from dm_control_tpu.physics import fastpath as jfastpath

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_helpers import jax_model_from_asset

    out = {}
    for asset in FASTPATH_ASSETS:
        step = jax.jit(jax.vmap(jfastpath.build_step(
            jax_model_from_asset(asset))))
        with np.load(golden_path(asset)) as gold:
            for prefix in FASTPATH_PREFIXES:
                state = [jnp.asarray(gold[f"{prefix}_{f}"]) for f in (
                    "qpos", "qvel", "qacc_warmstart")]
                ctrl = jnp.asarray(gold[f"{prefix}_actions"])
                rows = [state]
                for _ in range(FASTPATH_STEPS):
                    state = list(step(*state, ctrl))
                    rows.append(state)
                for k, f in enumerate(("qpos", "qvel", "warm")):
                    out[f"{asset}_{prefix}_{f}"] = np.stack(
                        [np.asarray(r[k]) for r in rows])
                out[f"{asset}_{prefix}_ctrl"] = np.asarray(ctrl)
        print("recorded", asset, flush=True)
    return out


#: ``measure_separation_force``'s arguments of the Duplo recording: five
#: steps a probe, a bracket around the force such a short probe needs
DUPLO_ARGS = dict(min_force=512.0, max_force=1024.0, tolerance=8.0,
                  time_limit=0.01)
#: the force of the recorded probe whose heights are kept
DUPLO_PROBE_FORCE = 900.0


def duplo_golden_path():
    return os.path.join(ROOT, "tests", "data",
                        "torch_duplo_separation_f64.npz")


def make_duplo_golden():
    """The JAX package's ``measure_separation_force`` of two default
    bricks at ``DUPLO_ARGS`` (``force``), and the top brick's height
    before each step of one probe at ``DUPLO_PROBE_FORCE``
    (``probe_heights``), read as the probe reads it."""
    from dm_control_tpu.entities.props import duplo
    from dm_control_tpu.entities.props.duplo import utils
    from dm_control_tpu.physics.physics import Physics

    force = utils.measure_separation_force(duplo.Duplo(), duplo.Duplo(),
                                           **DUPLO_ARGS)
    arena, frame = utils.stack_bricks(duplo.Duplo(), duplo.Duplo())
    root = arena.mjcf_model
    option = root.first("option") or root.add("option")
    option.attrib["gravity"] = "0 0 0"
    physics = Physics.from_mjcf_model(root)
    binding = physics.bind(frame)
    n_steps = int(round(DUPLO_ARGS["time_limit"]
                        / float(physics.model.opt.timestep)))
    physics.reset()
    heights = [float(binding.xpos[2])]
    binding.xfrc_applied = np.array([0, 0, DUPLO_PROBE_FORCE, 0, 0, 0.0])
    for _ in range(n_steps):
        physics.step()
        heights.append(float(binding.xpos[2]))
    return dict(force=np.float64(force), probe_heights=np.array(heights))


def make_golden(domain="humanoid"):
    golden = golden_states(domain)
    for prefix in PREFIXES:
        golden.update(golden_step(domain, golden, prefix))
    return golden


def main(argv=None):
    sys.path.insert(0, ROOT)
    args = list(sys.argv[1:] if argv is None else argv)
    import jax

    jax.config.update("jax_enable_x64", True)
    for domain in args or DOMAINS:
        if domain == "env_goldens":
            for pair in ENV_GOLDENS:
                write_env_golden(env_golden_name(*pair))
            continue
        if domain.startswith("env_golden:"):
            write_env_golden(domain[len("env_golden:"):])
            continue
        if domain == "manip_env_goldens":
            for name in MANIP_ENV_GOLDENS:
                write_manip_env_golden(name)
            continue
        if domain.startswith("manip_env_golden:"):
            write_manip_env_golden(domain[len("manip_env_golden:"):])
            continue
        if domain in ("loco_env_goldens", "loco_example_goldens",
                      "loco_walker_goldens"):
            for name in {"loco_env_goldens": LOCO_ENV_GOLDENS,
                         "loco_example_goldens": LOCO_EXAMPLE_GOLDENS,
                         "loco_walker_goldens": LOCO_WALKER_GOLDENS}[domain]:
                write_loco_env_golden(name)
            continue
        if domain == "render_goldens":
            from dm_control_torch.rendering.golden import SCENES

            for name in SCENES:
                write_render_golden(name)
            continue
        if domain.startswith("render_golden:"):
            write_render_golden(domain[len("render_golden:"):])
            continue
        if domain.startswith("loco_env_golden:"):
            write_loco_env_golden(domain[len("loco_env_golden:"):])
            continue
        if domain in ("soccer", "tracking"):
            assets = [a for a, f in LOCOMOTION_ASSETS.items() if f == domain]
            for asset in assets:
                export_model(asset)
            print("wrote", ", ".join(assets), flush=True)
            for asset in assets:
                golden = f"locomotion_{asset}"
                np.savez(golden_path(golden), **make_golden(golden))
                print("wrote", os.path.relpath(golden_path(golden), ROOT),
                      flush=True)
            continue
        if domain == "manipulation":
            for asset in MANIPULATION_ASSETS:
                export_model(asset)
            print("wrote", ", ".join(MANIPULATION_ASSETS), flush=True)
            for golden in MANIPULATION_GOLDENS:
                np.savez(golden_path(golden), **make_golden(golden))
                print("wrote", os.path.relpath(golden_path(golden), ROOT),
                      flush=True)
            continue
        if domain == "duplo_golden":
            np.savez(duplo_golden_path(), **make_duplo_golden())
            print("wrote", os.path.relpath(duplo_golden_path(), ROOT),
                  flush=True)
            continue
        if domain == "fastpath_golden":
            np.savez(fastpath_golden_path(), **make_fastpath_golden())
            print("wrote", os.path.relpath(fastpath_golden_path(), ROOT),
                  flush=True)
            continue
        if domain == "golden:features":
            np.savez(features_golden_path(), **make_features_golden())
            print("wrote", os.path.relpath(features_golden_path(), ROOT),
                  flush=True)
            continue
        if domain.startswith("golden:"):
            golden = domain[len("golden:"):]
            np.savez(golden_path(golden), **make_golden(golden))
            print("wrote", os.path.relpath(golden_path(golden), ROOT),
                  flush=True)
            continue
        for asset in ASSETS[domain]:
            export_model(asset)
        print("wrote", ", ".join(ASSETS[domain]), flush=True)
        for golden in goldens_of(domain):
            np.savez(golden_path(golden), **make_golden(golden))
            print("wrote", os.path.relpath(golden_path(golden), ROOT),
                  flush=True)


if __name__ == "__main__":
    main()
