"""The port's fish and swimmer paths against the JAX package, in float64 on
the CPU: the fluid forces (``dynamics._fluid``, through ``passive``) at
random velocities with and without a wind, the frame and velocity sensors,
one ``engine.step`` (1e-9, equal ``solver_niter``) and one golden
``BatchEnv.step`` per domain (1e-8).  Function by function the tolerance is
1e-12: both sides compute the same expressions and differ in the order of
their sums.  States are the goldens' (tools/export_torch_assets.py) with
velocities from a numpy seed.
"""

import numpy as np
import pytest
import torch

from _torch_helpers import PREFIXES, assert_stages_close, \
    assert_step_matches_golden, export_tool, golden, golden_rows, stages_both
from dm_control_torch import suite as tsuite
from dm_control_torch.physics import dynamics as tdyn
from dm_control_torch.physics.model import SensorType

#: golden, its asset and its task
CASES = {"fish": ("fish", "swim"), "swimmer": ("swimmer6", "swimmer6")}
WIND = np.array([0.3, -0.2, 0.1])


def _state(domain, seed=0):
    gold = golden(domain)
    state, diff = golden_rows(gold, [("reset", 0), ("contact", 1),
                                     ("contact", 2)])
    rng = np.random.default_rng(seed)
    state["qvel"] = state["qvel"] + rng.normal(size=state["qvel"].shape)
    return state, diff


@pytest.mark.parametrize("wind", [None, WIND], ids=["still", "wind"])
@pytest.mark.parametrize("domain", CASES)
def test_stages_match_jax(domain, wind):
    state, diff = _state(domain)
    m, out = stages_both(CASES[domain][0], state, diff, wind=wind)
    # fish disables all constraints: the port then collides nothing, while
    # the JAX package still fills contacts that nothing reads
    assert_stages_close(out, skip=("contact_dist", "contact_pos",
                                   "contact_frame", "step_contact_force_vec")
                        if domain == "fish" else ())
    # the medium acts: the passive force is not the dampers' alone
    passive = out["qfrc_passive"][0]
    dampers = -m.dof_damping * torch.as_tensor(state["qvel"])
    assert float((passive - dampers).abs().max()) > 1e-3
    if wind is not None:
        still = stages_both(CASES[domain][0], state, diff)[1]
        assert float((still["qfrc_passive"][0] - passive).abs().max()) > 1e-4
    # the sensors were written (a planar swimmer's z values stay 0)
    written = out["sensordata_posvel"][0].abs().sum(0) > 0
    assert int(written.sum()) > m.nsensordata // 2
    types = {SensorType(t).name for t in m.sensor_type}
    if domain == "swimmer":
        assert {"FRAMEPOS", "FRAMEXAXIS", "FRAMEYAXIS"} <= types
        assert m.opt.disableflags & 16 and out["efc_J"][0].shape[1] == 10
    else:  # constraints and gravity are off: no rows, no contacts
        assert out["efc_J"][0].shape[1] == 0
        assert out["contact_dist"][0].shape[1] == 0


def test_fluid_gate_is_a_host_check_on_the_models_constants():
    env = tsuite.load_batch("swimmer", "swimmer6", device="cpu",
                            dtype=torch.float64)
    m = env.model
    assert tdyn._passive_plan(m)[1] is True
    zero = torch.zeros((), dtype=torch.float64)
    dry = m.replace(opt=m.opt.replace(density=zero, viscosity=zero))
    assert tdyn._passive_plan(dry)[1] is False
    windy = dry.replace(opt=dry.opt.replace(wind=torch.as_tensor(WIND)))
    assert tdyn._passive_plan(windy)[1] is True


@pytest.mark.parametrize("prefix", PREFIXES)
@pytest.mark.parametrize("domain", CASES)
def test_batch_env_step_matches_golden(domain, prefix):
    env = tsuite.load_batch(CASES[domain][0] if domain == "fish"
                            else "swimmer", CASES[domain][1], device="cpu",
                            dtype=torch.float64, autoreset=False)
    gold = golden(domain)
    assert_step_matches_golden(env, gold, prefix)
    # the golden states move through the medium
    assert float(np.abs(gold["contact_qvel"]).max()) > 0.1


def test_swimmer15_observes_its_sensor_pairs_by_position():
    env = tsuite.load_batch("swimmer", "swimmer15", device="cpu",
                            dtype=torch.float64, autoreset=False)
    m = env.model
    # after the first 12 values come 15 velocimeter and gyro pairs, the
    # head's and the 14 segments'
    assert m.nsensordata == 12 + 6 * 15
    pairs = [(SensorType(m.sensor_type[s]).name, m.sensor_adr[s])
             for s in range(m.nsensor) if m.sensor_adr[s] >= 12]
    assert pairs == [(("VELOCIMETER", "GYRO")[i % 2], 12 + 3 * i)
                     for i in range(30)]
    _, ts = env.reset(2, torch.Generator().manual_seed(0))
    assert ts.observation["body_velocities"].shape == (2, 45)


@pytest.mark.slow
@pytest.mark.parametrize("name", CASES)
def test_golden_file_equals_what_jax_gives_now(name):
    gold = golden(name)
    fresh = export_tool().make_golden(name)
    assert fresh.keys() == gold.keys()
    for k in gold:
        np.testing.assert_allclose(fresh[k], gold[k], rtol=0, atol=1e-12,
                                   err_msg=k)
