"""The engine features no suite model declares, in the port against the
JAX package: ball joints and their limits, CONNECT and WELD equalities,
ball, free and site transmissions, springs on free and ball joints, and
the sensor types only such a model reads (MAGNETOMETER, TENDONPOS,
TENDONVEL, ACTUATORPOS, ACTUATORVEL, BALLQUAT, BALLANGVEL, FRAMELINACC,
FRAMEANGACC, and frame sensors on a geom).

The model is ``tests/data/torch_features.xml``; its recording
(``tests/data/torch_features_golden_f64.npz``, from ``JAX_PLATFORMS=cpu
python tools/export_torch_assets.py golden:features``) holds the JAX
package's pipeline stages at two kinds of start state (in the air, on the
floor) and one ``engine.step`` of each, with Euler and with RK4, all in
float64 on the CPU.  Every stage is held to 1e-12 of its field's largest
recorded entry, the steps to the golden gate (``rl/golden.py``).  The
``slow`` case holds the recording to a fresh JAX run of the same model
(the port's compile, carried field by field into a JAX ``Model``)."""

import numpy as np
import pytest
import torch

from _torch_helpers import ROOT, export_tool
from dm_control_torch import mjcf as tmjcf
from dm_control_torch.physics import constraints as tcons
from dm_control_torch.physics import engine as tengine
from dm_control_torch.physics import sensors as tsens
from dm_control_torch.physics.model import JointType, make_data
from dm_control_torch.rl import golden as tgolden

#: a stage agrees within this share of its field's largest recorded entry
STAGE_REL = 1e-12
KINDS = ("reset", "contact")


@pytest.fixture(scope="module")
def gold():
    with np.load(export_tool().features_golden_path()) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def model():
    return tgolden.features_model(ROOT, "euler_reset", "cpu", torch.float64)


@pytest.fixture(scope="module")
def stages(gold, model):
    """The port's stages at both kinds of start state, by kind."""
    out = {}
    for kind in KINDS:
        prefix = f"euler_{kind}"
        state = {k: gold[f"{prefix}_{k}"]
                 for k in tgolden.STATE_FIELDS + ("actions",)}
        out[kind] = export_tool().features_stage_fields(
            tengine, tsens, tcons, model, tgolden.features_data(model, state))
    return out


def _stage_names():
    return (list(tgolden.FEATURES_STAGES)
            + [f"efc_{f}" for f in ("J", "D", "R", "aref", "pos")]
            + [f"contact_{f}" for f in ("dist", "pos", "frame")]
            + [f"forward_{f}" for f in tgolden.FEATURES_FORWARD])


def test_model_declares_every_feature(model):
    """The model holds what it is there to test: a free joint, limited,
    sprung ball joints, WELD, CONNECT and JOINT equalities declared in
    another order than the port builds their types' rows in, the three
    transmissions, the nine sensor types and a frame sensor on a geom."""
    from dm_control_torch.physics.model import (
        EqType, ObjType, SensorType, TrnType)

    types = [JointType(t) for t in model.jnt_type]
    assert JointType.FREE in types and types.count(JointType.BALL) == 4
    ball = [j for j, t in enumerate(types) if t == JointType.BALL]
    assert sum(model.jnt_limited[j] for j in ball) == 2
    stiff = model.jnt_stiffness.numpy()
    assert all(stiff[j] > 0 for j in ball[:2])
    assert [EqType(t) for t in model.eq_type] == [
        EqType.WELD, EqType.CONNECT, EqType.JOINT]
    assert tcons._equality_layout(model)[1] is not None
    trn = [(TrnType(model.actuator_trntype[u]),
            types[model.actuator_trnid[u][0]]
            if model.actuator_trntype[u] == int(TrnType.JOINT) else None)
           for u in range(model.nu)]
    assert (TrnType.JOINT, JointType.BALL) in trn
    assert (TrnType.JOINT, JointType.FREE) in trn
    assert (TrnType.SITE, None) in trn
    sensors = {SensorType(t) for t in model.sensor_type}
    assert {SensorType.MAGNETOMETER, SensorType.TENDONPOS,
            SensorType.TENDONVEL, SensorType.ACTUATORPOS,
            SensorType.ACTUATORVEL, SensorType.BALLQUAT,
            SensorType.BALLANGVEL, SensorType.FRAMELINACC,
            SensorType.FRAMEANGACC} <= sensors
    assert int(ObjType.GEOM) in model.sensor_objtype
    assert model.nv == 22 and model.ntendon == 2


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", _stage_names())
def test_stage_matches_jax(stages, gold, kind, name):
    got = stages[kind][name].numpy()
    want = gold[f"euler_{kind}_stage_{name}"]
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= STAGE_REL * max(scale, 1e-300), (name, err, scale)


@pytest.mark.parametrize("kind", KINDS)
def test_constraint_rows_in_jax_order(stages, gold, model, kind):
    """Equalities (6 rows for the WELD, 3 for the CONNECT, 1 for the
    JOINT) before the limits (two ball joints, one row each, after the hinge/slide rows)
    before the contacts, as the JAX package's rows."""
    state = {k: gold[f"euler_{kind}_{k}"]
             for k in tgolden.STATE_FIELDS + ("actions",)}
    d = tgolden.features_data(model, state)
    efc = tcons.make_constraint(model, tengine.fwd_velocity(
        model, tengine.fwd_position(model, d)))
    assert efc.ne == 10 and efc.kind[:10] == (tcons.EQUALITY,) * 10
    assert efc.kind[10] == tcons.LIMIT
    assert efc.nefc == gold[f"euler_{kind}_stage_efc_J"].shape[1]


@pytest.mark.parametrize("prefix", tgolden.FEATURES_PREFIXES)
def test_step_passes_golden_gate(gold, prefix):
    m = tgolden.features_model(ROOT, prefix, "cpu", torch.float64)
    errs = tgolden.features_step_errors(m, gold, prefix)
    rest, rel = tgolden.gate_figures(errs, gold, prefix)
    print(f"\n{prefix}: gate: rest {rest:.3e}, qacc_warmstart {rel:.3e} "
          f"of its scale")
    assert rest <= tgolden.ABS_GATE and rel <= tgolden.REL_GATE, errs


@pytest.mark.slow
def test_golden_equals_fresh_jax(gold):
    fresh = export_tool().make_features_golden()
    assert sorted(fresh) == sorted(gold)
    for k, v in fresh.items():
        np.testing.assert_array_equal(np.asarray(v), gold[k], err_msg=k)


# -- each feature that used to raise -----------------------------------------

_BODY = """
<mujoco>
  <worldbody>
    <geom type="plane" size="2 2 .1"/>
    <body name="a" pos="0 0 .5">
      {root}
      <geom name="a" type="box" size=".1 .1 .1"/>
      <site name="s" pos=".05 0 .05"/>
      <site name="s0" pos="-.1 0 0"/>
      <body name="b" pos=".2 0 0">
        {joint}
        <geom name="b" type="capsule" fromto="0 0 0 .2 0 0" size=".03"/>
        <site name="s1" pos=".1 0 0"/>
      </body>
    </body>
  </worldbody>
  <tendon><spatial name="t"><site site="s0"/><site site="s1"/></spatial>
  </tendon>
  {extra}
</mujoco>"""
_FREE = '<freejoint name="root"/>'
_BALL = '<joint name="j" type="ball"/>'
_HINGE = '<joint name="j" type="hinge" axis="0 1 0"/>'
_MOTOR = "<actuator><motor name=\"u\" {target}/></actuator>"


def _case(root=_FREE, joint=_BALL, extra=""):
    return _BODY.format(root=root, joint=joint, extra=extra)


def _sensor(tag, attrs, joint=_BALL, actuator="joint=\"j\" gear=\"1\""):
    if joint != _BALL:
        actuator = "joint=\"j\""
    return _case(joint=joint, extra=_MOTOR.format(target=actuator)
                 + f"<sensor><{tag} {attrs}/></sensor>")


FEATURES = {
    "ball_joint": _case(),
    "ball_limit": _case(joint='<joint name="j" type="ball" limited="true" '
                              'range="0 30"/>'),
    "connect": _case(extra='<equality><connect body1="b" anchor=".2 0 0"/>'
                           '</equality>'),
    "weld": _case(extra='<equality><weld body1="b" body2="a"/>'
                        '</equality>'),
    "ball_transmission": _case(extra=_MOTOR.format(
        target='joint="j" gear="1 2 3"')),
    "free_transmission": _case(extra=_MOTOR.format(
        target='joint="root" gear="0 0 1 0 1 0"')),
    "site_transmission": _case(extra=_MOTOR.format(
        target='site="s" gear="1 0 0 0 0 1"')),
    "free_spring": _case(root='<joint name="root" type="free" '
                              'stiffness="3"/>'),
    "ball_spring": _case(joint='<joint name="j" type="ball" '
                               'stiffness="2"/>'),
    "magnetometer": _sensor("magnetometer", 'site="s"'),
    "tendonpos": _sensor("tendonpos", 'tendon="t"'),
    "tendonvel": _sensor("tendonvel", 'tendon="t"'),
    "actuatorpos": _sensor("actuatorpos", 'actuator="u"', joint=_HINGE),
    "actuatorvel": _sensor("actuatorvel", 'actuator="u"', joint=_HINGE),
    "ballquat": _sensor("ballquat", 'joint="j"'),
    "ballangvel": _sensor("ballangvel", 'joint="j"'),
    "framelinacc": _sensor("framelinacc", 'objtype="site" objname="s"'),
    "frameangacc": _sensor("frameangacc", 'objtype="geom" objname="b"'),
}


@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_feature_no_longer_raises(feature):
    """A model with the feature compiles, and two Euler steps of two
    environments stay finite."""
    m = tmjcf.compile_model(tmjcf.from_xml_string(FEATURES[feature]),
                            device="cpu", dtype=torch.float64)
    d = make_data(m, 2)
    d = d.replace(qvel=torch.full_like(d.qvel, 0.3),
                  ctrl=torch.full_like(d.ctrl, 0.5))
    for _ in range(2):
        d = tengine.step(m, d)
    for f in ("qpos", "qvel", "qacc_warmstart", "sensordata"):
        assert bool(torch.isfinite(getattr(d, f)).all()), (feature, f)
    if m.nsensor:
        assert bool((d.sensordata != 0).any()), feature


def test_actuatorfrc_still_raises():
    """ACTUATORFRC has no computation in the JAX package (its sensordata
    stays 0 there): the port refuses it, and says why."""
    m = tmjcf.compile_model(tmjcf.from_xml_string(_sensor(
        "actuatorfrc", 'actuator="u"', joint=_HINGE)), device="cpu",
        dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="no computation in the "
                                                  "JAX package"):
        tsens.sensor_pos(m, make_data(m, 1))


def test_joint_sensor_of_a_ball_joint_still_raises():
    m = tmjcf.compile_model(tmjcf.from_xml_string(_sensor(
        "jointpos", 'joint="j"')), device="cpu", dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="JOINTPOS of a BALL"):
        tsens.sensor_pos(m, make_data(m, 1))


# -- the randomizer's ball branch --------------------------------------------


def test_randomizer_ball_draws_equal_jax(model):
    """From one numpy RandomState, the port's draws of every joint (the
    limited and the free ball joints among them) equal the JAX package's
    numpy path's, in the same order."""
    from _torch_helpers import jax_model_from_port
    from dm_control_torch.rl.control import RandomContext
    from dm_control_torch.suite.utils import randomizers
    from dm_control_tpu.rl.control import RandomContext as JRandomContext
    from dm_control_tpu.suite.utils import randomizers as jrandomizers

    jm = jax_model_from_port(model)
    qpos0 = model.qpos0.numpy()
    for seed in (0, 5):
        got = randomizers.randomize_limited_and_rotational_joints(
            model, model.qpos0.unsqueeze(0), RandomContext.numpy(
                np.random.RandomState(seed), "cpu", torch.float64))
        want = jrandomizers.randomize_limited_and_rotational_joints(
            jm, qpos0, JRandomContext(np_random=np.random.RandomState(seed)))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def test_randomizer_ball_draws_batched(model):
    """From a generator: every environment's ball quaternions are unit,
    and a limited one turns by at most its range's upper end."""
    from dm_control_torch.rl.control import RandomContext
    from dm_control_torch.suite.utils import randomizers

    B = 64
    rc = RandomContext(torch.Generator().manual_seed(0), B, torch.float64)
    qpos = randomizers.randomize_limited_and_rotational_joints(
        model, model.qpos0.expand(B, model.nq), rc)
    for j in range(model.njnt):
        if model.jnt_type[j] != int(JointType.BALL):
            continue
        a = model.jnt_qposadr[j]
        q = qpos[:, a:a + 4]
        torch.testing.assert_close(q.norm(dim=-1), torch.ones(
            B, dtype=torch.float64), rtol=0, atol=1e-12)
        if model.jnt_limited[j]:
            angle = 2 * torch.acos(q[:, 0].clamp(-1, 1))
            assert bool((angle <= model.jnt_range[j, 1] + 1e-12).all())
            assert len(set(q[:, 0].tolist())) == B
