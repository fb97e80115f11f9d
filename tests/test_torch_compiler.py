"""The port's MJCF compiler against the JAX package's.

- ``_Compiler(root).compile()`` against the JAX package's
  ``_Compiler(root, jnp.float64).compile()`` on small MJCF snippets: every
  leaf of the Model equal, bit for bit;
- ``engine.set_const`` against the JAX package's on two small models:
  every field it writes within 1e-10 of the field's largest entry;
- every checked-in reference model (``suite/assets/*.npz``, the JAX
  compiler's output) against the port's compile of the same variant: the
  fields the compiler writes equal, the ``set_const`` fields within 1e-10
  of each field's largest entry (the figures ``chip_smoke.py`` phase 11
  holds on the card);
- suite options no reference file holds (four poles, eight links) stepped
  against the JAX package's environments of them.
"""

import numpy as np
import pytest
import torch

import dm_control_torch.mjcf as tmjcf
import dm_control_torch.suite as tsuite
import dm_control_tpu.mjcf as jmjcf
from _torch_helpers import assert_step_matches_golden, export_tool
from dm_control_torch.mjcf import compiler as tcompiler
from dm_control_torch.physics import model_io
from dm_control_torch.suite import base as tbase
from test_torch_model_io import _assert_same, _fields

SET_CONST_FIELDS = model_io.SET_CONST_FIELDS
#: ``set_const`` fields: largest deviation over the field's largest entry
SET_CONST_REL = 1e-10

_ORIENTATIONS = """
<mujoco model="orientations">
  <worldbody>
    <body name="e" pos="0 0 1" euler="10 20 30">
      <freejoint name="free1"/>
      <geom name="e" type="box" size=".1 .2 .3" euler="0 90 0"/>
      <body name="aa" pos=".1 0 0" axisangle="1 1 0 60">
        <joint name="aa" axis="1 2 3"/>
        <geom name="aa" type="ellipsoid" size=".1 .05 .02"
              axisangle="0 0 1 45"/>
      </body>
      <body name="xy" pos="0 .1 0" xyaxes="0 1 0 -1 0 .5">
        <joint name="xy" type="slide" axis="0 1 1"/>
        <geom name="xy" type="cylinder" size=".05 .1" zaxis="1 1 1"/>
        <site name="xy" pos=".1 .2 .3" quat="1 2 3 4"/>
      </body>
      <body name="z" pos="0 0 -.1" zaxis="0 -1 0">
        <joint name="z" range="-45 45" limited="true" ref="10"
               springref="5"/>
        <geom name="z" type="sphere" size=".05"/>
      </body>
    </body>
  </worldbody>
</mujoco>
"""

_RADIANS = """
<mujoco model="radians">
  <compiler angle="radian" eulerseq="XYZ" autolimits="true"/>
  <option timestep="0.005" integrator="implicitfast" cone="elliptic"
          gravity="0 0 -5" wind="1 0 0" density="1.2" viscosity="0.01"
          noslip_iterations="3" iterations="20" tolerance="1e-9">
    <flag warmstart="disable" filterparent="disable"/>
  </option>
  <worldbody>
    <body name="r" pos="0 0 1" euler=".1 .2 .3">
      <joint name="r" range="-.5 .5" margin=".01" stiffness="2"
             damping=".3" armature=".02" frictionloss=".1"
             solreflimit=".03 1.1" solimplimit=".8 .9 .002"/>
      <geom name="r" type="capsule" size=".05 .2" euler=".3 .2 .1"
            friction=".5" condim="4" solref=".01 .5" priority="1"
            margin=".002" gap=".001" contype="2" conaffinity="3"/>
    </body>
  </worldbody>
</mujoco>
"""

_FROMTO = """
<mujoco model="fromto">
  <worldbody>
    <body name="a" pos="0 0 1">
      <freejoint name="free2"/>
      <geom name="cap" type="capsule" fromto="0 0 0 .3 .1 -.2" size=".03"/>
      <geom name="cyl" type="cylinder" fromto="0 0 0 0 0 .2" size=".02"/>
      <geom name="box" type="box" fromto="0 0 0 0 .2 0" size=".02 .03"/>
      <geom name="ell" type="ellipsoid" fromto="0 0 0 -.1 0 0"
            size=".02 .01"/>
      <geom name="down" type="capsule" fromto="0 0 .1 0 0 -.1"
            size=".01"/>
      <site name="s" type="capsule" fromto="0 0 0 .1 .1 .1" size=".01"/>
    </body>
  </worldbody>
</mujoco>
"""

_MESHES = """
<mujoco model="meshes">
  <asset>
    <mesh name="tet" vertex="0 0 0  1 0 0  0 1 0  0 0 1  .2 .2 .2"/>
    <mesh name="stl" file="part.stl" scale="2 1 .5"/>
  </asset>
  <worldbody>
    <body name="m" pos="0 0 1">
      <freejoint name="free3"/>
      <geom name="tet" type="mesh" mesh="tet" pos=".1 0 0" euler="0 0 30"/>
      <geom name="stl" type="mesh" mesh="stl" density="300"/>
    </body>
  </worldbody>
</mujoco>
"""

_HFIELD = """
<mujoco model="hfield">
  <asset>
    <hfield name="terrain" nrow="5" ncol="7" size="2 3 .5 .1"/>
  </asset>
  <worldbody>
    <geom name="terrain" type="hfield" hfield="terrain" pos="0 0 -.1"/>
    <body name="ball" pos="0 0 1">
      <freejoint name="free4"/>
      <geom name="ball" type="sphere" size=".1"/>
    </body>
  </worldbody>
</mujoco>
"""

_TENDONS = """
<mujoco model="tendons">
  <default>
    <tendon stiffness="3"/>
  </default>
  <worldbody>
    <body name="a" pos="0 0 1">
      <joint name="ja" axis="0 1 0" springdamper="0.2 1"/>
      <geom name="ga" type="capsule" fromto="0 0 0 .2 0 0" size=".03"/>
      <site name="sa" pos=".1 0 .05"/>
      <body name="b" pos=".2 0 0">
        <joint name="jb" axis="0 1 0"/>
        <geom name="gb" type="capsule" fromto="0 0 0 .2 0 0" size=".03"/>
        <site name="sb" pos=".1 0 .05"/>
      </body>
    </body>
  </worldbody>
  <tendon>
    <fixed name="coupled" range="-1 1" limited="true" springlength=".1">
      <joint joint="ja" coef="1"/>
      <joint joint="jb" coef="-1"/>
    </fixed>
    <spatial name="rope" damping=".5">
      <site site="sa"/>
      <site site="sb"/>
    </spatial>
  </tendon>
  <equality>
    <joint name="eqj" joint1="ja" joint2="jb" polycoef="0 .5 0 0 0"/>
    <tendon name="eqt" tendon1="coupled" solref=".05 1"/>
  </equality>
  <actuator>
    <general name="g" tendon="rope" dyntype="filter" dynprm=".1"
             gaintype="affine" gainprm="2 1" biastype="affine"
             biasprm="0 -1 -.1" ctrlrange="-1 1" ctrllimited="true"/>
    <position name="p" joint="ja" kp="5" kv=".5"/>
    <velocity name="v" joint="jb" kv="2" forcerange="-3 3"
              forcelimited="true"/>
  </actuator>
  <sensor>
    <jointpos name="qa" joint="ja"/>
    <tendonpos name="tp" tendon="rope"/>
    <actuatorfrc name="af" actuator="p"/>
    <framepos name="fb" objtype="body" objname="b"/>
    <framequat name="fq" objtype="site" objname="sb"/>
    <subtreecom name="sc" body="a"/>
    <touch name="t" site="sb" cutoff="5"/>
  </sensor>
</mujoco>
"""

_EQUALITIES = """
<mujoco model="equalities">
  <worldbody>
    <body name="a" pos="0 0 1" euler="0 30 0">
      <freejoint name="free5"/>
      <geom name="a" type="box" size=".1 .1 .1"/>
    </body>
    <body name="b" pos=".5 0 1">
      <freejoint name="free6"/>
      <geom name="b" type="sphere" size=".1"/>
    </body>
  </worldbody>
  <equality>
    <connect name="c" body1="a" body2="b" anchor=".2 0 0"/>
    <weld name="w" body1="b" relpose="0 0 .1 1 0 0 0" active="false"/>
    <weld name="w0" body1="a"/>
  </equality>
  <contact>
    <exclude body1="a" body2="b"/>
  </contact>
</mujoco>
"""

_CLASSES = """
<mujoco model="classes">
  <compiler settotalmass="7" boundmass=".01" boundinertia=".001"/>
  <statistic meansize=".2" extent="3" center="0 0 1"/>
  <default>
    <geom density="800" rgba=".5 .5 .5 1"/>
    <default class="limb">
      <joint damping="1" range="-60 60" limited="true"/>
      <geom type="capsule" size=".04" condim="1"/>
    </default>
  </default>
  <worldbody>
    <camera name="side" pos="0 -3 1" xyaxes="1 0 0 0 0 1"/>
    <body name="torso" pos="0 0 1" childclass="limb">
      <freejoint name="root"/>
      <inertial pos="0 0 .05" mass="2" fullinertia=".1 .2 .3 .01 .02 .03"/>
      <camera name="track" mode="trackcom" pos="0 -2 0"/>
      <body name="arm" pos=".1 0 0">
        <joint name="shoulder" axis="0 1 0"/>
        <geom name="arm" fromto="0 0 0 .3 0 0"/>
        <body name="hand" pos=".3 0 0">
          <joint name="wrist" axis="1 0 0"/>
          <joint name="wrist2" type="slide" axis="0 0 1" range="-.1 .1"/>
          <geom name="hand" type="sphere" size=".05"/>
        </body>
      </body>
      <body name="empty" pos="0 .1 0">
        <joint name="free_hinge" axis="0 0 1" limited="false"/>
      </body>
    </body>
    <body name="target" mocap="true" pos="1 1 1">
      <geom name="target" type="sphere" size=".05" contype="0"
            conaffinity="0"/>
    </body>
    <camera name="look" mode="targetbody" target="torso" pos="2 2 2"/>
  </worldbody>
</mujoco>
"""


def _attached(m):
    """An arm with a hand attached at a site under the namescope
    ``hand/``: prefixed names and references, merged sections."""
    arm = m.Element("mujoco", {"model": "arm"})
    base = arm.add("worldbody").add("body", name="base", pos="0 0 .1")
    base.add("joint", name="shoulder", axis="0 0 1")
    base.add("geom", name="base", type="capsule", fromto="0 0 0 0 0 .2",
             size=".03")
    base.add("site", name="wrist", pos="0 0 .2", euler="0 90 0")
    arm.add("actuator").add("motor", name="shoulder", joint="shoulder")
    hand = m.Element("mujoco", {"model": "hand"})
    hand.add("compiler", angle="radian")
    palm = hand.add("worldbody").add("body", name="palm")
    palm.add("joint", name="knuckle", axis="1 0 0", range="-1 1",
             limited="true")
    palm.add("geom", name="palm", type="box", size=".02 .02 .02")
    palm.add("site", name="tip", pos="0 0 .05")
    hand.add("actuator").add("motor", name="knuckle", joint="knuckle")
    hand.add("sensor").add("touch", name="touch", site="tip")
    tendon = hand.add("tendon").add("fixed", name="t")
    tendon.add("joint", joint="knuckle", coef="2")
    arm.find("site", "wrist").attach(hand)
    return arm


SNIPPETS = {"orientations": _ORIENTATIONS, "radians": _RADIANS,
            "fromto": _FROMTO, "meshes": _MESHES, "hfield": _HFIELD,
            "tendons": _TENDONS, "equalities": _EQUALITIES,
            "classes": _CLASSES, "attached": _attached}


def _roots(name):
    from test_torch_mjcf import ASSET_FILES

    spec = SNIPPETS[name]
    if callable(spec):
        return spec(tmjcf), spec(jmjcf)
    return (tmjcf.from_xml_string(spec, assets=ASSET_FILES),
            jmjcf.from_xml_string(spec, assets=ASSET_FILES))


@pytest.mark.parametrize("name", SNIPPETS)
def test_compiler_matches_jax_bit_for_bit(name):
    """Every leaf of ``_Compiler.compile()`` (before ``set_const``) equals
    the JAX compiler's."""
    import jax.numpy as jnp

    from dm_control_tpu.mjcf import compiler as jcompiler

    troot, jroot = _roots(name)
    tm = tcompiler._Compiler(troot).compile()
    jm = jcompiler._Compiler(jroot, jnp.float64).compile()
    _assert_same(tm, model_io.from_jax_model(jm))


def test_compiled_models_step_on_the_port():
    """Each snippet's compiled model that the port's engine serves takes a
    step with finite numbers (CONNECT/WELD equalities, the hfield terrain
    and the tendon snippet's TENDONPOS and ACTUATORFRC sensors wait for
    the composer's models, ROADMAP A5)."""
    from dm_control_torch.physics import engine
    from dm_control_torch.physics.model import make_data

    for name in ("orientations", "radians", "fromto", "meshes", "classes",
                 "attached"):
        m = tmjcf.compile_model(_roots(name)[0], device="cpu")
        d = engine.step(m, make_data(m, 2))
        assert bool(torch.isfinite(d.qpos).all()), name


def _assert_compile_close(t, ref):
    """The compiler's fields equal, the ``set_const`` fields within
    ``SET_CONST_REL`` of the field's largest entry (static fields, shapes
    and dtypes equal: ``model_io.deviations``)."""
    devs = model_io.deviations(t, ref)
    for k, rel in devs.items():
        assert rel <= (SET_CONST_REL if k in SET_CONST_FIELDS else 0), (
            k, rel)


@pytest.mark.parametrize("name", ["cartpole", "tendons"])
def test_set_const_matches_jax(name):
    """``engine.set_const`` against the JAX package's on cartpole and on a
    model with springdamper, tendons and cameras."""
    import jax.numpy as jnp

    from dm_control_torch.physics import engine as tengine
    from dm_control_torch.suite._modelgen import to_element as tto_element
    from dm_control_torch.suite.models.cartpole import MODEL as TMODEL
    from dm_control_tpu.mjcf import compiler as jcompiler
    from dm_control_tpu.physics import engine as jengine
    from dm_control_tpu.suite._modelgen import to_element as jto_element
    from dm_control_tpu.suite.models.cartpole import MODEL as JMODEL

    if name == "cartpole":
        troot, jroot = tto_element(TMODEL), jto_element(JMODEL)
    else:
        troot, jroot = _roots(name)
    before = tcompiler._Compiler(troot).compile()
    t = tengine.set_const(before)
    j = model_io.from_jax_model(jengine.set_const(
        jcompiler._Compiler(jroot, jnp.float64).compile()))
    _assert_compile_close(t, j)
    if name == "tendons":  # springdamper rewrote the hinge's constants
        assert float(t.jnt_stiffness[0]) != float(before.jnt_stiffness[0])
        assert t.tendon_lengthspring[1, 0] == t.tendon_length0[1]


def _variants():
    """reference file -> the Variant of a task that compiles it (lqr's
    files are its seed 0)."""
    out = {}
    for domain in tsuite.DOMAINS.values():
        for task in domain.TASKS:
            kwargs = {"random": 0} if domain is tsuite.DOMAINS["lqr"] else {}
            variant, _ = domain.TASKS[task](**kwargs)
            out.setdefault(variant.name, variant)
    return out


_REFERENCES = tuple(a for assets in export_tool().ASSETS.values()
                    for a in assets)


@pytest.mark.parametrize("asset", _REFERENCES)
def test_compile_equals_the_reference_file(asset):
    """The suite's compile of a variant against the JAX compiler's output
    saved in ``suite/assets/``: the compiler's fields equal, the
    ``set_const`` fields within 1e-10 of the field's largest entry."""
    t = _variants()[asset].get_model("cpu", torch.float64)
    _assert_compile_close(t, tbase.load_model(asset, "cpu", torch.float64))


def test_float32_is_the_float64_compile_cast():
    root = tmjcf.from_xml_string(_TENDONS)
    m64 = tmjcf.compile_model(root, device="cpu")
    m32 = tmjcf.compile_model(tmjcf.from_xml_string(_TENDONS), device="cpu",
                              dtype=torch.float32)
    f64, f32 = _fields(m64), _fields(m32)
    for k, v in f64.items():
        if isinstance(v, torch.Tensor):
            assert f32[k].dtype == torch.float32, k
            assert torch.equal(f32[k], v.to(torch.float32)), k
        else:
            assert f32[k] == v, k
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmjcf.compile_model(root)


def test_domain_models_are_copies():
    """Every load gets a model of its own: a write into one does not reach
    the next."""
    a = tsuite.DOMAINS["pendulum"].get_model("cpu")
    a.body_mass.mul_(2)
    b = tsuite.DOMAINS["pendulum"].get_model("cpu")
    assert not torch.equal(a.body_mass, b.body_mass)


def test_model_literals_equal_the_jax_packages():
    import importlib

    for name in tsuite.DOMAINS:
        t = importlib.import_module(f"dm_control_torch.suite.models.{name}")
        j = importlib.import_module(f"dm_control_tpu.suite.models.{name}")
        assert t.MODEL == j.MODEL, name


_NEW_OPTIONS = {
    "cartpole_4": ("cartpole", "three_poles", {"num_poles": 4}),
    "swimmer8": ("swimmer", None, {"n_links": 8}),
}


def _live_golden(jenv, model, seed):
    """A golden-format recording of one JAX control step from states made
    from a numpy seed (qpos0 plus noise, random velocities and
    actions)."""
    import jax.numpy as jnp

    from dm_control_tpu.physics.model import make_data
    from dm_control_tpu.rl.control import EnvState

    rng = np.random.default_rng(seed)
    B = 3
    qpos0 = np.asarray(model.qpos0)
    gold = {"live_qpos": qpos0 + 0.3 * rng.standard_normal((B, model.nq)),
            "live_qvel": rng.standard_normal((B, model.nv)),
            "live_qacc_warmstart": np.zeros((B, model.nv)),
            "live_time": np.zeros(B),
            "live_actions": rng.uniform(-1, 1, (B, model.nu))}
    data = jenv._strip(make_data(model).replace(
        **{f: jnp.asarray(gold[f"live_{f}"])
           for f in ("qpos", "qvel", "qacc_warmstart", "time")}))
    state = EnvState(data=data, model_diff={}, rng=None,
                     step_count=jnp.zeros(B, jnp.int32),
                     needs_reset=jnp.zeros(B, bool))
    state, ts = jenv.step(state, jnp.asarray(gold["live_actions"]))
    gold.update({"live_reward": np.asarray(ts.reward),
                 "live_discount": np.asarray(ts.discount),
                 "live_step_type": np.asarray(ts.step_type)})
    gold.update({f"live_step_{f}": np.asarray(getattr(state.data, f))
                 for f in ("qpos", "qvel", "qacc_warmstart", "time")})
    gold.update({f"live_obs_{k}": np.asarray(v)
                 for k, v in ts.observation.items()})
    return gold


@pytest.mark.parametrize("name", _NEW_OPTIONS)
def test_new_suite_options_step_as_jax(name):
    """Models no reference file holds: the port's compile steps as the JAX
    package's environment from the same float64 states (one control step,
    the golden gate).  Swimmer's target is not drawn: it stays at the
    model's ``geom_pos``."""
    import importlib

    from dm_control_torch.rl.batch_env import BatchEnv
    from dm_control_tpu import suite as jsuite
    from dm_control_tpu.rl.batch_env import BatchEnv as JBatchEnv

    domain, task, kwargs = _NEW_OPTIONS[name]
    tdomain = tsuite.DOMAINS[domain]
    if task is None:  # swimmer(n_links): no registered task, in both
        variant, ttask = tdomain.swimmer(**kwargs)
        jmod = importlib.import_module(f"dm_control_tpu.suite.{domain}")
        jsingle = jmod.swimmer(**kwargs)
        jenv = JBatchEnv(jsingle._model, jsingle._task,
                         time_limit=jsingle._time_limit,
                         control_timestep=jsingle._control_timestep,
                         autoreset=False)
    else:
        variant, ttask = tdomain.TASKS[task](**kwargs)
        jenv = jsuite.load_batch(domain, task, task_kwargs=kwargs,
                                 autoreset=False)
    assert variant.name == name
    tenv = BatchEnv(variant.get_model("cpu", torch.float64), ttask,
                    time_limit=tdomain.TIME_LIMIT,
                    control_timestep=tdomain.CONTROL_TIMESTEP,
                    autoreset=False)
    assert tenv.n_sub_steps == jenv.n_sub_steps
    _assert_compile_close(tenv.model, model_io.from_jax_model(jenv.model))
    gold = _live_golden(jenv, jenv.model, seed=11)
    assert_step_matches_golden(tenv, gold, "live")
