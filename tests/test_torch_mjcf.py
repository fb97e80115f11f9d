"""The port's MJCF element layer against the JAX package's: the parser
(ElementTree in the port, lxml in the JAX package) gives the same tree,
tag for tag and attribute for attribute; the schema rejects what the JAX
schema rejects with the same message head; attachment, unit conversion,
defaults, copying and the XML helpers give the same trees; ``bind`` reads
and writes the same values."""

import numpy as np
import pytest
import torch

import dm_control_torch.mjcf as tmjcf
import dm_control_tpu.mjcf as jmjcf

_PENDULUM = """
<mujoco model="pendulum">
  <option timestep="0.02" integrator="RK4">
    <flag contact="disable" energy="enable"/>
  </option>
  <worldbody>
    <light name="light" pos="0 0 6"/>
    <geom name="floor" size="2 2 .2" type="plane"/>
    <body name="pole" pos="0 0 .6">
      <joint name="hinge" type="hinge" axis="0 1 0" damping="0.1"/>
      <geom name="base" type="cylinder" fromto="0 -.03 0 0 .03 0"
            size="0.021" mass="0"/>
      <geom name="pole" type="capsule" fromto="0 0 0 0 0 -.5" size="0.02"/>
    </body>
  </worldbody>
  <actuator>
    <motor name="torque" joint="hinge" gear="1" ctrllimited="true"
           ctrlrange="-1 1"/>
  </actuator>
</mujoco>
"""

_DEFAULTS = """
<mujoco model="classes">
  <compiler angle="degree"/>
  <default>
    <joint damping=".5" armature="0.01"/>
    <geom friction=".7" rgba="1 0 0 1"/>
    <default class="leg">
      <joint range="-30 30" limited="true"/>
      <geom type="capsule" size=".04"/>
      <default class="foot">
        <geom size=".06"/>
      </default>
    </default>
  </default>
  <worldbody>
    <body name="torso" childclass="leg" pos="0 0 1">
      <freejoint name="root"/>
      <joint name="hip" axis="0 1 0"/>
      <geom name="thigh" fromto="0 0 0 0 0 -.3"/>
      <body name="shin" pos="0 0 -.3">
        <joint name="knee" class="leg" axis="0 1 0" range="-90 0"/>
        <geom name="foot" class="foot" fromto="0 0 0 .1 0 0"/>
      </body>
    </body>
  </worldbody>
</mujoco>
"""

_COMMENTS = """<?xml version="1.0" encoding="utf-8"?>
<!-- a comment before the root -->
<mujoco model="commented">
  <?processing instruction?>
  <!-- a comment among the sections -->
  <worldbody>
    <!-- a comment in the body tree -->
    <body name="b" pos="0 0 1">
      <joint name="j" type="slide" axis="0 0 1"/>
      <!-- and one beside a geom -->
      <geom name="g" type="box" size=".1 .2 .3"/>
    </body>
  </worldbody>
</mujoco>
"""

_INCLUDING = """
<mujoco model="includes">
  <include file="common.xml"/>
  <worldbody>
    <geom name="floor" type="plane" size="1 1 .1"/>
    <include file="arm.xml"/>
  </worldbody>
  <actuator>
    <motor name="m0" joint="shoulder"/>
  </actuator>
</mujoco>
"""
_INCLUDED = {
    "common.xml": b"""<mujoco>
  <option timestep="0.005"/>
  <default><geom density="500"/></default>
  <worldbody><light name="top" pos="0 0 3"/></worldbody>
  <actuator><motor name="m1" joint="elbow"/></actuator>
</mujoco>""",
    "arm.xml": b"""<mujoco>
  <body name="upper" pos="0 0 .5">
    <joint name="shoulder" axis="0 1 0"/>
    <geom name="upper" type="capsule" fromto="0 0 0 .3 0 0" size=".02"/>
    <body name="lower" pos=".3 0 0">
      <joint name="elbow" axis="0 1 0"/>
      <geom name="lower" type="capsule" fromto="0 0 0 .3 0 0" size=".02"/>
    </body>
  </body>
</mujoco>""",
}

_TENDONS = """
<mujoco model="tendons">
  <worldbody>
    <body name="a" pos="0 0 1">
      <joint name="ja" type="hinge" axis="0 1 0" springdamper="0.2 1"/>
      <geom name="ga" type="sphere" size=".05"/>
      <site name="sa" pos=".1 0 0"/>
      <body name="b" pos=".2 0 0">
        <joint name="jb" type="hinge" axis="0 1 0"/>
        <geom name="gb" type="sphere" size=".05"/>
        <site name="sb" pos=".1 0 0"/>
      </body>
    </body>
  </worldbody>
  <tendon>
    <fixed name="coupled" range="-1 1" limited="true">
      <joint joint="ja" coef="1"/>
      <joint joint="jb" coef="-1"/>
    </fixed>
    <spatial name="rope" width=".01">
      <site site="sa"/>
      <site site="sb"/>
    </spatial>
  </tendon>
  <equality>
    <joint joint1="ja" joint2="jb" polycoef="0 1 0 0 0"/>
  </equality>
  <sensor>
    <jointpos name="qa" joint="ja"/>
    <framepos name="fb" objtype="body" objname="b"/>
    <touch name="t" site="sb"/>
  </sensor>
</mujoco>
"""

_ASSETS = """
<mujoco model="assets">
  <asset>
    <texture name="grid" type="2d" builtin="checker" width="8" height="8"/>
    <material name="grid" texture="grid"/>
    <mesh name="tet" vertex="0 0 0  1 0 0  0 1 0  0 0 1"/>
    <mesh name="stl" file="part.stl" scale="2 2 2"/>
    <hfield name="terrain" nrow="3" ncol="4" size="1 1 .2 .1"/>
  </asset>
  <worldbody>
    <geom name="ground" type="hfield" hfield="terrain"/>
    <body name="m" pos="0 0 1">
      <freejoint/>
      <geom name="tet" type="mesh" mesh="tet" material="grid"/>
    </body>
  </worldbody>
</mujoco>
"""

_MISC = """
<mujoco model="misc">
  <visual><global offwidth="64"/></visual>
  <statistic extent="2" center="0 0 .5"/>
  <size njmax="10" nconmax="5"/>
  <custom>
    <numeric name="n" data="1 2 3"/><text name="t" data="hello"/>
  </custom>
  <worldbody>
    <camera name="fixed" pos="0 -2 1" xyaxes="1 0 0 0 .5 1"/>
    <body name="c" pos="0 0 .5" euler="10 20 30">
      <camera name="track" mode="trackcom" pos="0 -1 0" zaxis="0 -1 0"/>
      <joint name="s" type="slide" axis="1 0 0"/>
      <geom name="e" type="ellipsoid" size=".1 .2 .3"
            axisangle="0 0 1 45"/>
    </body>
  </worldbody>
  <keyframe><key name="k" qpos="0.1"/></keyframe>
</mujoco>
"""

XMLS = {"pendulum": _PENDULUM, "defaults": _DEFAULTS,
        "comments": _COMMENTS, "includes": _INCLUDING,
        "tendons": _TENDONS, "assets": _ASSETS, "misc": _MISC,
        "bytes": _PENDULUM.encode()}


def _stl_bytes():
    """A binary STL of a unit tetrahedron (4 outward triangles)."""
    import struct

    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    faces = [(0, 2, 1), (0, 1, 3), (0, 3, 2), (1, 2, 3)]
    out = bytearray(b"\0" * 80) + struct.pack("<I", len(faces))
    for f in faces:
        out += struct.pack("<3f", 0, 0, 0)
        for i in f:
            out += struct.pack("<3f", *v[i])
        out += b"\0\0"
    return bytes(out)


ASSET_FILES = dict(_INCLUDED, **{"part.stl": _stl_bytes()})


def tree(e):
    """(tag, attributes, payload, children) of an element of either
    package, recursively; checks every parent link on the way."""
    for c in e.children:
        assert c.parent is e, (c.tag, e.tag)
    return (e.tag, dict(e.attrib), getattr(e, "payload", None),
            [tree(c) for c in e.children])


@pytest.mark.parametrize("name", XMLS)
def test_parser_gives_the_jax_tree(name):
    t = tmjcf.from_xml_string(XMLS[name], assets=ASSET_FILES)
    j = jmjcf.from_xml_string(XMLS[name], assets=ASSET_FILES)
    assert tree(t) == tree(j)
    assert t.to_xml_string() == j.to_xml_string()


def test_from_path_resolves_includes_and_payloads_on_disk(tmp_path):
    for fname, data in ASSET_FILES.items():
        (tmp_path / fname).write_bytes(data)
    for name in ("includes", "assets"):
        path = tmp_path / f"{name}.xml"
        path.write_text(XMLS[name])
        t, j = tmjcf.from_path(str(path)), jmjcf.from_path(str(path))
        assert tree(t) == tree(j)
    assert t.find("mesh", "stl").payload == ASSET_FILES["part.stl"]
    with pytest.raises(IOError, match="missing.xml"):
        tmjcf.from_xml_string('<mujoco><include file="missing.xml"/>'
                              '</mujoco>')


def test_element_api_matches_jax():
    t = tmjcf.from_xml_string(_DEFAULTS)
    j = jmjcf.from_xml_string(_DEFAULTS)
    for e in (t, j):
        e.first("worldbody").add("site", name="s", pos="1 2 3")
    assert [x.path for x in t.iter()] == [x.path for x in j.iter()]
    assert ([x.name for x in t.find_all("geom")]
            == [x.name for x in j.find_all("geom")])
    assert t.find("body", "shin").get("pos") == "0 0 -.3"
    assert t.first("default").first("default").get("class") == "leg"
    site = t.find("site", "s")
    site.parent.remove(site)
    assert site.parent is None and t.find("site", "s") is None
    assert repr(t.find("joint", "knee")) == repr(j.find("joint", "knee"))


_SCHEMA_CASES = {
    "typo attribute": lambda m: m.Element("mujoco").add("worldbody").add(
        "geom", type="sphere", sixe="0.1").parent.parent,
    "typo tag": lambda m: m.Element("mujoco").add("worldbody").add(
        "boyd", pos="0 0 1").parent.parent,
    "misplaced child": lambda m: m.Element("mujoco").add("worldbody").add(
        "motor", joint="j").parent.parent,
    "unknown section": lambda m: m.Element("mujoco").add(
        "actuators").parent,
}


@pytest.mark.parametrize("case", _SCHEMA_CASES)
def test_schema_rejects_what_jax_rejects(case):
    from dm_control_torch.mjcf import schema as tschema
    from dm_control_tpu.mjcf import schema as jschema

    t, j = _SCHEMA_CASES[case](tmjcf), _SCHEMA_CASES[case](jmjcf)
    assert tschema.validate(t) == jschema.validate(j) != []
    with pytest.raises(tschema.MJCFSchemaError) as te:
        tschema.validate_or_raise(t)
    with pytest.raises(jschema.MJCFSchemaError) as je:
        jschema.validate_or_raise(j)
    assert str(te.value).splitlines()[:2] == str(je.value).splitlines()[:2]
    with pytest.raises(tschema.MJCFSchemaError):
        tmjcf.compile_model(t, device="cpu")


def test_attribute_values_fail_as_in_jax():
    from dm_control_torch.mjcf.attribute import MJCFAttributeError as TErr
    from dm_control_tpu.mjcf.attribute import MJCFAttributeError as JErr

    writes = [lambda b: b.add("joint", damping="soft"),
              lambda b: b.add("geom", size="0.1", mass="1 2 3"),
              lambda b: b.attrib.__setitem__("pos", "1 2"),
              lambda b: b.add("joint", type="screw"),
              lambda b: b.add("geom", condim="3.5")]
    for write in writes:
        msgs = []
        for m, err in ((tmjcf, TErr), (jmjcf, JErr)):
            body = m.Element("mujoco").add("worldbody").add("body", name="b")
            with pytest.raises(err) as e:
                write(body)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def _arm(m):
    root = m.Element("mujoco", {"model": "arm"})
    root.add("compiler", angle="degree")
    base = root.add("worldbody").add("body", name="base", pos="0 0 .1")
    base.add("joint", name="shoulder", type="hinge", axis="0 0 1",
             range="-90 90", limited="true")
    base.add("geom", name="base_geom", type="capsule",
             fromto="0 0 0 0 0 .2", size=".03")
    base.add("site", name="wrist", pos="0 0 0.2", euler="0 0 90")
    root.add("actuator").add("motor", name="shoulder_motor",
                             joint="shoulder")
    return root


def _hand(m):
    root = m.Element("mujoco", {"model": "hand"})
    root.add("compiler", angle="radian")
    palm = root.add("worldbody").add("body", name="palm")
    palm.add("geom", name="palm_geom", type="box", size=".02 .02 .02")
    palm.add("joint", name="knuckle", type="hinge", axis="1 0 0",
             range="-1 1", limited="true")
    root.add("actuator").add("motor", name="knuckle_motor", joint="knuckle")
    root.add("sensor").add("jointpos", name="knuckle_pos", joint="knuckle")
    return root


def test_attachment_matches_jax():
    trees = []
    for m in (tmjcf, jmjcf):
        arm = _arm(m)
        frame = arm.find("site", "wrist").attach(_hand(m))
        root_frame = arm.attach(_hand(m), prefix="h2/")
        with pytest.raises(ValueError, match="duplicate names"):
            arm.attach(_hand(m), prefix="h2/")
        trees.append((tree(arm), frame.name, root_frame.name))
        root_frame.detach()
        trees.append(tree(arm))
    assert trees[0] == trees[2] and trees[1] == trees[3]
    arm = _arm(tmjcf)
    arm.find("site", "wrist").attach(_hand(tmjcf))
    m = tmjcf.compile_model(arm, device="cpu")
    assert m.names.actuator == {"shoulder_motor": 0, "hand/knuckle_motor": 1}
    assert m.names.sensor == {"hand/knuckle_pos": 0}


def test_units_defaults_copier_and_xml_tools_match_jax():
    from dm_control_torch.mjcf import copier as tcopier
    from dm_control_torch.mjcf import traversal_utils as ttrav
    from dm_control_torch.mjcf import units as tunits
    from dm_control_torch.utils import io as tio
    from dm_control_torch.utils import xml_tools as txml
    from dm_control_tpu.mjcf import copier as jcopier
    from dm_control_tpu.mjcf import traversal_utils as jtrav
    from dm_control_tpu.mjcf import units as junits
    from dm_control_tpu.utils import xml_tools as jxml

    t, j = tmjcf.from_xml_string(_DEFAULTS), jmjcf.from_xml_string(_DEFAULTS)
    tunits.to_radians(t)
    junits.to_radians(j)
    assert tree(t) == tree(j)
    for root, trav in ((t, ttrav), (j, jtrav)):
        trav.commit_defaults(root.find("joint", "knee"))
    assert tree(t) == tree(j)
    copies = []
    for root, m, cp in ((t, tmjcf, tcopier), (j, jmjcf, jcopier)):
        target = m.Element("mujoco").add("worldbody")
        copies.append(tree(cp.copy_element(root.find("body", "shin"),
                                           target).parent))
    assert copies[0] == copies[1]
    link = tmjcf.Element("body", {"name": "link", "pos": "0 0 .1"})
    jlink = jmjcf.Element("body", {"name": "link", "pos": "0 0 .1"})
    assert tree(txml.nested_element(link, 3)) == tree(
        jxml.nested_element(jlink, 3))
    assert tree(txml.parse(_PENDULUM)) == tree(jxml.parse(_PENDULUM))
    assert txml.find_element(t, "geom", "thigh").get("fromto") is not None
    with pytest.raises(ValueError, match="not found"):
        txml.find_element(t, "geom", "wing")
    assert tio.GetResourceFilename("x.xml") == "x.xml"


def _bind_model(m):
    root = m.Element("mujoco")
    root.add("option", timestep="0.002")
    wb = root.add("worldbody")
    wb.add("geom", name="floor", type="plane", size="2 2 .1")
    b = wb.add("body", name="ball", pos="0 0 1")
    b.add("joint", name="ball_x", type="slide", axis="1 0 0")
    b.add("joint", name="ball_z", type="slide", axis="0 0 1")
    g = b.add("geom", name="ball_geom", type="sphere", size="0.1")
    b.add("site", name="tip", pos="0 0 0.1")
    act = root.add("actuator")
    act.add("motor", name="push", joint="ball_x", gear="1")
    root.add("sensor").add("jointpos", name="zpos", joint="ball_z")
    return root, b, g


def test_bind_reads_and_writes_as_jax():
    from dm_control_torch.physics.physics import Physics as TPhysics
    from dm_control_tpu.physics.physics import Physics as JPhysics

    out = []
    for m, physics_cls, kw in ((tmjcf, TPhysics, {"device": "cpu"}),
                               (jmjcf, JPhysics, {})):
        root, body, geom = _bind_model(m)
        p = physics_cls.from_mjcf_model(root, **kw)
        p.forward()
        joints = [root.find("joint", "ball_x"), root.find("joint", "ball_z")]
        reads = [p.bind(body).pos, p.bind(body).xpos, p.bind(geom).size,
                 p.bind(body).mass]
        p.bind(joints).qpos = np.array([0.25, -0.25])
        assert p.is_dirty
        reads += [p.bind(body).xpos, p.bind(joints).qpos,
                  p.bind(root.find("site", "tip")).xpos,
                  p.bind(root.find("jointpos", "zpos")).sensordata]
        assert not p.is_dirty
        p.bind(root.find("motor", "push")).ctrl = 0.5
        p.bind(geom).size = np.array([0.2, 0.0, 0.0])
        reads += [p.bind(root.find("motor", "push")).ctrl,
                  p.bind(geom).size, p.bind(["ball"]).xpos]
        for _ in range(3):
            p.step()
        reads += [p.bind(body).xpos, p.bind(joints).qvel]
        with pytest.raises(ValueError, match="unnamed"):
            p.bind(m.Element("geom"))
        with pytest.raises(ValueError, match="mixed"):
            p.bind([body, geom])
        out.append(reads)
    for i, (a, b) in enumerate(zip(*out)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-12,
                                   err_msg=str(i))


def test_physics_from_xml_string_drops_a_sphere_to_rest():
    """The drive recipe: a sphere dropped on a plane comes to rest at its
    radius."""
    from dm_control_torch.physics.physics import Physics

    root = tmjcf.Element("mujoco")
    wb = root.add("worldbody")
    wb.add("geom", type="plane", size="1 1 .1")
    b = wb.add("body", pos="0 0 1")
    b.add("freejoint")
    b.add("geom", type="sphere", size="0.1")
    p = Physics.from_xml_string(root.to_xml_string(), device="cpu")
    assert p.model.dtype == torch.float64 and p.model.nq == 7
    p.step(500)
    assert abs(float(p.data.qpos[2]) - 0.1) < 1e-3
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Physics.from_xml_string(root.to_xml_string())
