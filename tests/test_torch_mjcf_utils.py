"""The port's ``mjcf.export_with_assets``, ``mjcf.debugging`` and
``mjcf.skin`` against the JAX package's (the cases of
``tests/test_mjcf_utils.py`` on the port): the exported XML equals the
JAX package's text and compiles again; asset payloads and the zip; the
creation and attribute-write origins and both dumps; a synthetic ``.skn``
file that parses and serializes to the same bytes in both packages."""

import os
import struct
import zipfile

import numpy as np
import pytest
import torch

import dm_control_tpu.mjcf as jmjcf
import dm_control_torch.mjcf as tmjcf
from dm_control_tpu.mjcf import skin as jskin
from dm_control_torch.mjcf import debugging
from dm_control_torch.mjcf import skin as tskin


def _model(mjcf):
    root = mjcf.Element("mujoco", {"model": "demo"})
    root.add("option", timestep="0.002")
    d = root.add("default")
    dc = d.add("default", **{"class": "thick"})
    dc.add("geom", size="0.2")
    d.add("geom", friction="0.9 0.01 0.001")
    wb = root.add("worldbody")
    b = wb.add("body", name="ball", pos="0 0 1")
    b.add("freejoint")
    b.add("geom", name="ball_geom", type="sphere", **{"class": "thick"})
    return root


def _with_payload(mjcf):
    root = _model(mjcf)
    h = root.add("asset").add("hfield", name="terrain", nrow="4", ncol="4",
                              size="1 1 0.1 0.01", file="terrain.bin")
    h.payload = bytes(range(16))
    return root


def test_export_with_assets_roundtrip(tmp_path):
    path = tmjcf.export_with_assets(_model(tmjcf), str(tmp_path / "port"))
    jpath = jmjcf.export_with_assets(_model(jmjcf), str(tmp_path / "jax"))
    assert os.path.basename(path) == "demo.xml"
    with open(path) as f, open(jpath) as g:
        assert f.read() == g.read()
    reparsed = tmjcf.from_path(path)
    assert reparsed.find("geom", "ball_geom") is not None
    m = tmjcf.compile_model(reparsed, device="cpu", dtype=torch.float64)
    assert m.nq == 7


def test_export_with_assets_writes_payloads(tmp_path):
    tmjcf.export_with_assets(_with_payload(tmjcf), str(tmp_path),
                             assets={"unused.bin": b"x"})
    assert (tmp_path / "terrain.bin").read_bytes() == bytes(range(16))
    assert not (tmp_path / "unused.bin").exists()
    with pytest.raises(ValueError, match="must end with .xml"):
        tmjcf.export_with_assets(_model(tmjcf), str(tmp_path), "demo.txt")


def test_export_as_zip(tmp_path):
    zp = tmjcf.export_with_assets_as_zip(_with_payload(tmjcf),
                                         str(tmp_path / "port"))
    jzp = jmjcf.export_with_assets_as_zip(_with_payload(jmjcf),
                                          str(tmp_path / "jax"))
    with zipfile.ZipFile(zp) as zf, zipfile.ZipFile(jzp) as jz:
        assert sorted(zf.namelist()) == sorted(jz.namelist()) == [
            "demo/demo.xml", "demo/terrain.bin"]
        for name in zf.namelist():
            assert zf.read(name) == jz.read(name), name


def test_debugging_off_records_nothing():
    assert not debugging.debug_mode_enabled()
    root = tmjcf.Element("mujoco")
    geom = root.add("worldbody").add("geom", size="0.1")
    geom.attrib["size"] = "0.2"
    assert debugging.origin_of(geom) is None
    assert debugging.attribute_origin(geom, "size") is None
    assert debugging.element_debug_message(geom, "size") == ""


def test_debugging_records_origins(tmp_path):
    debugging.enable_debug_mode(True)
    try:
        root = tmjcf.Element("mujoco")
        wb = root.add("worldbody")
        assert debugging.origin_of(wb) is not None
        assert "test_torch_mjcf_utils.py" in debugging.origin_of(wb)
        out = debugging.dump_model(root, str(tmp_path / "dump.xml"))
        with open(out) as f:
            assert "created at" in f.read()

        geom = wb.add("geom", type="sphere", size="0.1")
        geom.attrib["size"] = "0.2"
        assert "test_torch_mjcf_utils.py" in debugging.attribute_origin(
            geom, "size")
        msg = debugging.element_debug_message(geom, "size")
        assert "created at" in msg and "last set at" in msg

        with debugging.freeze_current_stack_trace():
            inner = wb.add("body", name="b")
        assert "test_torch_mjcf_utils.py" in debugging.origin_of(inner)

        dump_dir = debugging.dump_full_debug_info_to_disk(
            root, str(tmp_path / "full"))
        with open(f"{dump_dir}/model_annotated.xml") as f:
            assert "created at" in f.read()
        with open(f"{dump_dir}/stack_traces.txt") as f:
            stacks = f.read()
        assert "element <geom>" in stacks
        assert "attribute 'size'" in stacks
        assert "test_torch_mjcf_utils.py" in stacks
    finally:
        debugging.enable_debug_mode(False)
    assert debugging.origin_of(wb) is None


def test_full_dump_dir_turns_debug_mode_on(tmp_path):
    try:
        debugging.set_full_dump_dir(str(tmp_path))
        assert debugging.debug_mode_enabled()
        assert debugging.get_full_dump_dir() == str(tmp_path)
    finally:
        debugging.set_full_dump_dir("")
        debugging.disable_debug_mode()


def _synthetic_skn(nvertex=7, ntexcoord=7, nface=5, bones=("root", "arm")):
    """A ``.skn`` payload in the file's layout, from numpy draws."""
    rng = np.random.RandomState(2)
    parts = [struct.pack("<iiii", nvertex, ntexcoord, nface, len(bones)),
             rng.randn(nvertex, 3).astype("<f4").tobytes(),
             rng.rand(ntexcoord, 2).astype("<f4").tobytes(),
             rng.randint(0, nvertex, (nface, 3)).astype("<i4").tobytes()]
    for i, name in enumerate(bones):
        ids = np.arange(i, nvertex, len(bones))
        parts += [name.encode().ljust(tskin.MAX_BODY_NAME_LENGTH, b"\0"),
                  rng.randn(3).astype("<f4").tobytes(),
                  rng.randn(4).astype("<f4").tobytes(),
                  struct.pack("<i", len(ids)), ids.astype("<i4").tobytes(),
                  rng.rand(len(ids)).astype("<f4").tobytes()]
    return b"".join(parts)


@pytest.mark.parametrize("bones", [(), ("root",), ("root", "arm", "hand")])
def test_skin_parse_roundtrip(bones):
    contents = _synthetic_skn(bones=bones)
    got = tskin.parse(contents, body_getter=lambda name: name)
    want = jskin.parse(contents, body_getter=lambda name: name)
    for field in ("vertices", "texcoords", "faces"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert [b.body() for b in got.bones] == list(bones)
    for b, c in zip(got.bones, want.bones):
        for field in ("bindpos", "bindquat", "vertex_ids", "vertex_weights"):
            np.testing.assert_array_equal(getattr(b, field),
                                          getattr(c, field))
    assert tskin.serialize(got) == jskin.serialize(want) == contents


def test_skin_serialize_refuses_mismatched_bone():
    skin = tskin.parse(_synthetic_skn(bones=("root",)), lambda n: n)
    bone = skin.bones[0]._replace(vertex_weights=np.zeros(1))
    with pytest.raises(ValueError, match="length mismatch"):
        tskin.serialize(skin._replace(bones=[bone]))
