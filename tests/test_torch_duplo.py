"""Duplo's separation force and the stud-radius tuning in the port
against the JAX package: ``measure_separation_force`` of two bricks in
float64 on the CPU at a short ``time_limit`` (five steps a probe)
against the JAX package's recording
(``tests/data/torch_duplo_separation_f64.npz``, from ``JAX_PLATFORMS=cpu
python tools/export_torch_assets.py duplo_golden``), one probe's heights
within 1e-9; ``tune_stud_radius`` and ``tune_all_variants`` with a stubbed
force function against the JAX package's with the same stub.  The
``slow`` case holds the recording to a fresh JAX run."""

import numpy as np
import pytest
import torch

from _torch_helpers import export_tool
from dm_control_torch.entities.props import duplo
from dm_control_torch.entities.props.duplo import autotune, utils


@pytest.fixture(scope="module")
def gold():
    with np.load(export_tool().duplo_golden_path()) as z:
        return {k: z[k] for k in z.files}


def test_separation_force_matches_jax(gold):
    force = utils.measure_separation_force(
        duplo.Duplo(), duplo.Duplo(), device="cpu", dtype=torch.float64,
        **export_tool().DUPLO_ARGS)
    assert force == float(gold["force"])


def test_probe_heights_match_jax(gold):
    physics, frame = utils.separation_physics(duplo.Duplo(), duplo.Duplo(),
                                              device="cpu")
    heights = []
    n_steps = len(gold["probe_heights"]) - 1
    utils.separates(physics, physics.bind(frame),
                    export_tool().DUPLO_PROBE_FORCE, n_steps,
                    heights=heights)
    np.testing.assert_allclose(heights, gold["probe_heights"], rtol=0,
                               atol=1e-9)
    assert heights[-1] > heights[0]  # the force lifts the brick


@pytest.mark.slow
def test_recording_equals_fresh_jax(gold):
    fresh = export_tool().make_duplo_golden()
    for k, v in fresh.items():
        np.testing.assert_array_equal(np.asarray(v), gold[k], err_msg=k)


def _stub_force(radius, easy_align=False, flanges=True, **_):
    """A separation force rising with the radius, by variant."""
    return (4.0 + (radius - 0.0044) / 0.0007 * 16.0
            + 0.5 * bool(easy_align) - 0.25 * bool(flanges))


@pytest.fixture
def stubbed(monkeypatch):
    from dm_control_tpu.entities.props.duplo import autotune as jautotune

    for module in (autotune, jautotune):
        monkeypatch.setattr(module, "get_separation_force_for_radius",
                            _stub_force)
    return jautotune


@pytest.mark.parametrize("force", [6.0, 10.0, 18.0])
def test_tune_stud_radius_matches_jax(stubbed, force):
    got = autotune.tune_stud_radius(force, easy_align=True, flanges=False)
    assert got == stubbed.tune_stud_radius(force, easy_align=True,
                                           flanges=False)
    assert abs(_stub_force(got, True, False) - force) < 0.1


def test_tune_stud_radius_refuses_out_of_bracket(stubbed):
    with pytest.raises(ValueError, match="outside the bracket"):
        autotune.tune_stud_radius(100.0)


def test_tune_all_variants_matches_jax(stubbed):
    got = autotune.tune_all_variants()
    want = stubbed.tune_all_variants()
    assert [tuple(k) for k in got] == [tuple(k) for k in want]
    for k in got:
        assert tuple(got[k]) == tuple(want[tuple(k)]), k
    assert set(got) == set(duplo._STUD_SIZE_PARAMS)
