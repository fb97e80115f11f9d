"""The port's CUDA kernel and its GPU path; these tests need a card.

Every test here carries the ``cuda`` marker and skips without a CUDA
device: a CUDA kernel has no CPU mode.  The file imports no JAX, so it
also runs on a machine that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: 2e-4 (float32) and 1e-10 (float64) between the kernel and its
plain version, as tests/test_ops_linalg.py holds the Pallas kernel, at
every n of the three branches up to 1,370 (an 11v11 HUMANOID match); 1e-8
for a float64 control step against the JAX golden.  The global kernel is
also held to its own bits over 20 calls (a race between a cluster's CTAs
would show there).
"""

import os

import numpy as np
import pytest
import torch

from _torch_helpers import (
    PREFIXES, ROOT, assert_step_matches_golden, golden,
)
from dm_control_torch import manipulation, suite
from dm_control_torch.ops import linalg
from dm_control_torch.physics import fastpath
from dm_control_torch.rl.control import apply_model_diff

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-4, torch.float64: 1e-10}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    linalg.build()
    return torch.device("cuda")


def _spd(rng, b, n, dtype, device):
    q = rng.standard_normal((b, n, n))
    a = q @ np.swapaxes(q, -1, -2) + n * np.eye(n)
    return torch.as_tensor(a, dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
# n on both sides of every boundary of the launcher's rule (32 and, in
# float32, 64) and of the block kernel's panels (64/65, 96/97, 128/129),
# and the nv of every ported model; 1001 fills no block of 4 warps evenly;
# the block kernel's main-path n (the rat's 73, dog's 79 and 85) and its
# largest at B = 1, 4 and 512
@pytest.mark.parametrize("n,b", [(1, 5), (2, 1000), (2, 8192), (3, 1024),
                                 (4, 1001), (7, 1024), (9, 4096),
                                 (11, 1024), (14, 1001), (20, 1024),
                                 (27, 1024), (31, 1001),
                                 (32, 1001), (33, 1001), (62, 1024),
                                 (63, 1001), (64, 1001), (65, 1001),
                                 (96, 1001), (97, 1001), (128, 64),
                                 (129, 64),
                                 (73, 1), (73, 4), (73, 512),
                                 (79, 1), (79, 4), (79, 512), (79, 1000),
                                 (85, 1), (85, 4), (85, 512),
                                 (160, 1), (160, 3), (160, 4), (160, 512),
                                 # soccer 10v10 and 11v11, both sides of
                                 # the block kernel's last n (202 in
                                 # float64, 303 in float32) and of a panel
                                 # of the global kernel (320/321), a
                                 # HUMANOID 2v2 match, an 11v11 one; on
                                 # the global kernel, fewer chunks of 32
                                 # rows below the first panel than a
                                 # cluster has CTAs (203, 230), ANT 11v11
                                 # (314), HUMANOID 3v3 (378)
                                 (161, 4), (166, 1), (182, 1), (182, 64),
                                 (202, 4), (203, 1), (203, 4), (230, 1),
                                 (230, 4), (254, 1), (254, 4), (254, 64),
                                 (303, 4), (304, 1), (304, 4), (314, 1),
                                 (320, 4), (321, 4), (378, 1), (378, 4),
                                 (1370, 1), (1370, 4)])
def test_kernel_matches_plain_version(cuda, n, b, dtype):
    rng = np.random.default_rng(n)
    a = _spd(rng, b, n, dtype, cuda)
    rhs = torch.as_tensor(rng.standard_normal((b, n)), dtype=dtype,
                          device=cuda)
    x = linalg.chol_solve_cuda(a, rhs)
    torch.cuda.synchronize()
    torch.testing.assert_close(x, linalg.chol_solve_reference(a, rhs),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [27, 32, 33, 64, 65, 73, 85, 160, 254])
def test_shared_matrix_is_read_with_stride_0(cuda, n, dtype):
    """One (n, n) matrix for the batch: directly, and as an expanded view
    through the dispatcher, which hands over the one copy."""
    rng = np.random.default_rng(n)
    a = _spd(rng, 1, n, dtype, cuda)[0]
    rhs = torch.as_tensor(rng.standard_normal((1001, n)), dtype=dtype,
                          device=cuda)
    ref = linalg.chol_solve_reference(a.expand(1001, n, n), rhs)
    before = linalg.chol_solve.launches
    x = linalg.chol_solve_cuda(a, rhs)
    x_view = linalg.chol_solve(a.expand(1001, n, n), rhs)
    torch.cuda.synchronize()
    assert linalg.chol_solve.launches == before + 2
    torch.testing.assert_close(x, ref, rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(x_view, x, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [27, 32, 33, 64, 65, 73, 85, 160, 254, 1370])
def test_kernel_reads_the_lower_triangle_only(cuda, n, dtype):
    """What stands above the diagonal of a is no input, for the kernel as
    for the plain version, on both sides of the launcher's boundaries and
    on the global kernel (4 systems at n = 1,370)."""
    rng = np.random.default_rng(n)
    b = 4 if n > 1000 else 1001
    a = _spd(rng, b, n, dtype, cuda)
    rhs = torch.as_tensor(rng.standard_normal((b, n)), dtype=dtype,
                          device=cuda)
    junk = a.tril() + torch.as_tensor(rng.standard_normal((b, n, n)),
                                      dtype=dtype, device=cuda).triu(1)
    ref = linalg.chol_solve_reference(a, rhs)
    torch.testing.assert_close(linalg.chol_solve_reference(junk, rhs), ref,
                               rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(linalg.chol_solve_cuda(junk, rhs), ref,
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [27, 62, 73, 79, 85, 160, 254, 1370])
def test_non_spd_system_gives_nan_in_its_row_only(cuda, n, dtype):
    rng = np.random.default_rng(0)
    a = _spd(rng, 64, n, dtype, cuda)
    a[5] = -a[5]
    rhs = torch.ones(64, n, dtype=dtype, device=cuda)
    x = linalg.chol_solve_cuda(a, rhs)
    ref = linalg.chol_solve_reference(a, rhs)
    assert torch.isnan(x).any(-1).nonzero().flatten().tolist() == [5]
    assert torch.isnan(x[5]).all() and torch.isnan(ref[5]).all()
    keep = torch.arange(64, device=cuda) != 5
    torch.testing.assert_close(x[keep], ref[keep], rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [203, 254, 1370])
@pytest.mark.parametrize("b", [1, 4])
def test_kernel_repeats_bit_for_bit(cuda, n, b, dtype):
    """The same call 20 times gives the same bits: on the global kernel
    (float64 from 203, float32 at 1,370) one CTA of a cluster writes a tile
    of the triangle that another reads later, so a race between them shows
    as calls that differ."""
    rng = np.random.default_rng(900 + n)
    a = _spd(rng, b, n, dtype, cuda)
    rhs = torch.as_tensor(rng.standard_normal((b, n)), dtype=dtype,
                          device=cuda)
    x = linalg.chol_solve_cuda(a, rhs)
    for _ in range(19):
        assert torch.equal(linalg.chol_solve_cuda(a, rhs), x)
    torch.testing.assert_close(x, linalg.chol_solve_reference(a, rhs),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [254, 378, 1370])
def test_global_kernel_shared_matrix_junk_and_non_spd(cuda, n, dtype):
    """On the global kernel (and the block kernel at 254 in float32): one
    matrix shared by 4 systems (a batch stride of 0), junk above the
    diagonal, and a system that is not positive definite among 4, whose row
    alone is NaN."""
    rng = np.random.default_rng(1000 + n)
    a = _spd(rng, 4, n, dtype, cuda)
    rhs = torch.as_tensor(rng.standard_normal((4, n)), dtype=dtype,
                          device=cuda)
    tol = dict(rtol=TOL[dtype], atol=TOL[dtype])
    shared = linalg.chol_solve_cuda(a[0].contiguous(), rhs)
    torch.testing.assert_close(shared, linalg.chol_solve_reference(
        a[0].expand(4, n, n), rhs), **tol)
    junk = a.tril() + torch.as_tensor(rng.standard_normal((4, n, n)),
                                      dtype=dtype, device=cuda).triu(1)
    torch.testing.assert_close(linalg.chol_solve_cuda(junk, rhs),
                               linalg.chol_solve_reference(a, rhs), **tol)
    a[2] = -a[2]
    x = linalg.chol_solve_cuda(a, rhs)
    assert torch.isnan(x).any(-1).nonzero().flatten().tolist() == [2]
    assert torch.isnan(x[2]).all()
    keep = torch.tensor([0, 1, 3], device=cuda)
    torch.testing.assert_close(x[keep], linalg.chol_solve_reference(
        a, rhs)[keep], **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_global_kernel_launches_a_cluster(cuda, dtype):
    """The global kernel solves a system on a thread-block cluster: the
    library's count of its CTAs is at least 2 for a few systems, the card
    holds such a cluster, a batch that fills the card takes one CTA a
    system, and a launch without a scratch is refused with the branch and
    n named."""
    ctas = linalg.cluster_ctas(dtype, 1)
    assert ctas >= 2 and linalg.cluster_ctas(dtype, 4) >= 2
    assert linalg.global_active_clusters(dtype, ctas) >= 1
    assert linalg.cluster_ctas(dtype, 4096) == 1
    n = linalg._BLOCK_MAX_N[dtype] + 1
    assert linalg.kernel_branch(n, dtype) == "global"
    rng = np.random.default_rng(2)
    a = _spd(rng, 1, n, dtype, cuda)
    rhs = torch.ones(1, n, dtype=dtype, device=cuda)
    x = torch.empty_like(rhs)
    err = linalg._ENTRY[dtype](a.data_ptr(), rhs.data_ptr(), x.data_ptr(),
                               None, 1, n, n * n,
                               torch.cuda.current_stream().cuda_stream)
    assert err != 0
    msg = linalg.launch_error(err, "global", n, 1, dtype, False)
    assert f"global kernel at n = {n}" in msg and "no scratch" in msg


def test_dispatch_counts_launches_and_reference_switch(cuda):
    rng = np.random.default_rng(1)
    a = _spd(rng, 8, 6, torch.float32, cuda)
    rhs = torch.ones(8, 6, device=cuda)
    before = linalg.chol_solve.launches
    branches = dict(linalg.chol_solve.branch_launches)
    x = linalg.chol_solve(a, rhs)
    assert linalg.chol_solve.launches == before + 1
    assert linalg.chol_solve.branch_launches == {
        "register": branches["register"] + 1, "block": branches["block"],
        "global": branches["global"]}
    with linalg.reference_solves():
        x_ref = linalg.chol_solve(a, rhs)
    assert linalg.chol_solve.launches == before + 1
    # the block kernel above the register path: n = 65 in float32, 33 in
    # float64, up to 303 and 202; the global kernel above them
    for n, dtype in ((65, torch.float32), (33, torch.float64),
                     (303, torch.float32), (202, torch.float64),
                     (304, torch.float32), (203, torch.float64)):
        linalg.chol_solve(_spd(rng, 2, n, dtype, cuda),
                          torch.ones(2, n, dtype=dtype, device=cuda))
    assert linalg.chol_solve.branch_launches == {
        "register": branches["register"] + 1,
        "block": branches["block"] + 4, "global": branches["global"] + 2}
    assert linalg.chol_solve.launches == before + 7
    torch.testing.assert_close(x, x_ref, rtol=2e-4, atol=2e-4)
    # one matrix shared by the batch
    x_b = linalg.chol_solve(a[0], rhs)
    torch.testing.assert_close(x_b, linalg.chol_solve_reference(
        a[0].expand(8, 6, 6), rhs), rtol=2e-4, atol=2e-4)


def test_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.eye(3, device=cuda).expand(2, 3, 3)
    rhs = torch.ones(2, 3, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        linalg.chol_solve_cuda(a, rhs)
    with pytest.raises(TypeError):
        linalg.chol_solve_cuda(a.contiguous(), rhs.double())
    n = linalg._MAX_N + 1  # no system, so nothing of that size is made
    assert linalg._MAX_N >= 2048
    with pytest.raises(ValueError, match="chol_solve_max_n"):
        linalg.chol_solve_cuda(torch.empty(0, n, n, device=cuda),
                               torch.empty(0, n, device=cuda))


def test_model_without_dofs_forwards_on_the_card(cuda):
    """A model of fixed geoms alone (nv = 0, a scene to render) forwards
    and renders on the card: a system of no unknowns is not launched."""
    from dm_control_torch.physics.physics import Physics

    p = Physics.from_xml_string(
        '<mujoco><worldbody><geom type="sphere" size=".2" pos="0 0 1"/>'
        '<camera name="c" pos="0 -3 1" xyaxes="1 0 0 0 0 1"/></worldbody>'
        '</mujoco>', device=cuda)
    before = linalg.chol_solve.launches
    p.forward()
    assert linalg.chol_solve.launches == before
    assert linalg.chol_solve(torch.empty(2, 0, 0, device=cuda),
                             torch.empty(2, 0, device=cuda)).shape == (2, 0)
    seg = p.render(9, 13, "c", segmentation=True)
    assert seg[4, 6, 0] == 0 and seg[0, 0, 0] == -1


@pytest.mark.parametrize("prefix", PREFIXES)
def test_float64_step_on_the_card_matches_the_jax_golden(cuda, prefix):
    g = golden()
    env = suite.load_batch("humanoid", "run", device=cuda,
                           dtype=torch.float64, autoreset=False)
    before = linalg.chol_solve.launches
    assert_step_matches_golden(env, g, prefix)
    assert linalg.chol_solve.launches - before >= 3 * env.n_sub_steps


def test_float64_dog_fetch_step_takes_the_block_kernel(cuda):
    """dog:fetch's golden (nv 85) in float64: one step from each of its
    start states within the golden gate, every solve on the block kernel
    (n > 32 in float64)."""
    g = golden("dog_fetch")
    env = suite.load_batch("dog", "fetch", device=cuda, dtype=torch.float64,
                           autoreset=False)
    linalg.reset_launch_counts()
    for prefix in PREFIXES:
        assert_step_matches_golden(env, g, prefix)
    counts = linalg.chol_solve.branch_launches
    assert counts["register"] == 0
    assert counts["block"] == linalg.chol_solve.launches
    assert counts["block"] >= 2 * len(PREFIXES) * env.n_sub_steps


def test_float64_rat_golden_step_takes_the_block_kernel(cuda):
    """The rat's two-touch host golden (nv 73) in float64: the reset and the
    first control step from the recorded state within the golden gate,
    every solve on the block kernel."""
    from dm_control_torch.locomotion.examples import basic
    from dm_control_torch.rl import golden as golden_io

    name = "rodent_two_touch"
    with np.load(f"{ROOT}/tests/data/torch_locomotion_env_{name}_f64.npz",
                 allow_pickle=False) as z:
        gold = {k: z[k] for k in z.files}
    gold["actions"] = gold["actions"][:1]
    np.random.seed(11)  # the recording's global state and seed
    env = basic.rodent_two_touch(random_state=11)
    assert env.physics.model.nv == 73
    linalg.reset_launch_counts()
    errs = golden_io.host_episode_errors(env, gold)
    _, ok = golden_io.episode_gate(errs, gold, name)
    assert ok
    counts = linalg.chol_solve.branch_launches
    assert counts["register"] == 0
    assert counts["block"] == linalg.chol_solve.launches
    assert counts["block"] >= 2 * env._n_sub_steps


@pytest.mark.parametrize("name", manipulation.ALL)
def test_every_manipulation_name_runs_on_the_card(cuda, name):
    """``manipulation.load`` gives a working composer environment on the
    card by default: a reset and a control step in float64, finite, with
    the kernel launched at least once a substep (``solve_m``)."""
    env = manipulation.load(name, seed=0)
    assert env.physics.model.device.type == "cuda"
    assert env.physics.model.dtype == torch.float64
    assert env.reset().first()
    spec = env.action_spec()
    before = linalg.chol_solve.launches
    ts = env.step(np.random.RandomState(0).uniform(spec.minimum,
                                                   spec.maximum))
    assert ts.mid() and np.isfinite(ts.reward)
    for v in ts.observation.values():
        assert np.all(np.isfinite(np.asarray(v)))
    assert linalg.chol_solve.launches - before >= env._n_sub_steps


def _loco_host_env(name):
    """The locomotion host environments on the card by default: soccer
    one and two a side on their drawn pitches, ball and CMU 2020 tracking
    on synthetic clips."""
    from dm_control_torch import composer
    from dm_control_torch.locomotion import soccer
    from dm_control_torch.locomotion.arenas import Floor
    from dm_control_torch.locomotion.mocap.loader import (
        synthetic_walking_trajectory,
    )
    from dm_control_torch.locomotion.tasks.reference_pose import (
        MultiClipMocapTracking,
    )
    from dm_control_torch.locomotion.walkers import (
        CMUHumanoidPositionControlledV2020, RollingBallWithHead,
    )

    if name.startswith("soccer"):
        return soccer.load(team_size=int(name[-1]), random_state=0)
    walker = (RollingBallWithHead() if name == "tracking_ball"
              else CMUHumanoidPositionControlledV2020())
    nq = 7 + len(walker.observable_joint_names)
    clips = {"c": synthetic_walking_trajectory(nq=nq, nv=nq - 1)}
    return composer.Environment(
        MultiClipMocapTracking(walker, Floor(), clips), time_limit=10.0,
        random_state=0)


@pytest.mark.parametrize("name", ["soccer_1", "soccer_2", "tracking_ball",
                                  "tracking_cmu2020"])
def test_locomotion_host_path_runs_on_the_card(cuda, name):
    """``soccer.load`` and the tracking tasks through
    ``composer.Environment`` run on the card by default: a reset and a
    control step in float64, finite, with the kernel launched at least
    once a substep."""
    env = _loco_host_env(name)
    assert env.physics.model.device.type == "cuda"
    assert env.physics.model.dtype == torch.float64
    assert env.reset().first()
    spec = env.action_spec()
    before = linalg.chol_solve.launches
    ts = env.step(np.random.RandomState(0).uniform(spec.minimum,
                                                   spec.maximum))
    assert ts.mid() and np.all(np.isfinite(ts.reward))
    for v in ts.observation.values():
        assert np.all(np.isfinite(np.asarray(v)))
    assert linalg.chol_solve.launches - before >= env._n_sub_steps


@pytest.mark.parametrize("name", ["cmu_humanoid_maze_forage",
                                  "rodent_two_touch"])
def test_locomotion_example_runs_on_the_card(cuda, name):
    """A locomotion example (``examples.basic``) on the card by default: a
    maze whose task reads the contacts after every step (the CMU 2019
    humanoid, nv 62) and the rat's two-touch task (nv 73) reset and
    stepped one control step in float64, finite, with the kernel launched
    at least once a substep."""
    from dm_control_torch.locomotion.examples import basic

    env = getattr(basic, name)(random_state=0)
    assert env.physics.model.device.type == "cuda"
    assert env.physics.model.dtype == torch.float64
    assert env.physics.model.nv == (73 if name.startswith("rodent") else 62)
    assert env.reset().first()
    spec = env.action_spec()
    before = linalg.chol_solve.launches
    ts = env.step(np.random.RandomState(0).uniform(spec.minimum,
                                                   spec.maximum))
    assert ts.mid() and np.isfinite(ts.reward)
    for v in ts.observation.values():
        assert np.all(np.isfinite(np.asarray(v)))
    assert linalg.chol_solve.launches - before >= env._n_sub_steps


def test_branch_rule_and_scratch(cuda):
    """The launcher's rule: the register kernel up to 32 (64 in float32),
    the block kernel up to the largest n whose triangle fits a block's
    shared memory (202 in float64, 303 in float32), the global kernel
    above, to at least 2,048; the global kernel's scratch is the packed
    triangle with b as row n, whose offsets stay within int at the
    largest n."""
    rule = {torch.float64: (32, 202), torch.float32: (64, 303)}
    for dtype, (reg, block) in rule.items():
        assert linalg.kernel_branch(reg, dtype) == "register"
        assert linalg.kernel_branch(reg + 1, dtype) == "block"
        assert linalg.kernel_branch(block, dtype) == "block"
        assert linalg.kernel_branch(block + 1, dtype) == "global"
        assert linalg.kernel_branch(2048, dtype) == "global"
    assert linalg._SCRATCH_ELEMS(1370) == 942564
    assert linalg._SCRATCH_ELEMS(linalg._MAX_N) < 2 ** 31


def _soccer(team_size, walker_type="boxhead", dtype=torch.float64,
            pitch_size=(12, 9)):
    from dm_control_torch.locomotion import soccer

    return soccer.load(team_size=team_size, walker_type=walker_type,
                       pitch_size=pitch_size, random_state=0, dtype=dtype)


@pytest.mark.parametrize("team_size,nv", [(10, 166), (11, 182)])
def test_large_boxhead_match_runs_on_the_card(cuda, team_size, nv):
    """BoxHead ten and eleven a side (nv 166 and 182, over the block
    kernel's first cap of 160) on their drawn pitches (a (12, 9) pitch
    holds no 22 players apart) reset and step one control step in
    float64: finite, and every solve on the block kernel."""
    env = _soccer(team_size, pitch_size=None)
    assert env.physics.model.nv == nv
    assert linalg.kernel_branch(nv, torch.float64) == "block"
    linalg.reset_launch_counts()
    assert env.reset().first()
    spec = env.action_spec()
    ts = env.step(np.random.RandomState(0).uniform(spec.minimum,
                                                   spec.maximum))
    assert ts.mid() and np.all(np.isfinite(ts.reward))
    for v in ts.observation.values():
        assert np.all(np.isfinite(np.asarray(v)))
    counts = linalg.chol_solve.branch_launches
    assert counts["block"] == linalg.chol_solve.launches
    assert counts["block"] >= 2 * env._n_sub_steps


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("walker_type,nv", [("ant", 62), ("humanoid", 254)])
def test_walker_match_runs_on_the_card(cuda, walker_type, nv, dtype):
    """ANT and HUMANOID matches two a side reset and step one control step
    in both types: finite, every solve on the branch its (nv, type) names
    (the humanoids' 254: the global kernel in float64, the block kernel
    in float32)."""
    env = _soccer(2, walker_type, dtype)
    assert env.physics.model.nv == nv
    branch = linalg.kernel_branch(nv, dtype)
    linalg.reset_launch_counts()
    assert env.reset().first()
    spec = env.action_spec()
    ts = env.step(np.random.RandomState(0).uniform(spec.minimum,
                                                   spec.maximum))
    assert ts.mid() and np.all(np.isfinite(ts.reward))
    for v in ts.observation.values():
        assert np.all(np.isfinite(np.asarray(v)))
    counts = linalg.chol_solve.branch_launches
    assert counts[branch] == linalg.chol_solve.launches
    assert counts[branch] >= 2 * env._n_sub_steps


# -- the fused fast path's kernel (physics/fastpath.py) ----------------------

FAST_TASKS = (("pendulum", "swingup"), ("cartpole", "swingup"),
              ("acrobot", "swingup"), ("reacher", "easy"), ("walker", "run"),
              ("cheetah", "run"))
FAST_NAMES = tuple(f"{d}:{t}" for d, t in FAST_TASKS) + ("colliders",)


def _colliders_model(dtype, device):
    from dm_control_torch import mjcf

    with open(os.path.join(ROOT, "tests", "data",
                           "torch_fastpath_colliders.xml")) as f:
        return mjcf.compile_xml_string(f.read(), device=device, dtype=dtype)


def _fast_inputs(name, dtype, device, batch=64):
    """(FastStep, its inputs for one control step, substeps): a suite path
    after its reset and one control step, its next control step's inputs;
    or the inline collider model near qpos0."""
    gen = torch.Generator(device=device).manual_seed(0)
    if name == "colliders":
        m = _colliders_model(dtype, device)
        qpos = m.qpos0 + 0.005 * torch.randn(batch, m.nq, generator=gen,
                                             device=device, dtype=dtype)
        qvel = 0.2 * torch.randn(batch, m.nv, generator=gen, device=device,
                                 dtype=dtype)
        ctrl = 2 * torch.rand(batch, m.nu, generator=gen, device=device,
                              dtype=dtype) - 1
        return fastpath.build_step(m), [qpos, qvel, torch.zeros_like(qvel),
                                        ctrl], 1
    domain, task = name.split(":")
    env = suite.load_batch(domain, task, device=device, dtype=dtype)
    state, _ = env.reset(batch, gen)

    def action():
        return 2 * torch.rand(batch, env.model.nu, generator=gen,
                              device=device, dtype=dtype) - 1

    state, _ = env.step(state, action())
    d = env.task.before_step(
        apply_model_diff(env.model, state.model_diff),
        env._unstrip(state.data), action())
    return env._fast, [x.contiguous() for x in (
        d.qpos, d.qvel, d.qacc_warmstart, d.ctrl)], env.n_sub_steps


def _env_dev(got, ref, scale):
    return torch.stack([((g - r).abs().amax(-1)
                         / max(1.0, float(c.abs().max()))).double()
                        for g, r, c in zip(got, ref, scale)]).amax(0)


def _assert_kernel_matches_plain(cuda, name, dtype, fast, args, n):
    """One launch of the kernel against the plain version from ``args``.
    float64: within 1e-10 of max(1, each field's largest entry).  float32:
    each environment within 2e-4 of that scale, or, where float32 itself
    is further than that from the float64 step of the same state (stiff
    contacts), no further from it than twice the plain float32 version
    (chip_smoke.py's phase 5 gate)."""
    before = fastpath.fastpath_step_cuda.launches
    got = fastpath.fastpath_step_cuda(fast, *args, n)
    torch.cuda.synchronize()
    assert fastpath.fastpath_step_cuda.launches == before + 1
    ref = fast.plain(*args, n)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    dev = _env_dev(got, ref, ref)
    if dtype == torch.float64:
        assert float(dev.max()) <= TOL[dtype], float(dev.max())
        return
    fast64, _, _ = _fast_inputs(name, torch.float64, cuda, 1)
    ref64 = fast64.plain(*[a.double() for a in args], n)
    dev_plain = _env_dev(ref, ref64, ref64)
    dev_kernel = _env_dev(got, ref64, ref64)
    held = (dev <= TOL[dtype]) | ((dev_plain > TOL[dtype])
                                  & (dev_kernel <= 2 * dev_plain))
    assert bool(held.all()), (float(dev.max()), int((~held).sum()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", FAST_NAMES)
def test_fastpath_kernel_matches_plain_version(cuda, name, dtype):
    """One control step through the kernel and through the plain version
    from the same state, under ``_assert_kernel_matches_plain``'s gate."""
    fast, args, n = _fast_inputs(name, dtype, cuda)
    _assert_kernel_matches_plain(cuda, name, dtype, fast, args, n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fastpath_kernel_groups_of_a_block_run_apart(cuda, dtype):
    """cheetah with every other environment lifted 1 m: the four
    environments of each block alternate between the air (one Newton
    iteration) and the floor (more), so the groups of a block leave their
    Newton loops at different times; the plain version's gate holds."""
    fast, args, n = _fast_inputs("cheetah:run", dtype, cuda)
    args[0] = args[0].clone()
    args[0][::2, 1] += 1.0  # rootz
    fast.plain(*args, n)
    its = fast.newton_iterations
    assert int(its[0::2].max()) < int(its[1::2].max()), its
    _assert_kernel_matches_plain(cuda, "cheetah:run", dtype, fast, args, n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch", [1, 37])
@pytest.mark.parametrize("name", ["cartpole:swingup", "cheetah:run"])
def test_fastpath_kernel_at_a_ragged_batch(cuda, name, batch, dtype):
    """B = 1 and 37 fill no block (16 environments a block for cartpole, 4
    for cheetah): the last block's spare groups leave at once."""
    fast, args, n = _fast_inputs(name, dtype, cuda, batch)
    _, envs, _ = fastpath.launch_layout(fast, dtype)
    assert batch % envs != 0
    _assert_kernel_matches_plain(cuda, name, dtype, fast, args, n)


@pytest.mark.parametrize("domain,task", FAST_TASKS)
@pytest.mark.parametrize("prefix", PREFIXES)
def test_fastpath_golden_step_through_the_kernel(cuda, domain, task, prefix):
    """The float64 golden control step of the six fast-path domains
    through the kernel: the golden gate, one launch, no chol_solve."""
    env = suite.load_batch(domain, task, device=cuda, dtype=torch.float64,
                           autoreset=False)
    assert env._fast is not None
    linalg.reset_launch_counts()
    fastpath.reset_launch_count()
    assert_step_matches_golden(env, golden(domain), prefix)
    assert fastpath.fastpath_step_cuda.launches == 1
    assert linalg.chol_solve.launches == 0


def test_fastpath_kernel_raises_and_never_falls_back(cuda):
    """A CUDA tensor launches the kernel or raises: a wrong device, type,
    shape (another model's plan) or layout raises; nothing runs the plain
    version instead."""
    fast, (qpos, qvel, warm, ctrl), _ = _fast_inputs("cartpole:swingup",
                                                     torch.float32, cuda, 4)
    before = fastpath.fastpath_step_cuda.launches
    with pytest.raises(TypeError):
        fast(qpos, qvel.double(), warm, ctrl)
    with pytest.raises(TypeError):
        fast(qpos.half(), qvel.half(), warm.half(), ctrl.half())
    with pytest.raises(ValueError, match="CUDA device"):
        fast(qpos, qvel.cpu(), warm, ctrl)
    with pytest.raises(ValueError, match="contiguous"):
        fast(qpos, qvel.t().contiguous().t(), warm, ctrl)
    pendulum = suite.load_batch("pendulum", "swingup", device=cuda,
                                dtype=torch.float32)._fast
    with pytest.raises(ValueError, match="shape"):
        pendulum(qpos, qvel, warm, ctrl)  # cartpole's state, pendulum's plan
    with pytest.raises(ValueError, match="n_steps"):
        fast(qpos, qvel, warm, ctrl, -1)
    assert fastpath.fastpath_step_cuda.launches == before
    fast(qpos, qvel, warm, ctrl)
    assert fastpath.fastpath_step_cuda.launches == before + 1


def test_fastpath_cpu_route_leaves_the_counter(cuda):
    """The CPU route runs the plain version: the launch count stays; the
    same BatchEnv on the card launches once a control step and once a
    reset that settles (cheetah's 200 steps)."""
    fastpath.reset_launch_count()
    for device in ("cpu", cuda):
        env = suite.load_batch("cheetah", "run", device=device,
                               dtype=torch.float32)
        state, _ = env.reset(2, torch.Generator(device=device).manual_seed(0))
        env.step(state, torch.zeros(2, env.model.nu, device=device))
        if device == "cpu":
            assert fastpath.fastpath_step_cuda.launches == 0
    assert fastpath.fastpath_step_cuda.launches == 2
