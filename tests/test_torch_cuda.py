"""The port's CUDA kernel and its GPU path; these tests need a card.

Every test here carries the ``cuda`` marker and skips without a CUDA
device: a CUDA kernel has no CPU mode.  The file imports no JAX, so it
also runs on a machine that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: 2e-4 (float32) and 1e-10 (float64) between the kernel and its
plain version, as tests/test_ops_linalg.py holds the Pallas kernel; 1e-8
for a float64 control step against the JAX golden.
"""

import numpy as np
import pytest
import torch

from _torch_helpers import (
    PREFIXES, ROOT, assert_step_matches_golden, golden,
)
from dm_control_torch import manipulation, suite
from dm_control_torch.ops import linalg

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
                                 (160, 1), (160, 3), (160, 4), (160, 512)])
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
@pytest.mark.parametrize("n", [27, 32, 33, 64, 65, 73, 85, 160])
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
@pytest.mark.parametrize("n", [27, 32, 33, 64, 65, 73, 85, 160])
def test_kernel_reads_the_lower_triangle_only(cuda, n, dtype):
    """What stands above the diagonal of a is no input, for the kernel as
    for the plain version, on both sides of the launcher's boundaries."""
    rng = np.random.default_rng(n)
    a = _spd(rng, 1001, n, dtype, cuda)
    rhs = torch.as_tensor(rng.standard_normal((1001, n)), dtype=dtype,
                          device=cuda)
    junk = a.tril() + torch.as_tensor(rng.standard_normal((1001, n, n)),
                                      dtype=dtype, device=cuda).triu(1)
    ref = linalg.chol_solve_reference(a, rhs)
    torch.testing.assert_close(linalg.chol_solve_reference(junk, rhs), ref,
                               rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(linalg.chol_solve_cuda(junk, rhs), ref,
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [27, 62, 73, 79, 85, 160])
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


def test_dispatch_counts_launches_and_reference_switch(cuda):
    rng = np.random.default_rng(1)
    a = _spd(rng, 8, 6, torch.float32, cuda)
    rhs = torch.ones(8, 6, device=cuda)
    before = linalg.chol_solve.launches
    branches = dict(linalg.chol_solve.branch_launches)
    x = linalg.chol_solve(a, rhs)
    assert linalg.chol_solve.launches == before + 1
    assert linalg.chol_solve.branch_launches == {
        "register": branches["register"] + 1, "block": branches["block"]}
    with linalg.reference_solves():
        x_ref = linalg.chol_solve(a, rhs)
    assert linalg.chol_solve.launches == before + 1
    # the block kernel above the register path: n = 65 in float32, 33 in
    # float64
    for n, dtype in ((65, torch.float32), (33, torch.float64)):
        linalg.chol_solve(_spd(rng, 2, n, dtype, cuda),
                          torch.ones(2, n, dtype=dtype, device=cuda))
    assert linalg.chol_solve.branch_launches == {
        "register": branches["register"] + 1,
        "block": branches["block"] + 2}
    assert linalg.chol_solve.launches == before + 3
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
    with pytest.raises(ValueError, match="n <="):
        big = torch.eye(200, device=cuda).expand(1, 200, 200).contiguous()
        linalg.chol_solve_cuda(big, torch.ones(1, 200, device=cuda))


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
