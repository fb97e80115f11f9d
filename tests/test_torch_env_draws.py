"""The episode starts of every task of the port against the JAX package's,
drawn from a numpy RandomState (the single-environment reset's draws).

For each of the 51 tasks, the port's ``initial_model_diff``, ``init``,
``reject_reinit`` and ``init_act`` with ``RandomContext.numpy`` run beside
the JAX task's with its numpy ``RandomContext``, each from a RandomState
of the same seed, on the same compiled model (the JAX one built from the
port's asset, ``_torch_helpers.jax_model_from_asset``).  qpos, qvel, the
activations and every model override agree to 1e-12 in float64, and both
RandomStates end in the same state: the same numpy calls in the same
order.  Nothing is jit-compiled: quadruped's drop to the ground, whose
contact check the JAX task jit-compiles, is handed the port's contact
check (both packages' collisions are held to each other elsewhere).
"""

import numpy as np
import pytest
import torch

from _torch_helpers import jax_model_from_asset
from dm_control_torch import suite as tsuite
from dm_control_torch.physics import collision as tcoll
from dm_control_torch.physics import kinematics as tkin
from dm_control_torch.physics.model import make_data
from dm_control_torch.rl.control import RandomContext, apply_model_diff

ATOL = 1e-12
SEED = 3
#: variants with no reference file of their own -> the file of the JAX
#: model the JAX task is built on: dog's trot and run differ from its
#: stand and walk only in the floor's size, which no draw reads
_REFERENCE = {"dog_trot": "dog", "dog_run": "dog"}


class _Captured(Exception):
    pass


def _jax_task(domain, task, asset_model):
    """The JAX package's task object of (domain, task): its factory runs
    with the model builder and the ``Environment`` replaced, so no MJCF is
    compiled and nothing is jitted."""
    import importlib

    from dm_control_tpu import suite as jsuite
    from dm_control_tpu.rl import control as jcontrol

    module = importlib.import_module(f"dm_control_tpu.suite.{domain}")
    builder = "_make_model" if domain == "dog" else "get_model"

    def capture(m, task, **kwargs):
        raise _Captured(task)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, builder, lambda *a, **k: asset_model)
        mp.setattr(jcontrol, "Environment", capture)
        try:
            jsuite.build_environment(domain, task)
        except _Captured as c:
            return c.args[0]
    raise AssertionError(f"{domain}:{task} built no environment")


def _port_contact_check(tm):
    """The JAX quadruped task's contact check (count of penetrating
    contacts at qpos under a model diff), computed by the port."""
    def check(q, diff):
        mm = apply_model_diff(tm, {k: torch.tensor(np.asarray(v))
                                   for k, v in diff.items()})
        d = make_data(tm, 1).replace(
            qpos=torch.tensor(np.asarray(q)).reshape(1, -1))
        d = tcoll.collision(mm, tkin.kinematics(mm, d))
        return int((d.contact.dist < 0).sum())
    return check


def _close(port, ref, what):
    port = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    ref = np.asarray(ref, dtype=np.float64)
    if port.ndim == ref.ndim + 1:  # the port's leading environment axis
        assert port.shape[0] == 1, what
        port = port[0]
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL, err_msg=what)


def _same_state(a, b, what):
    sa, sb = a.get_state(), b.get_state()
    assert sa[0] == sb[0] and sa[2:] == sb[2:], what
    np.testing.assert_array_equal(sa[1], sb[1], err_msg=what)


@pytest.mark.parametrize("domain,task", tsuite.ALL_TASKS,
                         ids=[f"{d}-{t}" for d, t in tsuite.ALL_TASKS])
def test_episode_start_draws_match_jax(domain, task):
    from dm_control_tpu.rl.control import RandomContext as JRandomContext

    factory = tsuite.DOMAINS[domain].TASKS[task]
    variant, ttask = factory()
    tm = variant.get_model("cpu", torch.float64)
    jm = jax_model_from_asset(_REFERENCE.get(variant.name, variant.name))
    jtask = _jax_task(domain, task, jm)
    if domain == "quadruped":
        jtask._contact_check = (jm, _port_contact_check(tm))

    t_rs, j_rs = np.random.RandomState(SEED), np.random.RandomState(SEED)
    trc = RandomContext.numpy(t_rs, "cpu", torch.float64)
    jrc = JRandomContext(np_random=j_rs)
    tdiff = ttask.initial_model_diff(tm)
    jdiff = jtask.initial_model_diff(jm)
    assert sorted(tdiff) == sorted(jdiff)
    for k in jdiff:
        _close(tdiff[k], jdiff[k], f"initial diff {k}")

    tq0 = make_data(tm, 1).qpos
    jq0 = np.asarray(jm.qpos0)
    for stage in ("init", "reject_reinit"):
        tq, tv, tdiff = getattr(ttask, stage)(
            tm, tq0.clone(), torch.zeros(1, tm.nv, dtype=torch.float64),
            trc, tdiff)
        jq, jv, jdiff = getattr(jtask, stage)(
            jm, jq0.copy(), np.zeros(jm.nv), jrc, jdiff)
        _close(tq, jq, f"{stage} qpos")
        _close(tv, jv, f"{stage} qvel")
        assert sorted(tdiff) == sorted(jdiff), stage
        for k in jdiff:
            _close(tdiff[k], jdiff[k], f"{stage} diff {k}")
        _same_state(t_rs, j_rs, f"RandomState after {stage}")
    tact, jact = ttask.init_act(tm, trc), jtask.init_act(jm, jrc)
    assert (tact is None) == (jact is None)
    if jact is not None:
        _close(tact, jact, "init_act")
    _same_state(t_rs, j_rs, "RandomState after init_act")


def test_randn_stream_is_numpys():
    """``randn(4)`` and four ``randn()`` give the same values (numpy's
    legacy Gaussian carries its second value from call to call), and the
    numpy context returns (1, ...) draws of numpy's values."""
    a, b = np.random.RandomState(5), np.random.RandomState(5)
    rc = RandomContext.numpy(a, "cpu", torch.float64)
    four = rc.randn(4)
    assert tuple(four.shape) == (1, 4)
    singles = [b.randn() for _ in range(4)]
    np.testing.assert_array_equal(four[0].numpy(), singles)
    _same_state(a, b, "after randn")
    lo = torch.tensor([0.0, -1.0, 2.0], dtype=torch.float64)
    hi = torch.tensor([1.0, 1.0, 5.0], dtype=torch.float64)
    vec = rc.uniform(lo, hi, 3)
    one_by_one = [b.uniform(float(x), float(y)) for x, y in zip(lo, hi)]
    np.testing.assert_array_equal(vec[0].numpy(), one_by_one)
    assert int(rc.randint(0, 4)[0]) == b.randint(4)
    _same_state(a, b, "after uniform and randint")
