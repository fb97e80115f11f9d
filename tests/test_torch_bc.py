"""The port's behaviour-cloning scripts against the JAX package's, on the
CPU.

- The CEM solver on cartpole:swingup in float64: the batched returns of
  the same candidates from the same reset state, the state after one
  segment and a two-segment ``solve`` with the same normal draws, within
  1e-10 of max(1, scale) of the JAX package's figures
  (``tests/data/torch_bc_cartpole_f64.npz``, written by
  ``tools/export_bc_golden.py``; ``-m slow`` checks it against a fresh JAX
  run); the elite rules (population std, NaN returns ranked last, the
  control-range clip) against JAX's ``solve_segment`` with both solvers'
  returns stubbed; a population of copies of one state against the
  single environment's steps on models with per-episode diffs.
- ``TrajectoryDataset`` from arrays and from an HDF5 file, bit for bit the
  JAX one; the native loader bit for bit the JAX package's at the same
  seed, built under ``_build/``, and raising without g++.
- The trainer: each step's loss and the parameters after one epoch of a
  tiny GPT and an FFNet within 1e-10 of max(1, scale) of the JAX
  ``Trainer``'s (float64, weights carried over, dropout off, the
  learning rate's warm-up engaged, the clip engaged); ``lr_multiplier``,
  the decayed parameters, the checkpoint round trip.
- Evaluation and replay against the JAX functions' figures: policy
  rollouts with reference actions and context, open-loop replay, the
  rows ``create_dataset`` writes (float32 rows within 1e-6 of max(1,
  scale), float64 figures within 1e-10).
- The commands on the CPU (``train``, ``create_dataset``, ``visualize``,
  ``ppo_box2d``, ``print_profile``) and ``utils/profiling``.
"""

import cProfile
import glob
import importlib.util
import inspect
import os
import types

import numpy as np
import pytest
import torch

from dm_control_torch import native
from dm_control_torch.scripts import create_dataset as tcreate
from dm_control_torch.scripts import dataset as tdataset
from dm_control_torch.scripts import evaluate as tevaluate
from dm_control_torch.scripts import model as tmodel
from dm_control_torch.scripts import solver as tsolver
from dm_control_torch.scripts import trainer as ttrainer
from dm_control_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64_TOL = 1e-10
F32_TOL = 1e-6


def _tool():
    path = os.path.join(ROOT, "tools", "export_bc_golden.py")
    spec = importlib.util.spec_from_file_location("export_bc_golden", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TOOL = _tool()


@pytest.fixture(scope="module")
def golden():
    with np.load(TOOL.PATH) as f:
        return dict(f)


def _close(ours, theirs, tol, what):
    ours = ours.detach().cpu().numpy() if torch.is_tensor(ours) else ours
    theirs = np.asarray(theirs)
    scale = max(1.0, float(np.abs(theirs).max()) if theirs.size else 1.0)
    np.testing.assert_allclose(np.asarray(ours, np.float64), theirs, rtol=0,
                               atol=tol * scale, err_msg=what)


def _env(domain="cartpole", task="swingup", dtype=torch.float64):
    from dm_control_torch import suite

    return suite.load(domain, task, task_kwargs={"random": 0}, device="cpu",
                      dtype=dtype)


def _cem(env):
    return tsolver.CEMSolver.for_environment(
        env, segment_length=TOOL.SEGMENT, n_iterations=TOOL.ITERATIONS,
        population=TOOL.POPULATION)


# -- CEM ---------------------------------------------------------------------


def test_cem_returns_and_segment_match_jax(golden):
    """The batched returns of the candidates from the reset state, and the
    state after the first candidate's segment (the hand-off)."""
    env = _env()
    env.reset()
    solver = _cem(env)
    cands = torch.as_tensor(TOOL.candidates())
    _close(solver.batch_returns(env.physics.data, cands),
           golden["cem_returns"], F64_TOL, "returns")
    d = solver.apply_segment(env.physics.data, cands[0])
    assert d.qpos.shape[0] == 1
    for f in TOOL.STATE:
        _close(getattr(d, f)[0], golden[f"cem_segment_{f}"], F64_TOL, f)


def test_cem_solve_with_jax_draws_matches_jax(golden, monkeypatch):
    """Two segments of ``solve`` with JAX's normal draws injected: the same
    actions and each segment's return."""
    env = _env()
    env.reset()
    solver = _cem(env)
    draws = iter(TOOL.solve_draws())
    monkeypatch.setattr(tsolver, "normal", lambda generator, shape, dtype:
                        torch.as_tensor(next(draws), dtype=dtype))
    returns = []
    segment = solver.solve_segment

    def recorded(*args, **kwargs):
        acts, ret = segment(*args, **kwargs)
        returns.append(ret)
        return acts, ret

    solver.solve_segment = recorded
    acts = solver.solve(env.physics.data, TOOL.SOLVE_STEPS, seed=0)
    _close(acts, golden["cem_solve_actions"], F64_TOL, "actions")
    _close(np.asarray(returns), golden["cem_solve_returns"], F64_TOL,
           "segment returns")


def _stub_returns(cands, nan_best):
    """Returns that prefer candidates near a fixed target; with
    ``nan_best`` the best candidate's return is NaN."""
    target = np.linspace(-0.4, 0.9, cands.shape[1] * cands.shape[2]).reshape(
        cands.shape[1:])
    rets = -((np.asarray(cands) - target) ** 2).sum(axis=(1, 2))
    if nan_best:
        rets[int(np.argmax(rets))] = np.nan
    return rets


@pytest.mark.parametrize("case", ["population_std", "min_std_floor",
                                  "nan_last", "ctrl_limited",
                                  "ctrl_range"])
def test_cem_elite_rules_match_jax(case, monkeypatch):
    """``solve_segment`` over three iterations with the returns stubbed
    (the same function of the candidates on both sides) and JAX's draws:
    the elites' population std (ddof 0) and its ``min_std`` floor, a NaN
    return ranked last, the clip to the actuators' limits (one limited,
    one not) or to ``ctrl_range``."""
    import jax
    import jax.numpy as jnp

    from dm_control_tpu.scripts import solver as jsolver

    limited = np.array([1, 0]) if case == "ctrl_limited" else np.array([1, 1])
    ranges = np.array([[-0.3, 0.5], [-2.0, 2.0]])
    kw = dict(segment_length=3, n_iterations=3, population=16,
              elite_frac=0.25, init_std=0.8,
              min_std=0.5 if case == "min_std_floor" else 1e-6,
              ctrl_range=(-0.6, 0.7) if case == "ctrl_range" else None)
    nan_best = case == "nan_last"
    draws = np.random.RandomState(5).standard_normal((3, 16, 3, 2)) * 2.0

    jmodel = types.SimpleNamespace(nu=2, actuator_ctrllimited=limited,
                                   actuator_ctrlrange=ranges)
    jsol = jsolver.CEMSolver(jmodel, None, **kw)
    jsol._batch_returns = lambda d, c: jnp.asarray(_stub_returns(c,
                                                                 nan_best))
    jdraws = iter(draws)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape: jnp.asarray(next(jdraws)))
    j_acts, j_ret = jsol.solve_segment(None, jax.random.PRNGKey(0))

    tmodel_ = types.SimpleNamespace(
        nu=2, actuator_ctrllimited=torch.as_tensor(limited),
        actuator_ctrlrange=torch.as_tensor(ranges), dtype=torch.float64,
        device=torch.device("cpu"))
    tsol = tsolver.CEMSolver(tmodel_, None, **kw)
    tsol.batch_returns = lambda d, c: torch.as_tensor(
        _stub_returns(c.numpy(), nan_best))
    tdraws = iter(draws)
    monkeypatch.setattr(tsolver, "normal", lambda generator, shape, dtype:
                        torch.as_tensor(next(tdraws), dtype=dtype))
    t_acts, t_ret = tsol.solve_segment(None, torch.Generator())
    assert np.isfinite(t_ret) and t_ret == pytest.approx(float(j_ret),
                                                         rel=0, abs=1e-12)
    _close(t_acts, np.asarray(j_acts), F64_TOL, case)
    lo, hi = tsol._lo.numpy(), tsol._hi.numpy()
    assert (t_acts.numpy() >= lo).all() and (t_acts.numpy() <= hi).all()


@pytest.mark.parametrize("domain,task", [("reacher", "easy"),
                                         ("finger", "turn_hard")])
def test_cem_population_steps_as_the_environment(domain, task):
    """Copies of the environment's state (B = 1 broadcast to the
    population, its per-episode diffs: reacher's ``geom_pos``, finger's
    ``dof_damping`` and sites) roll out as the environment steps: the
    returns of equal candidates equal the environment's rewards, and the
    hand-off state its state."""
    env = _env(domain, task)
    env.reset()
    solver = tsolver.CEMSolver.for_environment(env)
    acts = np.random.RandomState(0).uniform(-1, 1, (2, env.action_spec()
                                                    .shape[0]))
    cands = torch.as_tensor(np.stack([acts] * 3))
    rets = solver.batch_returns(env.physics.data, cands)
    d = solver.apply_segment(env.physics.data, cands[0])
    rewards = sum(env.step(a).reward for a in acts)
    _close(rets, np.full(3, rewards), 1e-12, "returns")
    _close(d.qpos[0], env.physics.data.qpos.numpy(), 1e-12, "qpos")


# -- dataset and the native loader -------------------------------------------


def _synthetic(seed=0, n_eps=5, obs_dim=4, act_dim=2):
    rng = np.random.RandomState(seed)
    w = rng.randn(obs_dim, act_dim) * 0.3
    obs, act, done = [], [], []
    for _ in range(n_eps):
        n = rng.randint(3, 30)
        o = rng.randn(n, obs_dim).astype(np.float32)
        d = np.zeros(n, bool)
        d[-1] = True
        obs.append(o)
        act.append(np.tanh(o @ w).astype(np.float32))
        done.append(d)
    return np.concatenate(obs), np.concatenate(act), np.concatenate(done)


def _write_h5(path, obs, act, done):
    tdataset.write_h5(path, {"pos": obs[:, :3], "a_vel": obs[:, 3]}, act,
                      done, rewards=np.arange(len(done), dtype=np.float64))


@pytest.mark.parametrize("source", ["arrays", "hdf5"])
@pytest.mark.parametrize("block", [1, 3, 4, 6, 10])
def test_dataset_matches_jax(block, source, tmp_path):
    """Arrays, index maps, every item and an epoch of batches equal the JAX
    dataset's bit for bit; short episodes dropped alike."""
    from dm_control_tpu.scripts import dataset as jdataset

    obs, act, done = _synthetic(n_eps=8)
    if source == "arrays":
        ours = tdataset.TrajectoryDataset.from_arrays(obs, act, done, block)
        theirs = jdataset.TrajectoryDataset.from_arrays(obs, act, done, block)
    else:
        path = str(tmp_path / "d.hdf5")
        _write_h5(path, obs, act, done)
        ours = tdataset.TrajectoryDataset(path, block, ["pos", "a_vel", ""])
        theirs = jdataset.TrajectoryDataset(path, block, ["pos", "a_vel", ""])
        assert ours.observables == theirs.observables == ["a_vel", "pos"]
    for name in ("observations", "actions", "dones"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(theirs, name), err_msg=name)
    assert ours.episodes_removed == theirs.episodes_removed
    assert (block < 10) or ours.episodes_removed > 0
    assert ours.logical_index == theirs.logical_index
    assert ours.logical_offset == theirs.logical_offset
    assert len(ours) == len(theirs) > 0
    for i in range(len(ours)):
        for a, b in zip(ours[i], theirs[i]):
            np.testing.assert_array_equal(a, b)
    pairs = zip(ours.batches(np.random.RandomState(1), 4),
                theirs.batches(np.random.RandomState(1), 4))
    for (oa, aa), (ob, ab) in pairs:
        np.testing.assert_array_equal(oa, ob)
        np.testing.assert_array_equal(aa, ab)


def test_native_loader_matches_jax():
    """``gather_blocks`` and three prefetched batches equal the JAX
    package's native loader's at the same seed; the port's library lands
    under ``dm_control_torch/_build/``."""
    from dm_control_tpu import native as jnative

    if jnative.load_library() is None:
        pytest.fail("the JAX package's native loader did not build")
    rng = np.random.RandomState(0)
    obs = rng.randn(500, 8).astype(np.float32)
    act = rng.randn(500, 2).astype(np.float32)
    starts = rng.randint(0, 494, 32).astype(np.int64)
    for a, b in zip(native.gather_blocks(obs, act, starts, 6, n_threads=3),
                    jnative.gather_blocks(obs, act, starts, 6, n_threads=3)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(IndexError):
        native.gather_blocks(obs, act, np.array([495]), 6)
    ds = tdataset.TrajectoryDataset.from_arrays(*_synthetic(n_eps=8), 3)
    with native.PrefetchLoader(ds, 8, seed=3, n_threads=2) as ours:
        theirs = jnative.PrefetchLoader(ds, 8, seed=3, n_threads=2)
        try:
            for _ in range(3):
                for a, b in zip(ours.next(), theirs.next()):
                    np.testing.assert_array_equal(a, b)
        finally:
            theirs.close()
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "dm_control_torch",
                                                 "_build")
    assert os.path.exists(path)


def test_native_loader_raises_without_gxx(monkeypatch, tmp_path):
    """With no build and no g++ on PATH, the loader and a trainer with
    native workers raise naming g++ (no quiet numpy fallback)."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_LOADED", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    ds = tdataset.TrajectoryDataset.from_arrays(*_synthetic(), 1)
    with pytest.raises(RuntimeError, match=r"g\+\+"):
        native.PrefetchLoader(ds, 4)
    trainer = ttrainer.Trainer(
        tmodel.FFNet(tmodel.FFConfig(4, 2, hidden_size=8)), ds, None,
        ttrainer.TrainerConfig(max_epochs=1, batch_size=4, num_workers=2),
        device="cpu")
    with pytest.raises(RuntimeError, match=r"g\+\+"):
        trainer.train()


# -- the trainer --------------------------------------------------------------


def _model(name, golden, stage):
    kwargs, block = TOOL.model_configs()[name]
    if name == "gpt":
        config = tmodel.GPTConfig(**kwargs)
        model = tmodel.GPT(config)
    else:
        config = tmodel.FFConfig(**kwargs)
        model = tmodel.FFNet(config)
    model = model.to(torch.float64)
    model.load_state_dict(type(model).from_flax_params(
        TOOL.unflatten(golden, f"{name}_{stage}")))
    return model, config, block


@pytest.mark.parametrize("name", ["gpt", "ffnet"])
def test_trainer_epoch_matches_jax(name, golden):
    """One epoch from the JAX trainer's initial weights: each step's loss
    and the parameters after it."""
    model, _, block = _model(name, golden, "init")
    ds = tdataset.TrajectoryDataset.from_arrays(*TOOL.synthetic(), block)
    trainer = ttrainer.Trainer(model, ds, None,
                               ttrainer.TrainerConfig(**TOOL.TRAINER),
                               device="cpu")
    trainer.build_optimizer()
    losses = []
    step = trainer._train_step

    def recorded(*args):
        loss = step(*args)
        losses.append(float(loss))
        return loss

    trainer._train_step = recorded
    trainer.train()
    _close(np.asarray(losses), golden[f"{name}_losses"], F64_TOL, "losses")
    final, _, _ = _model(name, golden, "final")
    want = final.state_dict()
    for key, value in model.state_dict().items():
        _close(value, want[key].numpy(), F64_TOL, key)


def test_lr_multiplier_matches_jax():
    from dm_control_tpu.scripts import trainer as jtrainer

    ours = ttrainer.TrainerConfig(warmup_tokens=100, final_tokens=1100,
                                  lr_decay=True)
    theirs = jtrainer.TrainerConfig(warmup_tokens=100, final_tokens=1100,
                                    lr_decay=True)
    for tokens in (0, 50, 99, 100, 350, 600, 1100, 5000):
        assert ttrainer.lr_multiplier(tokens, ours) == \
            jtrainer.lr_multiplier(tokens, theirs)
    assert ttrainer.lr_multiplier(50, ours) == pytest.approx(0.5)
    assert ttrainer.lr_multiplier(1100, ours) == pytest.approx(0.1)


@pytest.mark.parametrize("name", ["gpt", "ffnet"])
def test_decayed_parameters_match_jax_mask(name, golden):
    """AdamW's decayed group is the JAX ``_decay_mask``, name for name."""
    from dm_control_tpu.scripts import trainer as jtrainer

    model, _, _ = _model(name, golden, "init")
    tree = TOOL.unflatten(golden, f"{name}_init")
    mask = tmodel._flatten(jtrainer._decay_mask(tree))
    rename = type(model)._flax_prefix
    leaf = {"kernel": "weight", "scale": "weight"}
    decayed = {".".join(filter(None, (rename(path[:-1]),
                                      leaf.get(path[-1], path[-1]))))
               for path, m in mask.items() if m}
    assert decayed == ttrainer.decay_parameter_names(model)
    trainer = ttrainer.Trainer(model, None, None, ttrainer.TrainerConfig(),
                               device="cpu")
    trainer.build_optimizer()
    names = {id(p): n for n, p in model.named_parameters()}
    groups = trainer.optimizer.param_groups
    assert {names[id(p)] for p in groups[0]["params"]} == decayed
    assert groups[0]["weight_decay"] == 0.1 and groups[1]["weight_decay"] == 0


def test_checkpoint_round_trip_and_mesh(tmp_path):
    """A checkpoint restores every parameter bit for bit; a trainer with a
    mesh of this process alone trains as one without."""
    ds = tdataset.TrajectoryDataset.from_arrays(*_synthetic(), 4)
    path = str(tmp_path / "model.pt")
    model = tmodel.GPT(tmodel.GPTConfig(4, 2, 4, n_layer=1, n_head=2,
                                        n_embd=8))
    trainer = ttrainer.Trainer(model, ds, None, ttrainer.TrainerConfig(
        max_epochs=1, batch_size=8, ckpt_path=path), device="cpu")
    trainer.train()
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    trainer.load_checkpoint()
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    # a mesh of this process alone: the same losses and parameters
    from dm_control_torch import parallel

    runs = []
    for mesh in (None, parallel.make_mesh(device="cpu")):
        net = tmodel.GPT(tmodel.GPTConfig(4, 2, 4, n_layer=1, n_head=2,
                                          n_embd=8))
        history = ttrainer.Trainer(net, ds, None, ttrainer.TrainerConfig(
            max_epochs=1, batch_size=8), mesh=mesh, device="cpu").train()
        runs.append((history, net.state_dict()))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


# -- evaluation and replay ----------------------------------------------------


@pytest.mark.parametrize("name", ["gpt", "ffnet"])
def test_policy_episode_matches_jax(name, golden):
    """``run_episode`` with reference actions and context steps: the
    return, the actions and their error against the reference."""
    model, config, _ = _model(name, golden, "final")
    ret, preds, mse = tevaluate.run_episode(
        _env(), model, config, reference_actions=TOOL.reference_actions(),
        context_steps=TOOL.CONTEXT_STEPS)
    _close(np.asarray(ret), golden[f"{name}_eval_return"], F64_TOL, "return")
    _close(preds, golden[f"{name}_eval_preds"], F64_TOL, "actions")
    _close(np.asarray(mse), golden[f"{name}_eval_mse"], F64_TOL, "mse")


def test_replay_and_dataset_rows_match_jax(golden, tmp_path):
    """Open-loop replay (return, observations from ``build_observation``)
    and the rows of ``create_dataset`` for two action files."""
    ret, obs = tevaluate.run_episode_with_reference_actions(
        _env(), TOOL.reference_actions())
    _close(np.asarray(ret), golden["replay_return"], F64_TOL, "return")
    assert obs.dtype == np.float32
    _close(obs, golden["replay_obs"], F32_TOL, "observations")
    ok, again = tevaluate.validate_reference_actions(
        _env(), TOOL.reference_actions(), float(golden["replay_return"]))
    assert ok and again == ret
    files = []
    for k, seed in enumerate((3, 4)):
        files.append(str(tmp_path / f"opt_acts_{k}.npy"))
        np.save(files[-1], TOOL.reference_actions(seed))
    assert tcreate.gather_action_files([str(tmp_path)]) == files
    obs, acts, dones, rewards = tcreate.replay_files(lambda p: _env(), files)
    assert sorted(obs) == sorted(k[len("dataset_obs_"):] for k in golden
                                 if k.startswith("dataset_obs_"))
    for k, v in obs.items():
        _close(v, golden[f"dataset_obs_{k}"], F32_TOL, k)
    np.testing.assert_array_equal(acts, golden["dataset_actions"])
    np.testing.assert_array_equal(dones, golden["dataset_dones"])
    _close(rewards, golden["dataset_rewards"], F64_TOL, "rewards")


@pytest.mark.slow
def test_golden_equals_fresh_jax():
    """The checked-in figures against a fresh run of the JAX package."""
    fresh = TOOL.make_golden()
    with np.load(TOOL.PATH) as f:
        assert sorted(f.files) == sorted(fresh)
        for k, v in fresh.items():
            _close(np.asarray(v, np.float64), np.asarray(f[k], np.float64),
                   1e-12, k)


# -- the commands -------------------------------------------------------------


def test_commands_default_to_the_card():
    from dm_control_torch.scripts import (create_dataset, ppo_box2d, train,
                                          visualize)

    for module in (create_dataset, ppo_box2d, train, visualize):
        assert module.parse_args([]).device == "cuda", module.__name__
    for fn in (ttrainer.Trainer, tevaluate.load_model):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    args = train.parse_args([])
    assert (args.learning_rate, args.grad_norm_clip) == (1e-4, 5.0)
    assert (ttrainer.TrainerConfig.learning_rate,
            ttrainer.TrainerConfig.grad_norm_clip) == (3e-4, 1.0)


def test_train_main_and_load_model(tmp_path):
    """``train.main`` on a small HDF5 file (FFNet, one epoch), then
    ``load_model`` on its config and checkpoint."""
    from dm_control_torch.scripts import train

    obs, act, done = _synthetic(n_eps=8)
    data = str(tmp_path / "d.hdf5")
    _write_h5(data, obs, act, done)
    ckpt, cfg = str(tmp_path / "m.pt"), str(tmp_path / "c.json")
    history = train.main([f"--dataset={data}", "--model=ffnet",
                          "--max_epochs=1", "--batch_size=16",
                          f"--checkpoint_path={ckpt}",
                          f"--config_path={cfg}", "--device=cpu"])
    assert len(history) == 1 and np.isfinite(history[0][0])
    model, config = tevaluate.load_model(cfg, ckpt, device="cpu")
    assert isinstance(model, tmodel.FFNet) and config.obs_size == 4
    policy = tevaluate.policy_fn(model, config)
    assert policy([obs[0], obs[1]]).shape == (2,)


def test_create_dataset_main(tmp_path):
    """``create_dataset.main`` on two action files, the HDF5 read back."""
    for k in range(2):
        np.save(str(tmp_path / f"opt_acts_{k}.npy"),
                TOOL.reference_actions(k)[:5])
    out = str(tmp_path / "out.hdf5")
    tcreate.main([f"--input_dirs={tmp_path}", f"--output_path={out}",
                  "--device=cpu"])
    ds = tdataset.TrajectoryDataset(out, 2)
    assert ds.observables == ["position", "velocity"]
    assert ds.observations.shape == (10, 5) and len(ds) == 8
    with pytest.raises(SystemExit):
        tcreate.main([f"--input_dirs={tmp_path / 'none'}", "--device=cpu"])


def test_visualize_plays_actions_then_zeros(tmp_path, monkeypatch):
    """The saved actions, then zeros, handed to the viewer (its backend
    replaced: no window)."""
    from dm_control_torch import viewer
    from dm_control_torch.scripts import visualize

    actions = TOOL.reference_actions()[:3]
    path = str(tmp_path / "opt_acts_0.npy")
    np.save(path, actions)
    monkeypatch.setattr(viewer, "_BACKEND", lambda env, policy: (env,
                                                                 policy))
    env, policy = visualize.main([f"--ref_actions_path={path}",
                                  "--device=cpu"])
    ts = env.reset()
    played = [policy(ts) for _ in range(5)]
    np.testing.assert_array_equal(np.stack(played[:3]), actions)
    np.testing.assert_array_equal(np.stack(played[3:]), np.zeros((2, 1)))


def test_ppo_box2d_suite_smoke(monkeypatch):
    from dm_control_torch.scripts import ppo_box2d

    monkeypatch.setattr(ppo_box2d, "_gym_available", lambda: False)
    rewards = ppo_box2d.main(["--updates=2", "--batch=8", "--device=cpu"])
    assert len(rewards) == 2 and np.isfinite(rewards).all()


def test_print_profile(tmp_path, capsys):
    from dm_control_torch.scripts import print_profile

    path = str(tmp_path / "profile.out")
    cProfile.runctx("sum(range(1000))", {}, {}, path)
    stats = print_profile.main([path])
    assert stats.total_calls > 0
    assert "cumulative" in capsys.readouterr().out


# -- profiling ----------------------------------------------------------------


def test_time_jitted_reports_timing():
    stats = profiling.time_jitted(lambda x: (x * 2.0).sum(),
                                  torch.ones(64, 64), n_iters=3)
    assert set(stats) == {"compile_s", "median_ms", "mean_ms", "min_ms",
                          "n_iters"}
    assert stats["compile_s"] > 0 and stats["median_ms"] > 0
    assert stats["min_ms"] <= stats["mean_ms"] + 1e-9
    assert stats["n_iters"] == 3


def test_step_timer_accumulates():
    timer = profiling.StepTimer()
    for _ in range(2):
        with timer.phase("rollout"):
            pass
    with timer.phase("update", sync=torch.ones(4) * 2):
        pass
    s = timer.summary()
    assert s["rollout_s"] >= 0 and s["update_mean_ms"] >= 0
    assert set(s) == {"rollout_s", "rollout_mean_ms", "update_s",
                      "update_mean_ms"}
    timer.reset()
    assert timer.summary() == {}


def test_trace_writes_profile(tmp_path):
    logdir = str(tmp_path / "tb")
    x = torch.ones(32, 32)
    with profiling.trace(logdir):
        with profiling.annotate("matmul_region"):
            x @ x
    found = glob.glob(os.path.join(logdir, "*.json"))
    assert len(found) == 1
    with open(found[0]) as f:
        assert "matmul_region" in f.read()


def test_compiled_stats_flops():
    m, n, k = 64, 32, 16
    stats = profiling.compiled_stats(lambda a, b: a @ b, torch.ones(m, k),
                                     torch.ones(k, n))
    assert stats == {"flops": 2.0 * m * n * k}
