"""Shared set-up for the PyTorch port's parity tests (tests/test_torch_*).

A compiled JAX model takes many seconds to build, so each is built once
per test process and shared by every file that needs it.
"""

import functools
import importlib.util
import os

import numpy as np
import torch

from dm_control_torch.rl.golden import PREFIXES, STATE_FIELDS  # noqa: F401
from dm_control_torch.rl.golden import start_state as golden_state  # noqa: F401
from dm_control_torch.rl.golden import ABS_GATE, REL_GATE, gate_figures, \
    step_errors

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one thread per test process: the suite runs under several xdist workers
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def export_tool():
    """The asset tool (tools/export_torch_assets.py) as a module."""
    path = os.path.join(ROOT, "tools", "export_torch_assets.py")
    spec = importlib.util.spec_from_file_location("export_torch_assets",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def jax_render_tool():
    """The JAX renderer's tool (tools/jax_render.py) as a module."""
    return export_tool().jax_render_tool()


@functools.lru_cache(maxsize=None)
def jax_model(asset):
    """The JAX package's compiled model behind one of the port's asset
    names (``export_tool().ASSETS``)."""
    return export_tool().jax_model(asset)


@functools.lru_cache(maxsize=None)
def jax_model_from_asset(asset):
    """The JAX package's ``Model`` built from the port's checked-in asset
    (the JAX compiler's output, saved field by field), without compiling
    MJCF: for the big models, whose JAX compile takes most of a minute
    here.  The slow tier checks each asset against a fresh export."""
    from dm_control_torch.physics import model_io

    return jax_model_from_port(model_io.load(export_tool().asset_path(asset),
                                             "cpu", torch.float64))


def jax_model_from_port(m):
    """The JAX package's ``Model`` with every field of the port's float64
    CPU model ``m`` (no MJCF compile)."""
    import dataclasses

    import jax.numpy as jnp

    from dm_control_tpu.physics import model as jmodel

    def leaf(v):
        return jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v

    def build(cls, src):
        return cls(**{f.name: leaf(getattr(src, f.name))
                      for f in dataclasses.fields(cls) if f.init})

    kwargs = {}
    for f in dataclasses.fields(jmodel.Model):
        if not f.init:
            continue
        if f.name == "opt":
            kwargs[f.name] = build(jmodel.Option, m.opt)
        elif f.name == "stat":
            kwargs[f.name] = build(jmodel.Statistic, m.stat)
        elif f.name == "names":
            kwargs[f.name] = jmodel.NameMap(**{
                slot: getattr(m.names, slot) for slot in m.names.SLOTS})
        else:
            kwargs[f.name] = leaf(getattr(m, f.name))
    return jmodel.Model(**kwargs)


def golden(domain="humanoid"):
    """The domain's golden file (tools/export_torch_assets.py) as a dict."""
    with np.load(export_tool().golden_path(domain), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def assert_step_matches_golden(env, gold, prefix, atol=1e-8):
    """One ``env.step`` from the golden's ``prefix`` start states equals the
    JAX result within ``atol`` in state, every observation and reward, and
    exactly in discount and step type, and passes the golden gate
    (``rl/golden.py``: ``qacc_warmstart`` within 1e-12 of its largest
    recorded entry, the rest within 1e-9).  Prints the largest deviation
    and the gate's two figures (shown with ``pytest -s``)."""
    errs = step_errors(env, gold, prefix)
    worst = max(errs, key=errs.get)
    rest, rel = gate_figures(errs, gold, prefix)
    print(f"\n{prefix}: max |port - JAX| {errs[worst]:.3e} ({worst}); "
          f"gate: rest {rest:.3e}, qacc_warmstart {rel:.3e} of its scale")
    assert errs[worst] <= atol, (worst, errs[worst])
    assert rest <= ABS_GATE and rel <= REL_GATE, (rest, rel)
    assert errs["discount"] == 0 and errs["step_type"] == 0, errs


def golden_rows(gold, picks):
    """Physics states from a golden file: ``picks`` is a list of
    (prefix, environment); returns a dict of stacked float64 arrays
    (qpos, qvel, qacc_warmstart, act, ctrl) and the stacked model
    overrides."""
    from dm_control_torch.rl.golden import model_diff

    def stack(field):
        return np.stack([gold[f"{p}_{field}"][e] for p, e in picks])

    state = {f: stack(f) for f in ("qpos", "qvel", "qacc_warmstart")}
    state["ctrl"] = stack("actions")
    if "reset_act" in gold:
        state["act"] = stack("act")
    diffs = [model_diff(gold, p, e) for p, e in picks]
    return state, {k: np.stack([d[k] for d in diffs]) for k in diffs[0]}


def stages_both(asset, state, diff=None, wind=None):
    """The pipeline's stages in both packages on the same states (float64,
    CPU): a dict name -> (port tensor, JAX array) with the contacts, the
    passive and actuator forces, the position- and velocity-stage sensors,
    the constraint rows, and one ``engine.step``; and the row kinds of both
    (``"kind"``).  ``state`` holds (n, ...) arrays qpos, qvel, ctrl and
    optionally act and qacc_warmstart; ``diff`` per-environment model
    overrides; ``wind`` replaces ``opt.wind`` on both sides.  The JAX
    model is the checked-in asset (``jax_model_from_asset``: the JAX
    compiler's output, held to a fresh export by each asset's
    ``test_checked_in_asset_equals_a_fresh_export``), not a fresh MJCF
    compile, which takes 6-17 s a model on a CPU."""
    import jax
    import jax.numpy as jnp

    from dm_control_tpu.physics import constraints as jcons
    from dm_control_tpu.physics import engine as jengine
    from dm_control_tpu.physics import sensors as jsens
    from dm_control_tpu.physics.model import make_data as jmake_data
    from dm_control_torch.physics import constraints as tcons
    from dm_control_torch.physics import engine as tengine
    from dm_control_torch.physics import sensors as tsens
    from dm_control_torch.physics.model import make_data
    from dm_control_torch.suite import base as tbase

    jm = jax_model_from_asset(asset)
    tm = tbase.load_model(asset, "cpu", torch.float64)
    if wind is not None:
        jm = jm.replace(opt=jm.opt.replace(wind=jnp.asarray(wind)))
        tm = tm.replace(opt=tm.opt.replace(wind=torch.as_tensor(wind)))
    diff = dict(diff or {})
    n = state["qpos"].shape[0]
    state = dict(state)
    state.setdefault("act", np.zeros((n, jm.na)))
    state.setdefault("qacc_warmstart", np.zeros((n, jm.nv)))
    kinds = {}

    def pick(make_constraint, sens, engine, m, d):
        pv = engine.fwd_velocity(m, engine.fwd_position(m, d))
        sv = sens.sensor_vel(m, sens.sensor_pos(m, pv))
        efc = make_constraint(m, pv)
        kinds[engine.__name__] = tuple(efc.kind)
        ac = engine.fwd_actuation(m, pv)
        st = engine.step(m, d)
        return dict(
            contact_dist=pv.contact.dist, contact_pos=pv.contact.pos,
            contact_frame=pv.contact.frame, qfrc_passive=pv.qfrc_passive,
            ten_length=pv.ten_length, sensordata_posvel=sv.sensordata,
            efc_J=efc.J, efc_aref=efc.aref, efc_D=efc.D, efc_R=efc.R,
            efc_pos=efc.pos,
            act_dot=ac.act_dot, actuator_force=ac.actuator_force,
            qfrc_actuator=ac.qfrc_actuator, step_qpos=st.qpos,
            step_qvel=st.qvel, step_act=st.act,
            step_qacc=st.qacc_warmstart, step_sensordata=st.sensordata,
            step_contact_force_vec=st.contact_force_vec,
            solver_niter=st.solver_niter)

    def jone(s, df):
        mm = jm.replace(**df)
        return pick(jcons.make_constraint, jsens, jengine, mm,
                    jmake_data(mm).replace(**s))

    jout = jax.jit(jax.vmap(jone))(
        {k: jnp.asarray(v) for k, v in state.items()},
        {k: jnp.asarray(v) for k, v in diff.items()})
    mm = tm.replace(**{k: torch.as_tensor(v) for k, v in diff.items()})
    tout = pick(tcons.make_constraint, tsens, tengine, mm,
                make_data(mm, n).replace(
                    **{k: torch.as_tensor(v) for k, v in state.items()}))
    out = {k: (tout[k], np.asarray(jout[k])) for k in tout}
    out["kind"] = (kinds[tengine.__name__], kinds[jengine.__name__])
    return mm, out


#: absolute tolerances of ``stages_both``'s entries, by prefix: one
#: function of the state 1e-12, constraint rows 1e-10, a whole step 1e-9
STAGE_ATOL = {"efc_": 1e-10, "step_": 1e-9}
#: relative tolerances instead: R is 1 / D, and 1e15 on a row without force
STAGE_RTOL = {"efc_R": 1e-10}


def assert_stages_close(out, skip=()):
    for name, (t, j) in out.items():
        if name in ("kind", "solver_niter") or name in skip:
            continue
        atol = next((a for p, a in STAGE_ATOL.items()
                     if name.startswith(p)), 1e-12)
        rtol = STAGE_RTOL.get(name, 0)
        assert tuple(t.shape) == j.shape, name
        np.testing.assert_allclose(t.numpy(), j, rtol=rtol,
                                   atol=0 if rtol else atol, err_msg=name)
    assert out["kind"][0] == out["kind"][1]
    np.testing.assert_array_equal(out["solver_niter"][0].numpy(),
                                  out["solver_niter"][1])
