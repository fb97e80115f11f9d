"""Scaled position and velocity actuators (counterpart of
``dm_control_tpu/locomotion/walkers/scaled_actuators.py``; reference:
dm_control/locomotion/walkers/scaled_actuators.py:37,84).

Each adds a ``<general>`` actuator whose affine gain and bias map a
normalized ctrlrange onto a qpos or qvel range:

  position: gain g0 = kp * slope, bias (b0, -kp, 0)
  velocity: gain g0 = kv * slope, bias (b0, 0, -kv)

with slope = (target range span) / (ctrlrange span) and
b0 = k * (target_lo - slope * ctrl_lo), written with ``%g`` as the JAX
package writes them.  The CMU humanoid's position actuators
(``cmu_humanoid.py``) map the same way but keep 17 digits, as the JAX
package's humanoid does, so their trees match the JAX compiler's.
"""

from __future__ import annotations


def _fmt(v):
    return " ".join(f"{x:g}" for x in v)


def _actuator_section(target):
    root = target
    while root.parent is not None:
        root = root.parent
    act = root.first("actuator")
    if act is None:
        act = root.add("actuator")
    return act


def add_position_actuator(target, qposrange, ctrlrange=(-1, 1), kp=1.0,
                          **kwargs):
    """Adds a scaled position `<general>` actuator driving ``target``
    (a joint/tendon element)."""
    slope = (qposrange[1] - qposrange[0]) / (ctrlrange[1] - ctrlrange[0])
    g0 = kp * slope
    b0 = kp * (qposrange[0] - slope * ctrlrange[0])
    act = _actuator_section(target)
    return act.add("general", biastype="affine",
                   gainprm=f"{g0:g}",
                   biasprm=_fmt([b0, -kp, 0.0]),
                   ctrllimited="true",
                   ctrlrange=_fmt(ctrlrange),
                   **{target.tag if target.tag != "fixed" else "tendon":
                      target.get("name"), **kwargs})


def add_velocity_actuator(target, qvelrange, ctrlrange=(-1, 1), kv=1.0,
                          **kwargs):
    """Adds a scaled velocity `<general>` actuator driving ``target``."""
    slope = (qvelrange[1] - qvelrange[0]) / (ctrlrange[1] - ctrlrange[0])
    g0 = kv * slope
    b0 = kv * (qvelrange[0] - slope * ctrlrange[0])
    act = _actuator_section(target)
    return act.add("general", biastype="affine",
                   gainprm=f"{g0:g}",
                   biasprm=_fmt([b0, 0.0, -kv]),
                   ctrllimited="true",
                   ctrlrange=_fmt(ctrlrange),
                   **{target.tag if target.tag != "fixed" else "tendon":
                      target.get("name"), **kwargs})
