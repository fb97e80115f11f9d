"""Tunes Duplo stud radii so separation forces hit desired targets
(counterpart of ``dm_control_tpu/entities/props/duplo/autotune.py``;
reference: dm_control/entities/props/duplo/autotune.py:33-160).

The separation force grows with the stud radius (more interference
against the tubes/walls of the brick above), so for each (easy_align,
flanges) variant three scalar root-finding problems are solved -- the
radii whose separation forces equal the desired minimum, lower quartile
and maximum -- by bisection over a radius bracket.  The results are what
``_STUD_SIZE_PARAMS`` in ``__init__.py`` stores.  Every force is measured
on ``device`` (the card unless the caller asks for another).

Run: python -m dm_control_torch.entities.props.duplo.autotune [--device=cpu]
"""

from __future__ import annotations

import argparse
import pprint

import torch

from dm_control_torch.entities.props import duplo
from dm_control_torch.entities.props.duplo import utils

#: target separation forces (N), matching the empirical distribution
#: measured for real Duplo bricks (reference autotune.py:33)
DESIRED_FORCES = duplo._StudSize(
    minimum=6.0, lower_quartile=10.0, maximum=18.0)

#: the force is not perfectly monotonic in the radius; shrink the
#: desired range slightly so sampled radii stay in bounds
SAFETY_MARGIN = 0.2

_RADIUS_BRACKET = (0.0044, 0.0051)


def get_separation_force_for_radius(radius, *, device=None,
                                    dtype=torch.float64, **duplo_kwargs):
    """Separation force (N) of two bricks built with this stud radius."""
    top = duplo.Duplo(**duplo_kwargs)
    bottom = duplo.Duplo(**duplo_kwargs)
    # set both so the (tiny) stud-mass effect on the top brick is kept
    top.set_stud_radius(radius)
    bottom.set_stud_radius(radius)
    return utils.measure_separation_force(top, bottom, device=device,
                                          dtype=dtype)


def tune_stud_radius(desired_force, radius_tolerance=2e-6,
                     bracket=_RADIUS_BRACKET, **kwargs):
    """Bisects for the stud radius giving ``desired_force`` (N); the other
    keywords go to ``get_separation_force_for_radius``."""
    lo, hi = bracket
    f_lo = get_separation_force_for_radius(lo, **kwargs)
    f_hi = get_separation_force_for_radius(hi, **kwargs)
    if not f_lo < desired_force < f_hi:
        raise ValueError(
            f"desired force {desired_force} N outside the bracket's "
            f"range [{f_lo:.2f}, {f_hi:.2f}] N")
    while hi - lo > radius_tolerance:
        mid = 0.5 * (lo + hi)
        if get_separation_force_for_radius(mid, **kwargs) < desired_force:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def tune_all_variants(desired_forces=DESIRED_FORCES,
                      safety_margin=SAFETY_MARGIN, **kwargs):
    """Retunes ``_STUD_SIZE_PARAMS`` for every brick variant; the other
    keywords (``device``, ``dtype``) go to ``tune_stud_radius``."""
    span = desired_forces.maximum - desired_forces.minimum
    targets = duplo._StudSize(
        minimum=desired_forces.minimum + safety_margin * span,
        lower_quartile=desired_forces.lower_quartile,
        maximum=desired_forces.maximum - safety_margin * span)
    out = {}
    for params in duplo._STUD_SIZE_PARAMS:
        out[params] = duplo._StudSize(*(
            tune_stud_radius(f, easy_align=params.easy_align,
                             flanges=params.flanges, **kwargs)
            for f in targets))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    pprint.pprint(tune_all_variants(device=args.device))


if __name__ == "__main__":
    main()
