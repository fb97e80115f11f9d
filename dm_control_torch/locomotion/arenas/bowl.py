"""Bowl arena with heightfield terrain
(reference: dm_control/locomotion/arenas/bowl.py).

As in the JAX package, nothing installs the terrain ``regenerate``
computes: the compiled height field stays at zero, as the compiler
fills it (upstream dm_control draws a bowl every episode).

Counterpart of ``dm_control_tpu/locomotion/arenas/bowl.py``.
"""

from __future__ import annotations

import numpy as np

from dm_control_torch.composer.arena import Arena


class Bowl(Arena):
    """A bumpy bowl heightfield (the quadruped-escape arena shape)."""

    def _build(self, size=(10, 10), name="bowl", res=64):
        super()._build(name=name)
        self._hfield_res = res
        asset = self._mjcf_root.add("asset")
        asset.add("hfield", name="terrain", nrow=str(res), ncol=str(res),
                  size=f"{size[0]} {size[1]} 0.5 0.1")
        wb = self._mjcf_root.first("worldbody")
        self._terrain_geom = wb.add("geom", name="terrain", type="hfield",
                                    hfield="terrain", pos="0 0 -0.01")
        wb.add("geom", name="ground", type="plane",
               size=f"{size[0]} {size[1]} 0.25")

    def regenerate(self, random_state):
        """Returns a fresh (res, res) normalized terrain array to install
        as a model 'hfield_data' override (bowl + smoothed bumps)."""
        res = self._hfield_res
        row, col = np.ogrid[-1:1:res * 1j, -1:1:res * 1j]
        radius = np.clip(np.sqrt(col ** 2 + row ** 2), 0.04, 1)
        bowl_shape = 0.5 - np.cos(2 * np.pi * radius) / 2
        bumps = random_state.uniform(0.15, 1, (res // 8, res // 8))
        from scipy import ndimage

        smooth = ndimage.zoom(bumps, res / float(res // 8))
        return bowl_shape * smooth
