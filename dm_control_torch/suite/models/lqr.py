"""Model definition for the lqr domain (generated literal tree).

Physical parameters match the reference dm_control suite model
(reference: dm_control/suite/lqr.xml); visual-only elements are
omitted.  Generated by dm_control_tpu/suite/_modelgen.py (the JAX
package keeps the generator); the port holds a copy.
"""

# fmt: off
MODEL = \
('mujoco',
 {'model': 'LQR'},
 [('option', {'timestep': '.03'}, []),
  ('default',
   {},
   [('joint', {'type': 'slide', 'axis': '0 1 0'}, []),
    ('geom', {'type': 'sphere', 'size': '.1'}, []),
    ('site', {'size': '.01'}, []),
    ('tendon', {'width': '.02'}, [])]),
  ('option', {}, [('flag', {'constraint': 'disable'}, [])]),
  ('worldbody',
   {},
   [('camera',
     {'name': 'cam0',
      'pos': '-1.428 -0.311 0.856',
      'xyaxes': '0.099 -0.995 0.000 0.350 0.035 0.936'},
     []),
    ('camera',
     {'name': 'cam1',
      'pos': '1.787 2.452 4.331',
      'xyaxes': '-1 0 0 0 -0.868 0.497'},
     []),
    ('geom', {'name': 'floor', 'size': '4 1 .2', 'type': 'plane'}, []),
    ('geom',
     {'name': 'origin',
      'pos': '2 0 .05',
      'size': '2 .003 .05',
      'type': 'box'},
     [])])])
# fmt: on
