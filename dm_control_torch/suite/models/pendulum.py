"""Model definition for the pendulum domain (generated literal tree).

Physical parameters match the reference dm_control suite model
(reference: dm_control/suite/pendulum.xml); visual-only elements are
omitted.  Generated by dm_control_tpu/suite/_modelgen.py (the JAX
package keeps the generator); the port holds a copy.
"""

# fmt: off
MODEL = \
('mujoco',
 {'model': 'pendulum'},
 [('option',
   {'timestep': '0.02'},
   [('flag', {'contact': 'disable', 'energy': 'enable'}, [])]),
  ('worldbody',
   {},
   [('geom', {'name': 'floor', 'size': '2 2 .2', 'type': 'plane'}, []),
    ('camera',
     {'name': 'fixed', 'pos': '0 -1.5 2', 'xyaxes': '1 0 0 0 1 1'},
     []),
    ('camera',
     {'name': 'lookat',
      'mode': 'targetbodycom',
      'target': 'pole',
      'pos': '0 -2 1'},
     []),
    ('body',
     {'name': 'pole', 'pos': '0 0 .6'},
     [('joint',
       {'name': 'hinge', 'type': 'hinge', 'axis': '0 1 0', 'damping': '0.1'},
       []),
      ('geom',
       {'name': 'base',
        'type': 'cylinder',
        'fromto': '0 -.03 0 0 .03 0',
        'size': '0.021',
        'mass': '0'},
       []),
      ('geom',
       {'name': 'pole',
        'type': 'capsule',
        'fromto': '0 0 0 0 0 0.5',
        'size': '0.02',
        'mass': '0'},
       []),
      ('geom',
       {'name': 'mass',
        'type': 'sphere',
        'pos': '0 0 0.5',
        'size': '0.05',
        'mass': '1'},
       [])])]),
  ('actuator',
   {},
   [('motor',
     {'name': 'torque',
      'joint': 'hinge',
      'gear': '1',
      'ctrlrange': '-1 1',
      'ctrllimited': 'true'},
     [])])])
# fmt: on
