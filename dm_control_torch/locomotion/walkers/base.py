"""The walker interface, as names (counterpart of
``dm_control_tpu/locomotion/walkers/base.py``).

A walker attached to an arena prefixes every name of its model with its
own (``walker/lfemur``); the tasks look the names up in the compiled
model.  Building a walker's MJCF, its observables and its egocentric
transforms on the host wait for composer's host path (ROADMAP A5).
"""

from __future__ import annotations


class Walker:
    """A locomoting entity named ``name``, with a root body."""

    def __init__(self, name):
        self.name = name

    @property
    def root_body_name(self) -> str:
        """The root body's name in the walker's own model."""
        raise NotImplementedError

    @property
    def observable_joint_names(self):
        """The joints exposed as proprioception, in order."""
        return ()

    @property
    def end_effector_body_names(self):
        return ()
