"""Entities of the composer tasks, as the batched path reads them.

Counterpart of ``dm_control_tpu/entities/``: each class carries the names
(of joints, sites, its own attachment prefix) that the batched task hooks
look up in a compiled model.  Building an entity's MJCF waits for the
port's compiler (ROADMAP A9); the models come compiled
(``composer/batch.py``).
"""
