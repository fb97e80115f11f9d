"""Entities of the composer tasks, as the batched path reads them.

Counterpart of ``dm_control_tpu/entities/``: each class carries the names
(of joints, sites, its own attachment prefix) that the batched task hooks
look up in a compiled model.  Building an entity's MJCF tree, for the
port's compiler, waits for the entity model builders (ROADMAP A9b); the
models come compiled (``composer/batch.py``).
"""
