"""Composer on PyTorch: the batched path.

Counterpart of ``dm_control_tpu/composer/`` for what the batched tasks
need: the ``BatchableTask`` protocol and ``compile_task``
(``composer/batch.py``).  Composer's host path (``Environment``,
``Task``, ``Entity``, observables, variations, initializers) is not
ported yet (ROADMAP A5).
"""

from dm_control_torch.composer.batch import BatchableTask, compile_task

__all__ = ["BatchableTask", "compile_task"]
