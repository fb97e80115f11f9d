"""Resource IO: the port's copy of ``dm_control_tpu/utils/io.py``
(reference: dm_control/utils/io.py:21)."""

from __future__ import annotations


def GetResource(name, mode="rb"):  # noqa: N802 (reference API name)
    with open(name, mode=mode) as f:
        return f.read()


def GetResourceFilename(name, mode="rb"):  # noqa: N802
    del mode
    return name
