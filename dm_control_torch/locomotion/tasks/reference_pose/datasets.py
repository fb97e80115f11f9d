"""Clip-dataset registry (counterpart of
``dm_control_tpu/locomotion/tasks/reference_pose/datasets.py``;
reference: dm_control/locomotion/tasks/reference_pose/datasets.py).

``DATASETS`` maps subset names to ``ClipCollection``s of CMU clip ids
(``cmu_subsets``); more named subsets can be registered at run time.
"""

from __future__ import annotations

from typing import Dict, Sequence

from dm_control_torch.locomotion.mocap.types import ClipCollection
from dm_control_torch.locomotion.tasks.reference_pose import cmu_subsets

DATASETS: Dict[str, ClipCollection] = dict(cmu_subsets.CMU_SUBSETS_DICT)


def register_subset(name: str, ids: Sequence[str]) -> None:
    """Registers a named subset as a list of clip ids."""
    DATASETS[name] = ClipCollection(ids=tuple(ids))


def get_dataset(name: str, loader=None) -> ClipCollection:
    """The collection registered as ``name``; with ``loader``, only its
    clips that the loader has.  KeyError for a name not registered;
    ValueError where the loader has none of the collection's clips."""
    try:
        collection = DATASETS[name]
    except KeyError:
        raise KeyError(f"Unknown dataset {name!r}; registered: "
                       f"{sorted(DATASETS)}") from None
    if loader is None:
        return collection
    have = set(loader.keys())
    ids = tuple(cid for cid in collection.ids if cid in have)
    if not ids:
        raise ValueError(
            f"Dataset {name!r} shares no clip ids with the loader "
            f"(registry ids like {collection.ids[:2]}, loader keys like "
            f"{sorted(have)[:2]}).")
    return ClipCollection(ids=ids)


def available(loader) -> ClipCollection:
    """Every clip a loader has, as a collection (for banks whose keys are
    not CMU ids)."""
    return ClipCollection(ids=tuple(loader.keys()))


def names() -> Sequence[str]:
    return sorted(DATASETS)
