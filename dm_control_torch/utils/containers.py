"""Tagged task registry (reference: dm_control/utils/containers.py:25).

``TaggedTasks`` maps task names to factory functions, with optional tags
('benchmarking', 'easy', ...) for grouping: each suite domain registers
its tasks with the ``@TASKS.add(...)`` decorator."""

from __future__ import annotations

import collections
from typing import Callable, Dict, Iterator, List, Tuple


class TaggedTasks(collections.abc.Mapping):
    """An ordered name -> factory mapping with tag-based views."""

    def __init__(self, allow_overriding_keys: bool = False):
        self._tasks: "collections.OrderedDict[str, Callable]" = (
            collections.OrderedDict())
        self._tags: Dict[str, List[str]] = collections.defaultdict(list)
        self.allow_overriding_keys = allow_overriding_keys

    def add(self, *tags: str):
        """Decorator registering a factory under its function name."""

        def wrap(factory):
            name = factory.__name__
            if name in self._tasks and not self.allow_overriding_keys:
                raise ValueError(
                    f"Task {name!r} already registered. Set "
                    f"allow_overriding_keys=True to allow overriding.")
            self._tasks[name] = factory
            for tag in tags:
                self._tags[tag].append(name)
            return factory

        return wrap

    def tagged(self, *tags: str) -> Dict[str, Callable]:
        """Tasks carrying all of the given tags."""
        if not tags:
            return dict(self._tasks)
        names = set(self._tags[tags[0]])
        for t in tags[1:]:
            names &= set(self._tags[t])
        return {n: self._tasks[n] for n in self._tasks if n in names}

    def tags(self) -> Tuple[str, ...]:
        return tuple(self._tags)

    def __getitem__(self, k: str) -> Callable:
        return self._tasks[k]

    def __iter__(self) -> Iterator[str]:
        return iter(self._tasks)

    def __len__(self) -> int:
        return len(self._tasks)

    def __repr__(self):
        return f"TaggedTasks({list(self._tasks)})"
