"""Nested / multi-level checkpoint consistency (paper §2.5, Table 1, Fig. 3).

Restarting every nested level from its *latest* version can be inconsistent:
after the parent checkpoint CL1-v1 is written, the inner loop restarts from 0,
so the child's CL2-v30 (written during the *previous* outer iteration) must
not be read.  CRAFT solves this by *invalidating* all child checkpoints as
soon as the parent checkpoint is fully written — the ``subCP()`` relationship.

This module is the registry of those parent→child edges plus the invalidation
walk.  It is deliberately free of storage details: a "child" only needs an
``invalidate()`` method (``Checkpoint`` provides it).
"""
from __future__ import annotations

import threading
import weakref
from typing import List


class NestedRegistry:
    """Parent→children edges between checkpoints (weakly referenced)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._children: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    def link(self, parent, child) -> None:
        """Declare ``child`` nested inside ``parent`` (paper ``subCP()``)."""
        if parent is child:
            raise ValueError("a checkpoint cannot be its own sub-checkpoint")
        with self._lock:
            kids = self._children.setdefault(parent, weakref.WeakSet())
            # cycle guard: walking up from parent must never reach child
            if self._reaches(child, parent):
                raise ValueError(
                    f"subCP cycle: {getattr(child, 'name', child)!r} is already "
                    f"an ancestor of {getattr(parent, 'name', parent)!r}"
                )
            kids.add(child)

    def _reaches(self, src, dst) -> bool:
        stack = [src]
        seen = set()
        while stack:
            node = stack.pop()
            if node is dst:
                return True
            if id(node) in seen:
                continue
            seen.add(id(node))
            stack.extend(self._children.get(node, ()))
        return False

    def children(self, parent) -> List:
        with self._lock:
            return list(self._children.get(parent, ()))

    def invalidate_children(self, parent) -> None:
        """After ``parent`` published a version, wipe all descendants.

        Paper Table 1: once CL1-v1 exists, the stale CL2 versions from the
        previous outer iteration must never be restored.

        The walk completes even when one child's storage fails mid-wipe
        (first error re-raised afterwards): with elastic restores, peer node
        trees are live restore sources, so stopping early would leave a
        sibling's stale version reachable across a topology change.
        """
        stack = self.children(parent)
        seen = set()
        first_exc = None
        while stack:
            child = stack.pop()
            if id(child) in seen:
                continue
            seen.add(id(child))
            try:
                child.invalidate()
            except Exception as exc:
                if first_exc is None:
                    first_exc = exc
            stack.extend(self.children(child))
        if first_exc is not None:
            raise first_exc


#: process-global registry used by Checkpoint.sub_cp()
GLOBAL_REGISTRY = NestedRegistry()
