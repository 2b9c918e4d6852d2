"""Hierarchical wall-time profiler.

Behavioral parity target: ProfilerType
(reference src/Utilities/Performance/Profiler.f90:14-66): named nested
sections with stable handles, SUMMARY/DETAIL report printed as an indented
tree plus the top-3 hotspots.  Device work is asynchronous under JAX, so
``section(..., block=True)`` inserts a ``block_until_ready`` barrier to
attribute device time correctly (the asynchronous-device analog of the
reference's synchronous CPU timing).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class _Section:
    title: str
    total: float = 0.0
    count: int = 0
    children: dict = field(default_factory=dict)


class Profiler:
    """Nested named sections; thread of execution defines the hierarchy."""

    def __init__(self):
        self.root = _Section("run")
        self._stack = [self.root]

    @contextmanager
    def section(self, title: str, block_on=None):
        parent = self._stack[-1]
        node = parent.children.get(title)
        if node is None:
            node = parent.children[title] = _Section(title)
        self._stack.append(node)
        t0 = time.perf_counter()
        try:
            yield node
        finally:
            if block_on is not None:
                import jax
                jax.block_until_ready(block_on)
            node.total += time.perf_counter() - t0
            node.count += 1
            self._stack.pop()

    def start(self, title: str):
        """Imperative start/stop pair (reference's handle-based API)."""
        cm = self.section(title)
        cm.__enter__()
        return cm

    @staticmethod
    def stop(handle):
        handle.__exit__(None, None, None)

    # ------------------------------------------------------------- report

    def _walk(self, node, depth=0):
        for child in node.children.values():
            yield depth, child
            yield from self._walk(child, depth + 1)

    def report(self, mode: str = "summary") -> str:
        """Indented tree of section timings + top-3 hotspots
        (Profiler.f90 print at finalize)."""
        lines = ["Profiler timings (seconds):"]
        flat = []
        for depth, sec in self._walk(self.root):
            lines.append(f"  {'  ' * depth}{sec.title:<40.40s} "
                         f"{sec.total:12.6f}  (n={sec.count})")
            flat.append(sec)
        if mode.lower() == "detail":
            pass  # all sections already listed
        top = sorted(flat, key=lambda s: -s.total)[:3]
        lines.append("Top hotspots:")
        for s in top:
            lines.append(f"  {s.title:<40.40s} {s.total:12.6f}")
        return "\n".join(lines)


# module-level profiler mirroring the reference's global g_prof
g_prof = Profiler()
