"""The one registry of every attribute the harness rebinds from outside the
program (``capture.py`` in every run, ``tracer.py`` in traced runs), undone
in reverse order when the window closes."""

from __future__ import annotations

from typing import Callable, List


class Hooks:
    def __init__(self):
        self._undo: List[Callable[[], None]] = []

    def set(self, owner, name: str, value):
        """Rebind `owner.name` (a module's, a class's or an object's) to
        `value`; an object's own attribute comes back, a method it took from
        its class is dropped again."""
        own = vars(owner)
        had, old = name in own, own.get(name)
        setattr(owner, name, value)
        self._undo.append(lambda: setattr(owner, name, old) if had else delattr(owner, name))

    def wrap(self, owner, name: str, make):
        """Rebind `owner.name` to `make(current value)`."""
        self.set(owner, name, make(getattr(owner, name)))

    def uninstall(self):
        while self._undo:
            self._undo.pop()()
