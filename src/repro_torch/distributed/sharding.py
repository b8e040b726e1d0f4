"""Logical-axis sharding constraints for model internals.

Models call ``constrain(x, "nodes", None)`` with *logical* axis names, as
the JAX package's models do. With no rules installed, the only case on one
card and the only one the ported models meet, ``constrain`` returns its
input. Placing a tensor by installed rules (DTensor placement over a
``DeviceMesh``) is not ported yet (ROADMAP.md §1 item 14): under installed
rules ``constrain`` raises ``NotImplementedError`` instead of leaving the
tensor where it is.
"""
from __future__ import annotations

import contextlib
import threading

_state = threading.local()


def current_rules():
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def sharding_rules(rules: dict):
    prev = current_rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def constrain(x, *logical):
    """``x`` itself without installed rules; raises under installed rules."""
    if current_rules() is None:
        return x
    raise NotImplementedError(
        f"constrain{logical} under installed sharding rules: DTensor placement "
        "is not ported yet (ROADMAP.md §1 item 14)"
    )
