"""Minimal, dependency-free stand-in for the `hypothesis` API the tests use:
the port's own copy of the JAX package's ``repro.testing.minihyp``.

The real `hypothesis` is declared in requirements.txt; this shim is for
hermetic environments without it, so a property-test suite still *runs*
instead of dying at collection with ModuleNotFoundError. It implements the
small subset the tests use — ``given``, ``settings``, ``assume`` and the
strategies ``integers / floats / booleans / sampled_from / tuples / lists
/ builds / just / data`` — with deterministic seeding (derived from the
test's qualified name and the example index: the same draws as the JAX
package's shim) but no shrinking and no failure database.

Activated where ``hypothesis`` is missing::

    try:
        import hypothesis
    except ModuleNotFoundError:
        from repro_torch.testing import minihyp
        minihyp.install()
"""
from __future__ import annotations

import sys
import types
import zlib

import numpy as np

_DEFAULT_MAX_EXAMPLES = 50


class _Falsified(AssertionError):
    pass


class _Rejected(Exception):
    """Raised by assume(False); the example is skipped, not failed."""


def assume(condition) -> bool:
    if not condition:
        raise _Rejected()
    return True


class SearchStrategy:
    """A strategy = a sampling function rng -> value."""

    def __init__(self, sample):
        self._sample = sample

    def map(self, fn) -> "SearchStrategy":
        return SearchStrategy(lambda rng: fn(self._sample(rng)))

    def filter(self, pred) -> "SearchStrategy":
        def sample(rng):
            for _ in range(100):
                v = self._sample(rng)
                if pred(v):
                    return v
            raise _Rejected()

        return SearchStrategy(sample)


def integers(min_value, max_value) -> SearchStrategy:
    return SearchStrategy(lambda rng: int(rng.integers(min_value, max_value + 1)))


def floats(min_value, max_value, **_kw) -> SearchStrategy:
    return SearchStrategy(lambda rng: float(rng.uniform(min_value, max_value)))


def booleans() -> SearchStrategy:
    return SearchStrategy(lambda rng: bool(rng.integers(0, 2)))


def sampled_from(elements) -> SearchStrategy:
    seq = list(elements)
    return SearchStrategy(lambda rng: seq[int(rng.integers(len(seq)))])


def tuples(*strategies) -> SearchStrategy:
    return SearchStrategy(lambda rng: tuple(s._sample(rng) for s in strategies))


def lists(elements, min_size=0, max_size=10) -> SearchStrategy:
    def sample(rng):
        k = int(rng.integers(min_size, max_size + 1))
        return [elements._sample(rng) for _ in range(k)]

    return SearchStrategy(sample)


def builds(target, *strategies, **kw_strategies) -> SearchStrategy:
    return SearchStrategy(
        lambda rng: target(
            *(s._sample(rng) for s in strategies),
            **{k: s._sample(rng) for k, s in kw_strategies.items()},
        )
    )


def just(value) -> SearchStrategy:
    return SearchStrategy(lambda rng: value)


class DataObject:
    """Interactive draw handle, the result of drawing ``data()``."""

    def __init__(self, rng):
        self._rng = rng

    def draw(self, strategy, label=None):
        return strategy._sample(self._rng)


def data() -> SearchStrategy:
    return SearchStrategy(lambda rng: DataObject(rng))


def settings(max_examples=_DEFAULT_MAX_EXAMPLES, deadline=None, **_kw):
    def decorate(fn):
        fn._minihyp_settings = dict(max_examples=max_examples)
        return fn

    return decorate


class HealthCheck:
    # accepted (and ignored) for API compatibility
    too_slow = data_too_large = filter_too_much = all = None


def given(*strategies, **kw_strategies):
    """Run the test over deterministic pseudo-random examples.

    The wrapper takes no parameters so pytest does not mistake the
    strategy-supplied arguments for fixtures (real hypothesis hides them
    the same way via its own integration).
    """

    def decorate(fn):
        conf = getattr(fn, "_minihyp_settings", None) or {}
        n_examples = conf.get("max_examples", _DEFAULT_MAX_EXAMPLES)
        base_seed = zlib.crc32(fn.__qualname__.encode())

        def wrapper():
            for i in range(n_examples):
                rng = np.random.default_rng((base_seed, i))
                try:
                    args = [s._sample(rng) for s in strategies]
                    kwargs = {k: s._sample(rng) for k, s in kw_strategies.items()}
                    fn(*args, **kwargs)
                except _Rejected:
                    continue
                except Exception as e:
                    raise _Falsified(
                        f"{fn.__qualname__} falsified on example {i} "
                        f"(minihyp seed ({base_seed}, {i})): {e!r}"
                    ) from e

        wrapper.__name__ = fn.__name__
        wrapper.__qualname__ = fn.__qualname__
        wrapper.__doc__ = fn.__doc__
        wrapper.__module__ = fn.__module__
        wrapper._minihyp_inner = fn
        return wrapper

    return decorate


def install() -> None:
    """Register this shim as ``hypothesis`` / ``hypothesis.strategies``."""
    if "hypothesis" in sys.modules:
        return
    hyp = types.ModuleType("hypothesis")
    st = types.ModuleType("hypothesis.strategies")
    for name in (
        "SearchStrategy", "integers", "floats", "booleans", "sampled_from",
        "tuples", "lists", "builds", "just", "data",
    ):
        setattr(st, name, globals()[name])
    hyp.strategies = st
    hyp.given = given
    hyp.settings = settings
    hyp.assume = assume
    hyp.HealthCheck = HealthCheck
    hyp.__version__ = "0.0-minihyp"
    sys.modules["hypothesis"] = hyp
    sys.modules["hypothesis.strategies"] = st
