"""Test-session setup.

The container may not ship `hypothesis`; at the seed this made six test
modules fail at *collection*, killing the whole tier-1 run.  When the real
library is absent we install a tiny deterministic shim that supports the
subset used in this repo (`given`, `settings`, `st.integers`, `st.floats`,
`st.sampled_from`, `st.booleans`): each @given test is executed with a
fixed number of examples drawn from a seeded numpy Generator, so runs are
reproducible and the property tests still sweep a nontrivial input space.
"""
from __future__ import annotations

import sys
import types


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "fuzz: seeded-corpus fuzz/validation tests; corpus size scales "
        "with REPRO_FUZZ_SEEDS (default 30; benchmarks/run.py --full "
        "drives the 128-seed nightly tier)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device and nvcc; skips where there is none "
        "(on the card: python -m pytest -m cuda tests/test_torch_cuda.py)")


try:  # pragma: no cover - exercised only when hypothesis is installed
    import hypothesis  # noqa: F401
except ImportError:
    import numpy as np

    _MAX_EXAMPLES_CAP = 10  # keep the shimmed sweeps cheap

    class _Strategy:
        def __init__(self, draw):
            self._draw = draw

    def integers(min_value, max_value):
        return _Strategy(lambda rng: int(rng.integers(min_value,
                                                      max_value + 1)))

    def floats(min_value, max_value, **_kw):
        return _Strategy(lambda rng: float(rng.uniform(min_value, max_value)))

    def sampled_from(elements):
        seq = list(elements)
        return _Strategy(lambda rng: seq[int(rng.integers(0, len(seq)))])

    def booleans():
        return _Strategy(lambda rng: bool(rng.integers(0, 2)))

    def given(**strategies):
        def deco(fn):
            def wrapper(*args, **kwargs):
                n = min(getattr(wrapper, "_shim_max_examples", 10),
                        _MAX_EXAMPLES_CAP)
                rng = np.random.default_rng(0)
                for _ in range(n):
                    drawn = {k: s._draw(rng) for k, s in strategies.items()}
                    fn(*args, **kwargs, **drawn)
            # expose the signature minus the strategy kwargs so pytest does
            # not mistake them for fixtures
            import inspect
            sig = inspect.signature(fn)
            keep = [p for name, p in sig.parameters.items()
                    if name not in strategies]
            wrapper.__signature__ = sig.replace(parameters=keep)
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            wrapper._shim_given = True
            return wrapper
        return deco

    def settings(max_examples=10, **_kw):
        def deco(fn):
            fn._shim_max_examples = max_examples
            return fn
        return deco

    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = integers
    _st.floats = floats
    _st.sampled_from = sampled_from
    _st.booleans = booleans

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = given
    _hyp.settings = settings
    _hyp.strategies = _st
    _hyp.__is_shim__ = True

    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st
