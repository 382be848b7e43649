"""The port's public APIs stay documented to the reference's bar.

For ``repro_torch.tuner``, ``fleet``, ``tunebench``, ``transfer``,
``sandbox``, ``prof`` and ``serve``: every name in ``__all__`` resolves,
every name the reference's package exports is exported by the port's
too, and every exported class or function carries a paragraph docstring,
with a usage example where the reference asks its own package for one.
"""

from __future__ import annotations

import importlib
import inspect

import pytest

#: package -> whether its exports need a usage example (the reference's
#: ``tests/test_docstrings.py`` asks the same of its packages).
MODULES = {"tuner": True, "fleet": True, "tunebench": False,
           "transfer": False, "sandbox": True, "prof": True, "serve": False}


def exported(module):
    for name in module.__all__:
        yield name, getattr(module, name)   # AttributeError = broken export


@pytest.mark.parametrize("name", sorted(MODULES))
def test_all_exports_resolve_and_cover_the_references(name):
    port = importlib.import_module(f"repro_torch.{name}")
    ref = importlib.import_module(f"repro.{name}")
    names = [n for n, _ in exported(port)]
    assert names == list(port.__all__)
    assert len(set(names)) == len(names), "duplicate names in __all__"
    missing = sorted(set(ref.__all__) - set(names))
    assert not missing, f"repro_torch.{name} lacks the reference's {missing}"


@pytest.mark.parametrize("name", sorted(MODULES))
def test_exported_callables_have_paragraph_docstrings(name):
    module = importlib.import_module(f"repro_torch.{name}")
    missing, thin, unexemplified = [], [], []
    for export, obj in exported(module):
        if not (inspect.isclass(obj) or inspect.isfunction(obj)):
            continue        # constants and registries are documented in-module
        doc = inspect.getdoc(obj)
        if not doc:
            missing.append(export)
        elif len(doc) < 60:
            thin.append(export)
        elif MODULES[name] and "example" not in doc.lower() \
                and ">>>" not in doc:
            unexemplified.append(export)
    assert not missing, f"{name}: exports without docstrings: {missing}"
    assert not thin, f"{name}: one-line docstrings: {thin}"
    assert not unexemplified, f"{name}: no usage example: {unexemplified}"
