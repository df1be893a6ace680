"""The package's former name, kept as an alias of :mod:`spec_viterbi`.

Importing it, or any of its submodules, gives the very module objects of
``spec_viterbi`` (one class per type, whichever name imported it) and
warns once. New code imports ``spec_viterbi``.
"""

import importlib
import importlib.abc
import importlib.util
import sys
import warnings

import spec_viterbi

_OLD = __name__
_NEW = spec_viterbi.__name__


class _AliasLoader(importlib.abc.Loader):
    def create_module(self, spec):
        return importlib.import_module(_NEW + spec.name[len(_OLD) :])

    def exec_module(self, module):
        pass


class _AliasFinder(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.startswith(_OLD + "."):
            return importlib.util.spec_from_loader(name, _AliasLoader())
        return None


warnings.warn(
    f"{_OLD} is the former name of {_NEW}; import {_NEW} instead",
    DeprecationWarning,
    stacklevel=2,
)
sys.meta_path.insert(0, _AliasFinder())
sys.modules[_OLD] = spec_viterbi
