"""Import this package under a former name.

`install(old)` makes `old` and every `old.x.y` the very module objects
`steganosaurus_jax` and `steganosaurus_jax.x.y` (one copy of each module,
its caches and its classes), and lets `python -m old.cli` run the CLI.
"""

import importlib
import importlib.abc
import importlib.util
import sys
import warnings

NEW = "steganosaurus_jax"


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Meta-path finder and loader that resolve `old.*` to `NEW.*`."""

    def __init__(self, old: str):
        self.old = old
        self._specs = {}

    def _target(self, fullname: str) -> str:
        return NEW + fullname[len(self.old):]

    def find_spec(self, fullname, path=None, target=None):
        if not fullname.startswith(self.old + "."):
            return None
        real = importlib.util.find_spec(self._target(fullname))
        if real is None:
            return None
        return importlib.util.spec_from_loader(
            fullname, self,
            is_package=real.submodule_search_locations is not None)

    def create_module(self, spec):
        module = importlib.import_module(self._target(spec.name))
        self._specs[spec.name] = module.__spec__
        return module

    def exec_module(self, module):
        # The import system stamped the alias spec on the shared module.
        module.__spec__ = self._specs.pop(module.__spec__.name)

    def get_code(self, fullname):  # for `python -m old.module`
        target = self._target(fullname)
        return importlib.util.find_spec(target).loader.get_code(target)


def install(old: str) -> None:
    """Make `old` an alias of this package; call from `old/__init__.py`."""
    import steganosaurus_jax

    warnings.warn(f"{old} is now {NEW}", DeprecationWarning, stacklevel=2)
    if not any(isinstance(f, _Alias) and f.old == old for f in sys.meta_path):
        sys.meta_path.insert(0, _Alias(old))
    sys.modules[old] = steganosaurus_jax
