"""Lazy re-exports for the port's subpackages.

Each subpackage's ``__init__`` names the JAX package's public names
(its ``__all__``), but imports the module that defines one only when the
name is first read. An eager import would tie the subpackages in a cycle
(``utils.checkpoint`` needs ``train``, and every layer needs
``utils.device``), and ``import simclr_tpu_torch.<sub>.<module>`` stays as
cheap as the module itself.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Sequence


def lazy_exports(namespace: dict, exports: Dict[str, Sequence[str]]
                 ) -> List[str]:
    """Give the package whose globals are ``namespace`` the names of
    ``exports`` (submodule -> names it defines), each imported on first
    access (PEP 562), and return them in order as its ``__all__``.

    A name that is also its submodule's name (``train.pretrain``) is the
    submodule, whether or not it was imported before: the port's modules
    import it as ``from simclr_tpu_torch.train import pretrain``, which
    must not turn into the function when the module is not loaded yet."""
    package = namespace["__name__"]
    where = {name: module for module, names in exports.items()
             for name in names}

    def __getattr__(name):
        module = where.get(name)
        if module is None:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}")
        value = importlib.import_module(f"{package}.{module}")
        if name != module:
            value = getattr(value, name)
        namespace[name] = value
        return value

    def __dir__():
        return sorted(set(namespace) | set(where))

    namespace["__getattr__"] = __getattr__
    namespace["__dir__"] = __dir__
    return list(where)
