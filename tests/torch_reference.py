"""Run the JAX package's own test files against the port.

Shared by ``test_torch_scalar_reference.py`` and
``test_torch_array_reference.py``.  A reference test file is read as text,
unedited: every import of ``kmers_tpu`` (the top level and its submodules,
module-level and function-local, in both ``import`` and ``from`` form) is
rewritten to ``kmers_tpu_torch``, ``ast`` checks that no import of the JAX
package is left, and the result runs in a module namespace of its own.
Its tests and fixtures are then exposed in the loading test module.

The port's entry points run on the card unless the caller asks for the
CPU (``device="cuda"`` defaults, the CLI's ``--device cuda``), where the
reference's run on JAX's default backend.  :func:`bind_cpu` sets those
defaults to ``"cpu"`` for the duration of one test and puts them back.
"""

import ast
import importlib
import inspect
import pkgutil
import re
import sys
import types
from contextlib import contextmanager
from pathlib import Path

HERE = Path(__file__).resolve().parent

# ``import kmers_tpu...`` / ``from kmers_tpu... import``, at any indentation
_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)kmers_tpu\b(?!_torch)", re.M)


def port_source(src: str) -> str:
    """``src`` with every import of the JAX package pointed at the port."""
    return _IMPORT.sub(r"\1kmers_tpu_torch", src)


def imported_modules(tree: ast.AST) -> list:
    """The module names that ``tree``'s import statements name."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.append(node.module)
    return out


def drop_declined(tree: ast.Module, declined) -> list:
    """Remove the names in ``declined`` from ``tree``'s module-level
    imports of the port; returns the names removed.  A test that uses one
    of them then fails with ``NameError`` and must be left out."""
    dropped, body = [], []
    for node in tree.body:
        if (
            isinstance(node, ast.ImportFrom)
            and (node.module or "").split(".")[0] == "kmers_tpu_torch"
        ):
            keep = [a for a in node.names if a.name not in declined]
            dropped += [a.name for a in node.names if a.name in declined]
            if not keep:
                continue
            node.names = keep
        body.append(node)
    tree.body = body
    return dropped


def load(name: str, package: str, declined=()) -> types.ModuleType:
    """Run the rewritten ``tests/<name>`` in a fresh module namespace
    ``<package>.<stem>``; its module-level imports of ``declined`` names
    are dropped (recorded as ``__declined__``)."""
    path = HERE / name
    src = port_source(path.read_text())
    tree = ast.parse(src, filename=str(path))
    left = [m for m in imported_modules(tree) if m.split(".")[0] == "kmers_tpu"]
    assert not left, f"{name} still imports {left}"
    dropped = drop_declined(tree, declined)
    mod = types.ModuleType(f"{package}.{path.stem}")
    mod.__file__ = str(path)
    mod.__declined__ = dropped
    exec(compile(tree, str(path), "exec"), mod.__dict__)
    return mod


def _is_fixture(obj) -> bool:
    return type(obj).__name__ == "FixtureFunctionDefinition" or hasattr(
        obj, "_pytestfixturefunction"
    )


def expose(name: str, mod: types.ModuleType, namespace: dict, left_out=()) -> list:
    """Copy the tests and fixtures of ``mod``, loaded from ``name``, into
    ``namespace`` under names prefixed with the file's stem (so names
    repeated across files do not clash); ``left_out`` holds ids
    ``file::test``, ``file::Class`` or ``file::Class::test`` to leave out.
    Returns the ids of the tests exposed (a class counts as one)."""
    tag = Path(name).stem[len("test_"):]
    out = []
    for attr, obj in vars(mod).items():
        if _is_fixture(obj):
            assert attr not in namespace, f"fixture {attr} of {name} clashes"
            namespace[attr] = obj
        elif attr.startswith("test_") and callable(obj):
            if f"{name}::{attr}" in left_out:
                continue
            namespace[f"test_{tag}__{attr[len('test_'):]}"] = obj
            out.append(f"{name}::{attr}")
        elif attr.startswith("Test") and isinstance(obj, type):
            if f"{name}::{attr}" in left_out:
                continue
            for method in list(vars(obj)):
                if f"{name}::{attr}::{method}" in left_out:
                    delattr(obj, method)  # the class is this namespace's own
            namespace[f"Test_{tag}__{attr[len('Test'):]}"] = obj
            out.append(f"{name}::{attr}")
    return out


# -- binding the CPU -------------------------------------------------------

_DEVICE_COMMANDS = ("count", "merge", "sketch", "dist", "sixframe", "bench")


def _port_functions():
    """Every function defined in the port, module-level and in classes."""
    import kmers_tpu_torch

    for info in pkgutil.walk_packages(kmers_tpu_torch.__path__, "kmers_tpu_torch."):
        importlib.import_module(info.name)
    importlib.import_module("kmers_tpu_torch.__main__")
    seen = set()
    for modname, module in list(sys.modules.items()):
        if modname.split(".")[0] != "kmers_tpu_torch":
            continue
        for obj in vars(module).values():
            members = vars(obj).values() if isinstance(obj, type) else (obj,)
            for fn in members:
                fn = getattr(fn, "__func__", fn)
                if (
                    inspect.isfunction(fn)
                    and fn.__module__.split(".")[0] == "kmers_tpu_torch"
                    and id(fn) not in seen
                ):
                    seen.add(id(fn))
                    yield fn


def cuda_defaults() -> list:
    """``(function, attribute)`` for each function of the port whose
    ``device`` parameter defaults to ``"cuda"``; ``attribute`` is
    ``__defaults__`` or ``__kwdefaults__``."""
    out = []
    for fn in _port_functions():
        param = inspect.signature(fn).parameters.get("device")
        if param is None or param.default != "cuda":
            continue
        kind = param.kind
        out.append((fn, "__kwdefaults__" if kind == param.KEYWORD_ONLY else "__defaults__"))
    return out


def _on_cpu(value, fn, attr):
    if attr == "__kwdefaults__":
        return {**value, "device": "cpu"}
    names = [
        p.name for p in inspect.signature(fn).parameters.values()
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
    ]
    i = names.index("device") - (len(names) - len(value))
    return value[:i] + ("cpu",) + value[i + 1:]


@contextmanager
def bind_cpu():
    """Within the block the port's ``device="cuda"`` defaults are
    ``"cpu"``, and its CLI's ``main`` adds ``--device cpu`` to a command
    that takes one; everything is put back after."""
    import kmers_tpu_torch.__main__ as cli

    saved = [(fn, attr, getattr(fn, attr)) for fn, attr in CUDA_DEFAULTS]
    main = cli.main

    def main_on_cpu(argv=None):
        argv = list(sys.argv[1:] if argv is None else argv)
        if argv and argv[0] in _DEVICE_COMMANDS and "--device" not in argv:
            argv += ["--device", "cpu"]
        return main(argv)

    try:
        for fn, attr, value in saved:
            setattr(fn, attr, _on_cpu(value, fn, attr))
        cli.main = main_on_cpu
        yield
    finally:
        for fn, attr, value in saved:
            setattr(fn, attr, value)
        cli.main = main


CUDA_DEFAULTS = cuda_defaults()
