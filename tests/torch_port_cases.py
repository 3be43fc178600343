"""Run a JAX-package test module's cases against the port's copy.

``load_cases`` executes a copy of ``tests/<file>`` whose imports of the
JAX package name the port's package instead (``selkies_tpu.`` becomes
``selkies_tpu_torch.``; ``replace`` adds more rewrites), so the same case
bodies exercise the port's modules. The JAX module itself is imported as
it is. ``run_case`` calls a case with the fixtures it names.
"""

import importlib
import inspect
import pathlib
import sys
import types

TESTS = pathlib.Path(__file__).resolve().parent


def load_cases(test_file: str, port: bool, replace=()):
    name = test_file[:-3]
    if not port:
        if str(TESTS) not in sys.path:
            sys.path.insert(0, str(TESTS))
        return importlib.import_module(name)
    src = (TESTS / test_file).read_text()
    for a, b in replace:
        src = src.replace(a, b)
    src = src.replace("from selkies_tpu.", "from selkies_tpu_torch.") \
        .replace("import selkies_tpu.", "import selkies_tpu_torch.")
    mod = types.ModuleType(f"_port_cases_{name}")
    mod.__file__ = str(TESTS / test_file)
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    return mod


def case_names(mod, only=None):
    names = sorted(n for n in vars(mod) if n.startswith("test_")
                   and callable(getattr(mod, n)))
    return [n for n in names if only is None or n in only]


def run_case(mod, name: str, fixtures: dict):
    fn = getattr(mod, name)
    params = inspect.signature(fn).parameters
    return fn(**{p: fixtures[p] for p in params})
