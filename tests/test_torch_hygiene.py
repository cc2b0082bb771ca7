"""The port stands alone: no module of ``repro_torch``, not
``chip_smoke.py`` and no script of ``tools/`` imports jax or the
reference package, the package
imports with jax made unimportable, and entry points that allocate
default to the card and raise without one instead of falling back."""
import ast
import os
import subprocess
import sys

import pytest
import torch
from tests.torch_dist import one_cpu_thread

one_cpu_thread()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    tools = os.path.join(ROOT, "tools")
    files += [os.path.join(tools, n) for n in os.listdir(tools)
              if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    bad = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {sorted(bad)}"


def test_imports_with_jax_unimportable():
    mods = sorted(
        os.path.relpath(os.path.join(d, n), os.path.join(ROOT, "src"))
        [:-3].replace(os.sep, ".").removesuffix(".__init__")
        for d, _, names in os.walk(PKG) for n in names if n.endswith(".py"))
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\nsys.modules['repro'] = None\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            "assert 'jax' not in {k for k, v in sys.modules.items() if v}\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")


def test_entry_points_default_to_the_card(no_cuda):
    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch import serve
    from repro_torch.comm.blockpool import BlockArena
    from repro_torch.models import init_decode_states, init_params
    cfg = reduced(get_config("phi3-mini-3.8b"))
    calls = [
        lambda: init_params(cfg, torch.Generator()),
        lambda: init_decode_states(cfg, 1, 8),
        lambda: params_from_numpy({"w": np.zeros(2, np.float32)}),
        lambda: serve.serve(cfg),
        lambda: serve.main(["--arch", "phi3-mini-3.8b", "--reduced"]),
        lambda: serve.serve(cfg, kv_cache="qlc", kv_paging="async"),
        lambda: BlockArena(2, 8),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _device_params():
    """(name, default) of the ``device`` parameter of every public
    function, and public class's constructor and methods, in
    ``repro_torch.comm.container``, ``repro_torch.serving`` and
    ``repro_torch.launch`` (their submodules included)."""
    import importlib
    import inspect
    import pkgutil
    import repro_torch.launch
    import repro_torch.serving
    mods = [importlib.import_module("repro_torch.comm.container")]
    for pkg in (repro_torch.serving, repro_torch.launch):
        mods.append(pkg)
        mods += [importlib.import_module(f"{pkg.__name__}.{m.name}")
                 for m in pkgutil.iter_modules(pkg.__path__)]
    out = {}
    for mod in mods:
        for name, obj in vars(mod).items():
            if name.startswith("_"):
                continue
            fns = [(name, obj)] if inspect.isfunction(obj) else [
                (f"{name}.{n}", f) for n, f in vars(obj).items()
                if inspect.isfunction(f)
                and (n == "__init__" or not n.startswith("_"))
            ] if inspect.isclass(obj) else []
            for fname, fn in fns:
                p = inspect.signature(fn).parameters.get("device")
                if p is not None:
                    out[f"{fn.__module__}.{fname}"] = p.default
    return out


def test_device_parameters_default_to_the_card():
    """No entry point of the container, serving or launch modules
    defaults its ``device`` to the CPU: the port runs on the card unless
    the caller asks for the CPU."""
    params = _device_params()
    assert "repro_torch.comm.container.unpack_payload" in params
    cpu = {k: v for k, v in params.items() if str(v) == "cpu"}
    assert not cpu, cpu
