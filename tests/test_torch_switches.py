"""A census of every switch ``cmix_tpu`` reads, and where the port reads it.

Every environment variable the JAX package reads (an ``os.environ`` or
``os.getenv`` read anywhere in ``cmix_tpu/``) must stand in ``SWITCHES``:
either with the port module and function that read it, or with the reason
the port needs none.  A new switch in ``cmix_tpu`` fails this file until it
is placed.  The model gates, which the JAX engine reads from the
environment at import (``_derive(os.environ)``), must be the port's
``engine.GATE_NAMES`` in order; ``GATE_ROUTES`` records where they reach
the port from the environment and where a caller passes them.  The port's
command lines take every option the JAX package's take, and ``--device``
besides.  No JAX compile."""

import ast
import glob
import inspect
import io
import re
from contextlib import redirect_stdout

import pytest

from cmix_tpu import engine as je
from cmix_tpu_torch import engine as E

# name -> (port module, the function there that reads it), or the reason
# the port reads it nowhere
SWITCHES = {
    "CMIX_JPEGC": ("cmix_tpu_torch/preprocess/wrt.py", "transform"),
    "JVAL_ROUTE": ("cmix_tpu_torch/runner.py", "_routed_gates"),
    "WRTW_ROUTE": ("cmix_tpu_torch/runner.py", "_routed_gates"),
    # also a gate of _GATE_SPEC: the JAX DMC module's import-time default,
    # which the engine's gates then set; the port reads it as a gate only
    "DMC_LEVELS": ("cmix_tpu_torch/runner.py", "env_gates"),
    "DMC_PALLAS": "it chooses the Pallas kernel or XLA for the same output; "
                  "the port runs its CUDA kernel on a CUDA tensor and its "
                  "plain version on a CPU tensor, with no switch and no "
                  "fallback",
}

# where the model gates reach the port: from the environment (the JAX
# package's entry points read them there), or passed by the caller (the
# lower-level builders take a ``Gates`` and read no environment)
GATE_ROUTES = {
    ("cmix_tpu_torch.runner", "main"): "environment",
    ("cmix_tpu_torch.runner", "compress"): "environment unless gates given",
    ("cmix_tpu_torch.engine", "make_transcoder"): "explicit",
    ("cmix_tpu_torch.engine", "make_segment_fn"): "explicit",
    ("cmix_tpu_torch.parallel.mesh", "make_sharded_transcoder"): "explicit",
}

CLIS = ("runner", "tools.make_dict", "preprocess.enwik9")


def _parents(tree):
    out = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            out[child] = node
    return out


def _is(node, obj, attr):
    return (isinstance(node, ast.Attribute) and node.attr == attr
            and isinstance(node.value, ast.Name) and node.value.id == obj)


def _const(node):
    return node.value if isinstance(node, ast.Constant) else None


def environment_reads(source):
    """[(line, name)] of every environment read in ``source``: a literal
    name, or "<gates>" for the engine's ``_derive(os.environ)``; any other
    read is returned as "<unplaced>"."""
    tree = ast.parse(source)
    up = _parents(tree)
    reads = []
    for node in ast.walk(tree):
        if _is(node, "os", "environ"):
            parent = up[node]
            if isinstance(parent, ast.Subscript):
                name = _const(parent.slice)
            elif (isinstance(parent, ast.Attribute)
                  and isinstance(up[parent], ast.Call)
                  and parent.attr in ("get", "setdefault", "pop")
                  and up[parent].args):
                name = _const(up[parent].args[0])
            elif (isinstance(parent, ast.Compare)
                  and isinstance(parent.ops[0], (ast.In, ast.NotIn))):
                name = _const(parent.left)
            elif (isinstance(parent, ast.Call)
                  and isinstance(parent.func, ast.Name)
                  and parent.func.id == "_derive"):
                name = "<gates>"
            else:
                name = None
            reads.append((node.lineno, name or "<unplaced>"))
        elif isinstance(node, ast.Call) and _is(node.func, "os", "getenv"):
            reads.append((node.lineno,
                          (_const(node.args[0]) if node.args else None)
                          or "<unplaced>"))
    return sorted(reads)


def _jax_reads():
    out = {}
    for path in sorted(glob.glob("cmix_tpu/**/*.py", recursive=True)):
        with open(path) as f:
            for line, name in environment_reads(f.read()):
                out.setdefault(name, []).append(f"{path}:{line}")
    return out


def test_census_finds_the_known_reads():
    reads = _jax_reads()
    assert {"CMIX_JPEGC", "DMC_LEVELS", "DMC_PALLAS", "JVAL_ROUTE",
            "WRTW_ROUTE"} <= set(reads)
    # the engine's gates, read once at import
    assert len(reads["<gates>"]) == 1
    assert reads["<gates>"][0].startswith("cmix_tpu/engine.py:")
    # the parser sees each form a read may take
    src = ("import os\na = os.environ.get('A')\nb = os.environ['B']\n"
           "c = os.getenv('C', '1')\nd = 'D' in os.environ\n"
           "e = os.environ.setdefault('E', '')\nf = os.environ.get(k)\n")
    assert [n for _, n in environment_reads(src)] == [
        "A", "B", "C", "D", "E", "<unplaced>"]


def test_every_switch_of_the_jax_package_is_placed():
    reads = _jax_reads()
    assert "<unplaced>" not in reads, (
        f"an environment read whose name the census cannot see: "
        f"{reads.get('<unplaced>')}")
    names = set(reads) - {"<gates>"}
    missing = sorted(names - set(SWITCHES))
    assert not missing, (f"switches cmix_tpu reads that the census does not "
                         f"place: {missing} at "
                         f"{[reads[n] for n in missing]}")
    # no stale entry either
    assert sorted(set(SWITCHES) - names) == []


@pytest.mark.parametrize("name", sorted(SWITCHES))
def test_each_switch_is_read_where_the_census_says(name):
    where = SWITCHES[name]
    if isinstance(where, str):
        assert len(where) > 40          # a reason, not a placeholder
        import cmix_tpu_torch
        root = cmix_tpu_torch.__path__[0]
        for path in glob.glob(f"{root}/**/*.py", recursive=True):
            with open(path) as f:
                assert name not in f.read(), path
        return
    path, func = where
    with open(path) as f:
        source = f.read()
    assert f'"{name}"' in source or name in E.GATE_NAMES
    assert re.search(rf"^def {func}\(", source, re.M), (path, func)
    module = __import__(path[:-3].replace("/", "."), fromlist=["_"])
    body = inspect.getsource(getattr(module, func))
    if name in E.GATE_NAMES:
        # a gate: read by the runner's env_gates over GATE_NAMES
        assert "GATE_NAMES" in body and "environ" in body
        with open("cmix_tpu_torch/engine.py") as f:
            assert f'("{name}",' in f.read()
    else:
        assert f'"{name}"' in body and "os.environ" in body


def test_gate_names_are_the_jax_package_gates_in_order():
    assert E.GATE_NAMES == tuple(n for n, _, _ in je._GATE_SPEC)


def test_gate_routes():
    import importlib
    from cmix_tpu_torch import runner
    assert set(GATE_ROUTES.values()) == {
        "environment", "environment unless gates given", "explicit"}
    for (mod, func), route in GATE_ROUTES.items():
        fn = getattr(importlib.import_module(mod), func)
        params = inspect.signature(fn).parameters
        if route == "explicit":
            # a Gates the caller builds, no default and no environment
            g = params["g"]
            assert g.default is inspect.Parameter.empty
            assert "environ" not in inspect.getsource(fn)
        elif route == "environment unless gates given":
            assert params["gates"].default is None
            assert "env_gates()" in inspect.getsource(fn)
        else:
            assert "env_gates()" in inspect.getsource(fn)
    assert "os.environ" in inspect.getsource(runner.env_gates)


def _options(module, argv=("--help",)):
    out = io.StringIO()
    with redirect_stdout(out), pytest.raises(SystemExit):
        module.main(list(argv))
    opts = set()
    for line in out.getvalue().splitlines():
        m = re.match(r"^  (-[\w-]+(?:, -[\w-]+)*)", line)
        if m:
            opts.update(m.group(1).split(", "))
    assert "--help" in opts
    return opts


@pytest.mark.parametrize("cli", CLIS)
def test_the_port_takes_every_option_of_the_jax_cli(cli):
    import importlib
    jax_opts = _options(importlib.import_module(f"cmix_tpu.{cli}"))
    port_opts = _options(importlib.import_module(f"cmix_tpu_torch.{cli}"))
    assert jax_opts <= port_opts
    assert port_opts - jax_opts == ({"--device"} if cli == "runner"
                                    else set())
