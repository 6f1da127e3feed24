"""The port's public surface against the JAX package's.

The JAX package is parsed with ``ast`` (never imported here); the port is
imported. For every module of ``correrender_tpu`` outside ``ops/pallas/``
(the eleven kernels there have their table in PERF.md and their own
tests), each public top-level function and class, each public method of
such a class and each name of a package's ``__all__`` must be an
attribute of the port's module at the same path. Methods are looked up
with ``hasattr`` on the port's class, so inherited ones count.

A JAX name without a counterpart of the same name is allowed only in
:data:`ALLOWED`, which names its counterpart in the port or the reason it
is not ported (ROADMAP.md's "Do not port" list); an entry whose name the
port does have, or that the JAX package does not, fails the test.
"""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PACKAGE = ROOT / "correrender_tpu"

SHARDING = ("a jax.sharding.NamedSharding; the port lays out blocks on a "
            "torch DeviceMesh (parallel.mesh.shard_member_stack, "
            "shard_member_series, block_range, gather_z)")
CORRELATE_JIT = ("correlate as one cached jitted program; the port's "
                 "ops.correlate runs eagerly and compiles nothing")

#: JAX name (module path relative to the package, then the attribute
#: path) -> the port's counterpart, or why it is not ported.
ALLOWED = {
    "native:build_and_load": "native.build_library (g++ into build/, keyed "
                             "by a hash of the source, the flags and the "
                             "host)",
    "native:io_codec": "io/codec.py (library(), the GRIB2 codec)",
    "ops:correlate_jit": CORRELATE_JIT,
    "ops.registry:correlate_jit": CORRELATE_JIT,
    "ops.registry:hashable_kwargs": "the cache key of correlate_jit's "
                                    "compiled programs; nothing is cached "
                                    "by kwargs in the port",
    "parallel:volume_sharding": SHARDING,
    "parallel.mesh:volume_sharding": SHARDING,
    "parallel.mesh:member_stack_sharding": SHARDING,
    "parallel.mesh:replicated": SHARDING,
    "parallel.mesh:space_sharding": SHARDING,
    "app.viewer:ViewerApp.close": "sets the flag the measure warmer reads; "
                                  "the warmer is on ROADMAP.md's Do not "
                                  "port list, and the port's ViewerApp "
                                  "starts no thread",
    "utils.compile_cache": "the Mosaic compile cache (ROADMAP.md, Do not "
                           "port): the port's kernels are built once by "
                           "ops/cuda/_build.py",
    "utils.profiling:timing_summary": "host enqueue times read by nothing; "
                                      "the port's zones are read from the "
                                      "profiler's trace (PERF.md §3)",
}


def module_path(path: Path) -> str:
    rel = path.relative_to(JAX_PACKAGE).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


def public_names(path: Path) -> list[str]:
    """Public functions, classes and their public methods, and a
    package's ``__all__``, as attribute paths."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))
                and not node.name.startswith("_")):
            names.append(node.name)
            if isinstance(node, ast.ClassDef):
                names += [f"{node.name}.{m.name}" for m in node.body
                          if isinstance(m, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))
                          and not m.name.startswith("_")]
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            names += [e.value for e in node.value.elts]
    return list(dict.fromkeys(names))


def jax_modules() -> dict[str, Path]:
    return {module_path(p): p for p in sorted(JAX_PACKAGE.rglob("*.py"))
            if p.relative_to(JAX_PACKAGE).parts[:2] != ("ops", "pallas")}


MODULES = jax_modules()


def has_path(obj, dotted: str) -> bool:
    for part in dotted.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


@pytest.mark.parametrize("mod", list(MODULES), ids=lambda m: m or "root")
def test_port_has_the_jax_modules_public_names(mod):
    if mod in ALLOWED:
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(f"correrender_tpu_torch.{mod}")
        return
    port = importlib.import_module(
        "correrender_tpu_torch" + (f".{mod}" if mod else ""))
    missing = [name for name in public_names(MODULES[mod])
               if not has_path(port, name) and f"{mod}:{name}" not in ALLOWED]
    assert not missing, (f"correrender_tpu.{mod} has names the port's "
                         f"module lacks: {missing}")


def test_every_allowed_name_is_jaxs_and_missing_from_the_port():
    for key in ALLOWED:
        mod, _, name = key.partition(":")
        assert mod in MODULES, key
        if not name:
            continue
        assert name in public_names(MODULES[mod]), key
        port = importlib.import_module(f"correrender_tpu_torch.{mod}")
        assert not has_path(port, name), f"{key} is ported: drop the entry"


def test_the_surface_covers_the_package():
    # Every subpackage of the JAX package (but ops.pallas) is checked.
    packages = {m.split(".")[0] for m in MODULES if m}
    assert packages == {"app", "calculators", "core", "diagrams", "io",
                        "models", "native", "ops", "optim", "parallel",
                        "render", "utils"}
    assert not any(m.startswith("ops.pallas") for m in MODULES)
