"""The port stands alone: nothing in ``src/repro_torch/`` or
``chip_smoke.py`` imports JAX or the JAX package (``repro``; any
``repro.*`` import pulls in the whole JAX stack), nor do the port's
examples (``examples/torch_*.py``) or the rank workers the gloo tests
spawn (``tests/_ranks_worker.py``, ``tests/_kernel_ranks_worker.py``,
``tests/_argmax_ranks.py``).  Nor do the card-only
test files (``tests/test_torch_*_kernel.py``): the machine with the card
has no JAX, so a file that imports it cannot be collected there.  That
machine has no ``msgpack`` and no ``zstandard`` either: no port file
imports ``msgpack`` (the port has its own subset, ``slates/_msgpack``),
and ``zstandard`` only inside a ``try`` that catches the ImportError."""
import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BAD = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|"
                 r"import\s+repro(?!_torch)\b|from\s+repro(?!_torch)\b)",
                 re.MULTILINE)


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += sorted((ROOT / "examples").glob("torch_*.py"))
    files.append(ROOT / "tests" / "_ranks_worker.py")
    files.append(ROOT / "tests" / "_kernel_ranks_worker.py")
    files.append(ROOT / "tests" / "_argmax_ranks.py")
    return files + sorted((ROOT / "tests").glob("test_torch_*_kernel.py"))


def card_missing_imports(text: str):
    """Imports of packages the card's machine lacks: ``msgpack``
    anywhere, ``zstandard`` outside a ``try`` with an ``except
    ImportError`` (or a base of it)."""
    hits = []

    def guarded(handlers):
        for h in handlers:
            names = [] if h.type is None else (
                [e.id for e in h.type.elts if isinstance(e, ast.Name)]
                if isinstance(h.type, ast.Tuple) else
                [getattr(h.type, "id", "")])
            if h.type is None or {"ImportError", "ModuleNotFoundError",
                                  "Exception"} & set(names):
                return True
        return False

    def walk(node, in_try):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Try):
                ok = in_try or guarded(child.handlers)
                for n in child.body:
                    walk_one(n, ok)
                for n in child.handlers + child.orelse + child.finalbody:
                    walk_one(n, in_try)
            else:
                walk_one(child, in_try)

    def walk_one(n, in_try):
        mods = []
        if isinstance(n, ast.Import):
            mods = [a.name for a in n.names]
        elif isinstance(n, ast.ImportFrom) and n.level == 0:
            mods = [n.module or ""]
        for m in mods:
            top = m.split(".")[0]
            if top == "msgpack" or (top == "zstandard" and not in_try):
                hits.append(f"line {n.lineno}: import {m}")
        walk(n, in_try)

    walk(ast.parse(text), False)
    return hits


def test_pattern_catches_what_it_must():
    bad = ["import jax", "from jax import numpy", "  import jax.numpy as jnp",
           "import repro", "from repro.core import engine",
           "import repro.core.engine"]
    good = ["import repro_torch", "from repro_torch.core import engine",
            "import jaxlib_free_module", "# import jax in a comment? no: "
            "comments start with #"]
    assert all(BAD.search(s) for s in bad)
    assert not any(BAD.search(s) for s in good)
    missing = ["import msgpack", "from msgpack import packb",
               "def f():\n    import msgpack.fallback",
               "import zstandard", "import zstandard as zstd",
               "from zstandard import ZstdCompressor",
               "try:\n    import zstandard\nexcept KeyError:\n    pass",
               "try:\n    import msgpack\nexcept ImportError:\n    pass",
               "try:\n    pass\nexcept ImportError:\n    import zstandard"]
    present = ["try:\n    import zstandard as _zstd\n"
               "except ImportError:\n    _zstd = None",
               "try:\n    from zstandard import ZstdDecompressor\n"
               "except (ModuleNotFoundError, OSError):\n    pass",
               "from repro_torch.slates import _msgpack as msgpack",
               "import msgpack_free", "# import msgpack"]
    assert all(card_missing_imports(s) for s in missing)
    assert not any(card_missing_imports(s) for s in present)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    assert path.exists(), path
    text = path.read_text()
    hits = [m.group(0).strip() for m in BAD.finditer(text)]
    assert not hits, f"{path}: {hits}"
    missing = card_missing_imports(text)
    assert not missing, f"{path} imports what the card's machine lacks: " \
        f"{missing}"


@pytest.mark.parametrize("rel", [
    "src/repro_torch/launch/serve.py", "src/repro_torch/launch/cells.py",
    "examples/torch_serve_lm.py", "tests/test_torch_serve_kernel.py"])
def test_serving_slice_files_are_checked(rel):
    """The serving slice's modules, example and card-only tests are among
    the files the check above reads."""
    assert ROOT / rel in _port_files()


@pytest.mark.parametrize("rel", [
    "src/repro_torch/core/distributed.py", "src/repro_torch/core/hotspot.py",
    "src/repro_torch/core/hashing.py",
    "tests/test_torch_distributed_kernel.py",
    "src/repro_torch/telemetry/controller.py",
    "tests/test_torch_elastic_kernel.py"])
def test_multi_shard_slice_files_are_checked(rel):
    """The multi-shard slices' modules (the engine, key splitting, the
    ring, the closed-loop controller) and their card-only tests are
    among the files the check above reads."""
    assert ROOT / rel in _port_files()


@pytest.mark.parametrize("rel", [
    "src/repro_torch/kernels/_local.py",
    "src/repro_torch/kernels/decode_attention/ops.py",
    "src/repro_torch/kernels/ssd/ops.py",
    "src/repro_torch/kernels/rmsnorm/ops.py",
    "tests/_kernel_ranks_worker.py",
    "tests/test_torch_kernel_ranks_kernel.py"])
def test_kernel_ranks_slice_files_are_checked(rel):
    """The kernel routes across ranks (the shared helpers, the three
    dispatchers), the worker their gloo test spawns and their card-only
    tests are among the files the check above reads."""
    assert ROOT / rel in _port_files()


@pytest.mark.parametrize("rel", [
    "examples/torch_hot_topics.py", "examples/torch_reputation.py",
    "src/repro_torch/kernels/slate_lookup/__init__.py"])
def test_paper_apps_slice_files_are_checked(rel):
    """The paper's two chained-updater applications (their examples run
    on the card in ``chip_smoke.py`` phase 21) are among the files the
    check above reads."""
    assert ROOT / rel in _port_files()
