"""The port stands alone: nothing in ``src/repro_torch/`` or
``chip_smoke.py`` imports JAX or the JAX package (``repro``; any
``repro.*`` import pulls in the whole JAX stack).  Nor do the card-only
test files (``tests/test_torch_*_kernel.py``): the machine with the card
has no JAX, so a file that imports it cannot be collected there."""
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
    return files + sorted((ROOT / "tests").glob("test_torch_*_kernel.py"))


def test_pattern_catches_what_it_must():
    bad = ["import jax", "from jax import numpy", "  import jax.numpy as jnp",
           "import repro", "from repro.core import engine",
           "import repro.core.engine"]
    good = ["import repro_torch", "from repro_torch.core import engine",
            "import jaxlib_free_module", "# import jax in a comment? no: "
            "comments start with #"]
    assert all(BAD.search(s) for s in bad)
    assert not any(BAD.search(s) for s in good)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    assert path.exists(), path
    hits = [m.group(0).strip() for m in BAD.finditer(path.read_text())]
    assert not hits, f"{path}: {hits}"
