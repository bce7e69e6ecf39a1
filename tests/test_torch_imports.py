"""The port stands alone: nothing in it imports jax or the reference package."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0], node.lineno


def test_port_has_files():
    assert len(FILES) > 30
    assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_reference(path):
    bad = [(name, line) for name, line in _imported_roots(path)
           if name in FORBIDDEN]
    assert not bad, f"{path}: forbidden imports {bad}"


def test_kernel_sources_never_built_at_import():
    """Importing every module must not need nvcc, triton or a GPU."""
    import importlib
    for path in FILES[:-1]:
        rel = path.relative_to(ROOT / "src").with_suffix("")
        name = ".".join(rel.parts)
        if name.endswith(".__main__"):
            continue
        if name.endswith(".__init__"):
            name = name[: -len(".__init__")]
        importlib.import_module(name)
    from repro_torch.kernels import _build
    assert _build._LIB is None
