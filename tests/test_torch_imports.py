"""The port stands alone: it imports torch, never JAX, flax, optax or the
JAX package."""

import pathlib
import re
import subprocess
import sys

import pytest

PACKAGE = pathlib.Path(__file__).resolve().parent.parent / "pytorch3d_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pytorch3d_tpu")


def _modules():
    names = []
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(PACKAGE.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_import_every_module_without_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=PACKAGE.parent, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")), ids=lambda p: str(p.relative_to(PACKAGE)))
def test_sources_reference_no_jax(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax)\b", text, re.M), path
    assert not re.search(r"^\s*(import|from)\s+pytorch3d_tpu(\.|\s|$)", text, re.M), path
    assert "pytorch3d_tpu." not in re.sub(r"pytorch3d_tpu_torch", "", _code_only(text)), path


def _code_only(text: str) -> str:
    """The source without comments and docstrings, which may name the JAX
    counterpart of a module."""
    import ast
    import io
    import tokenize

    doc_lines = set()
    for node in ast.walk(ast.parse(text)):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) and isinstance(
            getattr(body[0], "value", None), ast.Constant
        ) and isinstance(body[0].value.value, str):
            doc_lines.update(range(body[0].lineno, body[0].end_lineno + 1))
    kept = []
    for tok in tokenize.generate_tokens(io.StringIO(text).readline):
        if tok.type in (tokenize.COMMENT, tokenize.STRING) and (
            tok.type == tokenize.COMMENT or tok.start[0] in doc_lines
        ):
            continue
        kept.append(tok.string)
    return " ".join(kept)
