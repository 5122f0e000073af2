"""The port exports what the JAX package exports, module by module.

Each JAX `__init__` is read as text (`ast`), so this test imports no JAX.
A name the port does not export yet must stand in `NOT_YET`, under the
item of ROADMAP.md's queue 1 ("Modules to port") that ports it; a name
listed there that the port now exports must leave the list.
"""

import ast
import importlib
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
MODULES = ["transforms", "renderer", "renderer/mesh", "renderer/points", "renderer/implicit", "structures", "ops",
           "loss", "utils", "common", "parallel", "io", "implicitron/models", "implicitron/models/renderer",
           "implicitron/models/implicit_function", "implicitron/models/global_encoder",
           "implicitron/models/feature_extractor", "implicitron/models/view_pooler"]

# ROADMAP.md queue 1 item -> the JAX names it brings to the port.
NOT_YET = {
    "3. the rest of NeRF that needs nothing of Implicitron": [],
    "6. Implicitron and the trainers": [
        # the SRNs and the LSTM renderer
        "SRNHyperNetImplicitFunction", "SRNImplicitFunction", "LSTMRenderer",
    ],
}
_QUEUED = {name: item for item, names in NOT_YET.items() for name in names}


def jax_exports(module: str) -> set:
    """The public names a JAX package `__init__` binds: what it imports from
    its submodules and what it defines or assigns itself."""
    tree = ast.parse((REPO / "pytorch3d_tpu" / module / "__init__.py").read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


def test_every_queued_name_is_one_the_jax_package_exports():
    exported = set().union(*(jax_exports(m) for m in MODULES))
    assert sorted(set(_QUEUED) - exported) == []


@pytest.mark.parametrize("module", MODULES)
def test_port_exports_the_jax_names(module):
    port = importlib.import_module("pytorch3d_tpu_torch." + module.replace("/", "."))
    names = jax_exports(module)
    missing = sorted(n for n in names if not hasattr(port, n) and n not in _QUEUED)
    assert missing == [], f"pytorch3d_tpu_torch.{module} lacks {missing}: export them or queue them in NOT_YET"
    ported = sorted(n for n in names if hasattr(port, n) and n in _QUEUED)
    assert ported == [], f"pytorch3d_tpu_torch.{module} now exports {ported}: take them out of NOT_YET"
