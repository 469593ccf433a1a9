"""The port imports neither JAX nor the JAX package, and its L1
(``lspnet/``) imports no torch either.

Checked on the source (AST), not on ``sys.modules``: the test process itself
has JAX loaded already.  No string constant of the port names a module of
the JAX package either: a ``python -m`` argv or a logger name is a string,
which an import check cannot see.
"""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "bitcoin_miner_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]
FORBIDDEN = ("jax", "bitcoin_miner_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_files_exist():
    assert len(PORT_FILES) > 10
    assert (ROOT / "bitcoin_miner_tpu_torch" / "csrc" / "sha256_minhash.cu").exists()


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_jax_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_catches_forbidden_names():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("bitcoin_miner_tpu") and _forbidden("bitcoin_miner_tpu.ops.sha256")
    assert not _forbidden("bitcoin_miner_tpu_torch")
    assert not _forbidden("bitcoin_miner_tpu_torch.ops")
    assert not _forbidden("jaxlib_free")


# A dotted name under the JAX package ("bitcoin_miner_tpu.apps.miner"), or
# the package itself as a whole string; "bitcoin_miner_tpu_torch..." and a
# file path ("bitcoin_miner_tpu/ops/...") do not match.
_REF_MODULE = re.compile(r"(?<![A-Za-z0-9_])bitcoin_miner_tpu(\.[A-Za-z_]|$)")


def _ref_module_strings(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            for line in node.value.splitlines() or [""]:
                if _REF_MODULE.search(line.strip()):
                    yield node.lineno, line.strip()


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_string_names_a_reference_module(path):
    bad = list(_ref_module_strings(path))
    assert not bad, f"{path.relative_to(ROOT)} names a JAX-package module: {bad}"


def test_string_checker_catches_reference_modules():
    for text in ("bitcoin_miner_tpu.apps.miner", "bitcoin_miner_tpu", "x bitcoin_miner_tpu.autoscale"):
        assert _REF_MODULE.search(text), text
    for text in ("bitcoin_miner_tpu_torch.apps.miner", "bitcoin_miner_tpu_torch",
                 "bitcoin_miner_tpu/ops/pallas_sha256.py:93", "the JAX package's miner"):
        assert not _REF_MODULE.search(text), text


# The transport's L1 needs neither JAX nor torch: a process that only moves
# packets (a server, a client, an echo runner) never pays for importing one.
LSPNET_FILES = sorted((ROOT / "bitcoin_miner_tpu_torch" / "lspnet").glob("*.py"))


def test_lspnet_files_exist():
    names = {p.name for p in LSPNET_FILES}
    assert {"__init__.py", "udp.py", "faults.py", "chaos.py"} <= names


@pytest.mark.parametrize(
    "path", LSPNET_FILES, ids=lambda p: str(p.relative_to(ROOT))
)
def test_lspnet_imports_no_torch(path):
    bad = [m for m in _imported_modules(path) if m == "torch" or m.startswith("torch.")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
