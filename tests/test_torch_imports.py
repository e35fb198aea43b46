"""Static import guard of the port: no file of cometbft_tpu_torch/, not
chip_smoke.py, not compare_kernels.py and not tests/torch_net_harness.py,
tests/torch_tcp_harness.py or tests/torch_rpc_client.py (which chip_smoke.py
imports) imports JAX or anything of the JAX package
cometbft_tpu — at module level or inside a function, by an
import statement or by importlib/__import__ with a literal name. The
subprocess check in tests/test_torch_verify.py sees only what importing
the modules imports; this one reads every import in the source.
"""

from __future__ import annotations

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "cometbft_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "compare_kernels.py", REPO / "tests" / "torch_net_harness.py",
    REPO / "tests" / "torch_tcp_harness.py", REPO / "tests" / "torch_rpc_client.py"]
FORBIDDEN_ROOTS = ("jax", "jaxlib", "cometbft_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN_ROOTS


def forbidden_imports(source: str) -> list[tuple[int, str]]:
    """(line, module) of every import of JAX or the JAX package in
    `source`, wherever it stands."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            names = [node.args[0].value] if name in ("import_module", "__import__") else []
        else:
            continue
        found += [(node.lineno, n) for n in names if _forbidden(n)]
    return sorted(found)


def test_guard_sees_every_form_of_import():
    src = (
        "import numpy\n"
        "import cometbft_tpu_torch.ops\n"
        "def f():\n"
        "    import jax.numpy as jnp\n"
        "    from cometbft_tpu.crypto import sr25519_math\n"
        "    return importlib.import_module('cometbft_tpu.ops.hashvec')\n"
        "class C:\n"
        "    def g(self):\n"
        "        __import__('jaxlib')\n"
        "from . import limbs\n"
    )
    assert forbidden_imports(src) == [
        (4, "jax.numpy"), (5, "cometbft_tpu.crypto"), (6, "cometbft_tpu.ops.hashvec"),
        (9, "jaxlib")]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_no_jax(path):
    assert forbidden_imports(path.read_text()) == []


CONSUMER_PACKAGES = ("light", "cert", "evidence", "state", "store")


@pytest.mark.parametrize("package", CONSUMER_PACKAGES)
def test_consumer_package_is_read_by_the_guard(package):
    """Every file of the consumers' packages is in PORT_FILES, so the
    static check above reads each import of it."""
    files = sorted((REPO / "cometbft_tpu_torch" / package).glob("*.py"))
    assert files and set(files) <= set(PORT_FILES)


def test_consumer_packages_import_no_jax():
    """The consumers' packages, imported in a fresh interpreter, import
    neither JAX nor the JAX package."""
    import subprocess
    import sys

    code = (
        "import sys, importlib\n"
        f"for p in {CONSUMER_PACKAGES!r}:\n"
        "    importlib.import_module('cometbft_tpu_torch.' + p)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'cometbft_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


NODE_PACKAGES = ("libs", "abci", "proxy", "mempool", "privval", "consensus", "state", "store",
                 "evidence")


@pytest.mark.parametrize("package", NODE_PACKAGES)
def test_node_package_is_read_by_the_guard(package):
    """Every file of the node's packages (the consensus slice) is in
    PORT_FILES, so the static check reads each import of it."""
    files = sorted((REPO / "cometbft_tpu_torch" / package).glob("*.py"))
    assert files and set(files) <= set(PORT_FILES)


def test_node_packages_and_net_harness_import_no_jax():
    """The node's packages and the port's net harness, imported in a fresh
    interpreter, import neither JAX nor the JAX package."""
    import subprocess
    import sys

    code = (
        "import sys, importlib\n"
        f"for p in {NODE_PACKAGES!r}:\n"
        "    importlib.import_module('cometbft_tpu_torch.' + p)\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch_net_harness\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'cometbft_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# the wire slice: the p2p layer, its support in libs/ and crypto/, the
# reactors and block sync
WIRE_MODULES = (
    "libs.flowrate", "libs.linkmodel", "crypto.fallback", "crypto._libcrypto", "p2p.key",
    "p2p.node_info", "p2p.base_reactor", "p2p.conn.secret_connection", "p2p.conn.connection",
    "p2p.netchaos", "p2p.peer", "p2p.transport", "p2p.switch", "consensus.reactor_codec",
    "consensus.peer_state", "consensus.reactor", "mempool.reactor", "evidence.reactor",
    "blocksync.messages", "blocksync.pool", "blocksync.reactor")


@pytest.mark.parametrize("module", WIRE_MODULES)
def test_wire_module_is_read_by_the_guard(module):
    """Each module of the wire slice is a file of the port that the static
    check reads, with a counterpart of the same path in the JAX package."""
    rel = pathlib.Path(*module.split(".")).with_suffix(".py")
    assert REPO / "cometbft_tpu_torch" / rel in PORT_FILES
    assert (REPO / "cometbft_tpu" / rel).is_file()


def test_wire_modules_and_tcp_harness_import_no_jax():
    """The wire slice's modules and the port's TCP harness, imported in a
    fresh interpreter, import neither JAX nor the JAX package."""
    import subprocess
    import sys

    code = (
        "import sys, importlib\n"
        f"for m in {WIRE_MODULES!r}:\n"
        "    importlib.import_module('cometbft_tpu_torch.' + m)\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch_tcp_harness\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'cometbft_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# the node slice: the node's support libraries, WAL and replay, stores,
# indexers, config, the node and the CLI
NODE_MODULES = (
    "version", "libs.metrics", "libs.overload", "libs.pubsub", "types.event_bus",
    "libs.diskchaos", "libs.autofile", "store.db", "consensus.wal", "consensus.replay",
    "state.txindex", "state.pruner", "config.config", "node.node", "cmd", "__main__")


@pytest.mark.parametrize("module", NODE_MODULES)
def test_node_module_is_read_by_the_guard(module):
    """Each module of the node slice is a file of the port that the static
    check reads, with a counterpart of the same path in the JAX package."""
    rel = pathlib.Path(*module.split(".")).with_suffix(".py")
    assert REPO / "cometbft_tpu_torch" / rel in PORT_FILES
    assert (REPO / "cometbft_tpu" / rel).is_file()


def test_cli_start_imports_no_jax(tmp_path):
    """`python -m cometbft_tpu_torch` in a fresh interpreter: `version`
    runs, and `start` on a node home (the "cpu" backend) imports neither
    JAX nor the JAX package while the node boots and commits."""
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-m", "cometbft_tpu_torch", "version"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "0.1.0-gpu", out.stderr
    home = str(tmp_path / "h")
    code = (
        "import asyncio, sys\n"
        "from cometbft_tpu_torch.cmd import main\n"
        f"main(['--home', {home!r}, 'init', '--chain-id', 'imports'])\n"
        "from cometbft_tpu_torch.config import Config\n"
        f"c = Config.load({home!r})\n"
        "c.rpc.laddr = ''; c.p2p.pex = False; c.cert.enabled = False\n"
        "c.p2p.laddr = 'tcp://127.0.0.1:0'; c.save()\n"
        "real_run = asyncio.run\n"
        "async def bounded(coro):\n"
        "    try:\n"
        "        await asyncio.wait_for(coro, 3.0)\n"
        "    except asyncio.TimeoutError:\n"
        "        pass\n"
        "asyncio.run = lambda coro: real_run(bounded(coro))\n"
        f"main(['--home', {home!r}, 'start', '--crypto_backend', 'cpu', '--log_level', 'error'])\n"
        "from cometbft_tpu_torch.store.db import open_db\n"
        "from cometbft_tpu_torch.store import BlockStore\n"
        f"bs = BlockStore(open_db('sqlite', {home!r} + '/data/blockstore.db', checksum=True))\n"
        "assert bs.height() >= 1, bs.height()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'cometbft_tpu')]\n"
        "assert not bad, bad\n"
        "print('started', bs.height())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "started" in out.stdout, out.stderr[-3000:]


# the RPC slice: the node's public surfaces (the RPC server and routes, the
# ABCI socket and gRPC wires with abci-cli, PEX, the remote signer and the
# gRPC services)
SURFACE_MODULES = (
    "abci.proto_codec", "abci.server", "abci.client", "abci.grammar", "abci.cli", "abci.grpc",
    "privval.remote", "p2p.pex.addrbook", "p2p.pex.reactor", "p2p.pex.byzantine",
    "p2p.pex.__init__", "ops.dispatch", "rpc.core", "rpc.server", "rpc.grpc_services",
    "rpc.__init__", "proxy.app_conns")


@pytest.mark.parametrize("module", SURFACE_MODULES)
def test_surface_module_is_read_by_the_guard(module):
    """Each module of the RPC slice is a file of the port that the static
    check reads, with a counterpart of the same path in the JAX package."""
    rel = pathlib.Path(*module.split(".")).with_suffix(".py")
    assert REPO / "cometbft_tpu_torch" / rel in PORT_FILES
    assert (REPO / "cometbft_tpu" / rel).is_file()


def test_surface_modules_and_rpc_client_import_no_jax():
    """The RPC slice's modules (grpc is imported by two of them, as in the
    reference) and the port's RPC client, imported in a fresh interpreter,
    import neither JAX nor the JAX package."""
    import subprocess
    import sys

    mods = [m.removesuffix(".__init__") for m in SURFACE_MODULES]
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module('cometbft_tpu_torch.' + m)\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch_rpc_client\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'cometbft_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# the bootstrap slice: state sync, the certificate plane, the light fleet,
# its RPC provider and proxy, rollback and the SQL indexer
BOOTSTRAP_MODULES = (
    "state.rollback", "state.indexer_sql", "cert.store", "cert.plane", "light.rpc_provider",
    "statesync.__init__", "statesync.messages", "statesync.snapshots", "statesync.chunks",
    "statesync.provider", "statesync.syncer", "statesync.reactor", "light.fleet",
    "light.proxy")


@pytest.mark.parametrize("module", BOOTSTRAP_MODULES)
def test_bootstrap_module_is_read_by_the_guard(module):
    """Each module of the bootstrap slice is a file of the port that the
    static check reads, with a counterpart of the same path in the JAX
    package."""
    rel = pathlib.Path(*module.split(".")).with_suffix(".py")
    assert REPO / "cometbft_tpu_torch" / rel in PORT_FILES
    assert (REPO / "cometbft_tpu" / rel).is_file()


def test_bootstrap_modules_import_no_jax():
    """The bootstrap slice's modules, imported in a fresh interpreter,
    import neither JAX nor the JAX package."""
    import subprocess
    import sys

    mods = [m.removesuffix(".__init__") for m in BOOTSTRAP_MODULES]
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module('cometbft_tpu_torch.' + m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'cometbft_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
