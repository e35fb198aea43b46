"""Command-line interface: `python -m cometbft_tpu_torch`.

Reference: cmd/cometbft/main.go:16-46 (cobra command tree). argparse is
the idiomatic Python analog. Commands:

  init        write config.toml, genesis.json, node + validator keys
  start       run a node from the home dir
  testnet     generate N validator home dirs wired as persistent peers
  show-node-id, show-validator, gen-validator, gen-node-key
  unsafe-reset-all, reset-state, reset-priv-validator, wal-repair
  version

Env: CMT_HOME overrides --home (main.go:48 env prefix analog).

The port's copy of cometbft_tpu/cmd.py. `start` runs the port's Node, on
the card unless the config or `--crypto_backend cpu` says "cpu"; the
node refuses the planes that wait for later slices (node.check_planes), so
a home to start sets [rpc] laddr = "", [p2p] pex = false and
[cert] enabled = false. `testnet` writes its homes as the reference does,
except that crypto.backend keeps the port's default, "gpu" (the
reference writes "cpu"). The reference's other subcommands
(rollback, compact-db, inspect, light, debug, trace-dump, netinfo,
heightline, loadtime) parse as there and raise NotImplementedError naming
the module each waits for.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import sys

from cometbft_tpu_torch.version import CMTSemVer as VERSION


def _home(args) -> str:
    return args.home or os.environ.get("CMT_HOME", os.path.expanduser("~/.cometbft_tpu_torch"))


def cmd_init(args) -> int:
    from cometbft_tpu_torch.node import init_files

    home = _home(args)
    init_files(home, chain_id=args.chain_id, moniker=args.moniker)
    print(f"Initialized node home at {home}")
    return 0


def cmd_start(args) -> int:
    import faulthandler

    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.node import Node

    # stack dump on demand (SIGUSR1) — the operator analog of the
    # reference's pprof goroutine dump (cmd/cometbft/commands/debug)
    faulthandler.register(signal.SIGUSR1, all_threads=True)

    home = _home(args)
    config = Config.load(home)
    if args.proxy_app:
        config.base.proxy_app = args.proxy_app
    if args.p2p_laddr:
        config.p2p.laddr = args.p2p_laddr
    if args.rpc_laddr:
        config.rpc.laddr = args.rpc_laddr
    if args.persistent_peers:
        config.p2p.persistent_peers = args.persistent_peers
    if args.crypto_backend:
        config.crypto.backend = args.crypto_backend
    if args.log_level:
        config.base.log_level = args.log_level

    async def run():
        node = Node(config)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await node.start()
        node.logger.info("node started", node_id=node.node_key.id(),
                         chain=node.genesis_doc.chain_id)
        await stop.wait()
        node.logger.info("shutting down")
        await node.stop()

    asyncio.run(run())
    return 0


def cmd_testnet(args) -> int:
    """cmd/cometbft/commands/testnet.go: N validator homes under --o, each
    with the full genesis and persistent_peers pointing at the others."""
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.node import init_files
    from cometbft_tpu_torch.p2p.key import NodeKey
    from cometbft_tpu_torch.privval.file_pv import FilePV
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu_torch.utils import cmttime

    n = args.v
    out = args.o
    chain_id = args.chain_id or f"chain-{os.urandom(3).hex()}"
    homes = [os.path.join(out, f"node{i}") for i in range(n)]
    pvs, node_keys = [], []
    for home in homes:
        cfg = Config(home=home)
        os.makedirs(os.path.join(home, "config"), exist_ok=True)
        os.makedirs(os.path.join(home, "data"), exist_ok=True)
        pvs.append(FilePV.load_or_generate(
            cfg.priv_validator_key_path(), cfg.priv_validator_state_path()))
        node_keys.append(NodeKey.load_or_gen(cfg.node_key_path()))

    gdoc = GenesisDoc(
        genesis_time=cmttime.canonical_now_ms(),
        chain_id=chain_id,
        validators=[
            GenesisValidator(
                address=pv.get_pub_key().address(),
                pub_key=pv.get_pub_key(),
                power=1,
                name=f"node{i}",
            )
            for i, pv in enumerate(pvs)
        ],
    )
    gdoc.validate_and_complete()

    base_p2p, base_rpc = args.starting_port, args.starting_port + 1000
    addrs = [
        f"{node_keys[i].id()}@127.0.0.1:{base_p2p + i}" for i in range(n)
    ]
    for i, home in enumerate(homes):
        cfg = Config(home=home)
        cfg.base.moniker = f"node{i}"
        cfg.p2p.laddr = f"tcp://127.0.0.1:{base_p2p + i}"
        cfg.rpc.laddr = f"tcp://127.0.0.1:{base_rpc + i}"
        cfg.p2p.persistent_peers = ",".join(a for j, a in enumerate(addrs) if j != i)
        # crypto.backend stays "gpu": the reference's "cpu" here would put
        # every node of a testnet on the plain versions
        cfg.save()
        with open(cfg.genesis_path(), "w") as f:
            f.write(gdoc.to_json())
    print(f"Successfully initialized {n} node directories under {out} (chain {chain_id})")
    return 0


def cmd_show_node_id(args) -> int:
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.p2p.key import NodeKey

    cfg = Config.load(_home(args))
    print(NodeKey.load_or_gen(cfg.node_key_path()).id())
    return 0


def cmd_show_validator(args) -> int:
    import base64

    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.privval.file_pv import FilePV

    cfg = Config.load(_home(args))
    pv = FilePV.load_or_generate(
        cfg.priv_validator_key_path(), cfg.priv_validator_state_path())
    pk = pv.get_pub_key()
    print(json.dumps({"type": pk.type_(),
                      "value": base64.b64encode(pk.bytes_()).decode()}))
    return 0


def _reset_file_pv(key_file: str, state_file: str) -> None:
    """Reference resetFilePV (commands/reset.go:100-118): if the key file
    exists, zero the sign-state only (the key survives); otherwise generate
    a fresh validator."""
    from cometbft_tpu_torch.privval.file_pv import FilePV, _LastSignState

    os.makedirs(os.path.dirname(state_file) or ".", exist_ok=True)
    if os.path.exists(key_file):
        pv = FilePV.load(key_file, "")
        pv.state_file = state_file
        pv.last_sign_state = _LastSignState()
        pv._save_state()
        print(f"Reset private validator file to genesis state: {state_file}")
    else:
        os.makedirs(os.path.dirname(key_file) or ".", exist_ok=True)
        pv = FilePV.generate(key_file, state_file)
        pv._save_state()
        print(f"Generated private validator file: {key_file}")


def _reset_state(cfg) -> None:
    """Remove databases + WAL (commands/reset.go resetState)."""
    import shutil

    db_dir = cfg._abs(cfg.base.db_dir)
    for name in ("blockstore", "state", "tx_index", "evidence", "light"):
        p = cfg.db_path(name)
        # sqlite runs journal_mode=WAL (store/db.py): a stale -wal/-shm
        # sidecar next to a freshly created empty db corrupts it on replay,
        # so the sidecars must go with the main file
        for f in (p, p + "-wal", p + "-shm"):
            if os.path.exists(f):
                os.remove(f)
                print(f"Removed {f}")
    wal = cfg.wal_path()
    if os.path.isdir(wal):
        shutil.rmtree(wal, ignore_errors=True)
        print(f"Removed WAL {wal}")
    os.makedirs(db_dir, exist_ok=True)


def cmd_unsafe_reset_all(args) -> int:
    """commands/reset.go:20-40 — remove all data, reset privval state,
    drop the address book (unless --keep-addr-book)."""
    from cometbft_tpu_torch.config import Config

    cfg = Config.load(_home(args))
    _reset_state(cfg)
    if not args.keep_addr_book:
        ab = cfg._abs(cfg.p2p.addr_book_file)
        if os.path.exists(ab):
            os.remove(ab)
            print(f"Removed address book {ab}")
    else:
        print("The address book remains intact")
    _reset_file_pv(cfg.priv_validator_key_path(),
                   cfg.priv_validator_state_path())
    return 0


def cmd_reset_state(args) -> int:
    from cometbft_tpu_torch.config import Config

    _reset_state(Config.load(_home(args)))
    return 0


def cmd_reset_priv_validator(args) -> int:
    from cometbft_tpu_torch.config import Config

    cfg = Config.load(_home(args))
    _reset_file_pv(cfg.priv_validator_key_path(),
                   cfg.priv_validator_state_path())
    return 0


def cmd_gen_validator(_args) -> int:
    """commands/gen_validator.go — print a fresh validator key doc."""
    import base64

    from cometbft_tpu_torch.privval.file_pv import FilePV

    pv = FilePV.generate()
    pub = pv.priv_key.pub_key()
    print(json.dumps({
        "address": pub.address().hex().upper(),
        "pub_key": {"type": "tendermint/PubKeyEd25519",
                    "value": base64.b64encode(pub.bytes_()).decode()},
        "priv_key": {"type": "tendermint/PrivKeyEd25519",
                     "value": base64.b64encode(pv.priv_key.bytes_()).decode()},
    }, indent=2))
    return 0


def cmd_gen_node_key(args) -> int:
    """commands/gen_node_key.go — write node_key.json (if absent) and print
    the node ID."""
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.p2p.key import NodeKey

    cfg = Config.load(_home(args))
    path = cfg.node_key_path()
    if os.path.exists(path):
        print(f"node key already exists at {path}", file=sys.stderr)
        return 1
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    print(NodeKey.load_or_gen(path).id())
    return 0


# the subcommands that wait for later slices, and the module each waits for
QUEUED = {
    "rollback": "state/rollback.py",
    "compact-db": "the port's compact-db (with state/rollback.py)",
    "inspect": "node/inspect.py and rpc/core.py",
    "light": "light/proxy.py and light/rpc_provider.py",
    "debug": "rpc/server.py and node/pprof.py",
    "trace-dump": "rpc/server.py",
    "netinfo": "rpc/server.py",
    "heightline": "rpc/server.py",
    "loadtime": "loadtime.py and rpc/server.py",
}


def cmd_queued(args) -> int:
    raise NotImplementedError(
        f"`{args.command}` waits for the port's {QUEUED[args.command]}, which is not "
        "ported yet")


def cmd_wal_repair(args) -> int:
    """Repair a mid-group-corrupted consensus WAL on a STOPPED node (the
    knob consensus/wal.py's WALCorruptionError names): the damaged chunk
    keeps its good prefix (original preserved as <chunk>.corrupt), later
    chunks are quarantined, and the node recovers the gap over
    handshake/blocksync. A clean WAL is a no-op."""
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.consensus.wal import WAL

    cfg = Config.load(_home(args))
    wal = WAL(os.path.join(cfg.wal_path(), "wal"))
    try:
        report = wal.repair()
    finally:
        wal.close()
    if report.corrupt_chunk is None:
        print("WAL is clean; nothing to repair")
        return 0
    print(f"quarantined corruption in {report.corrupt_chunk} at byte "
          f"offset {report.offset} ({report.truncated_bytes} bytes "
          f"dropped; original kept as "
          f"{os.path.basename(report.corrupt_chunk)}.corrupt)")
    for q in report.quarantined:
        print(f"quarantined unreplayable later chunk {q} -> "
              f"{os.path.basename(q)}.quarantined")
    print("the node will recover the dropped records over "
          "handshake/blocksync at next boot")
    return 0


def cmd_version(_args) -> int:
    print(VERSION)
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cometbft_tpu_torch",
                                description="BFT consensus engine, signatures verified on the card")
    p.add_argument("--home", default=None, help="node home directory")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("init", help="initialize a node home dir")
    sp.add_argument("--chain-id", default="")
    sp.add_argument("--moniker", default="node")
    sp.set_defaults(fn=cmd_init)

    sp = sub.add_parser("start", help="run the node")
    sp.add_argument("--proxy_app", default="")
    sp.add_argument("--p2p.laddr", "--p2p_laddr", dest="p2p_laddr", default="")
    sp.add_argument("--rpc.laddr", "--rpc_laddr", dest="rpc_laddr", default="")
    sp.add_argument("--p2p.persistent_peers", "--persistent_peers",
                    dest="persistent_peers", default="")
    # "gpu" or "cpu"; any other value fails the config's validate_basic
    # with a message naming the two
    sp.add_argument("--crypto.backend", "--crypto_backend", dest="crypto_backend",
                    default="")
    sp.add_argument("--log_level", default="")
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("testnet", help="generate a local testnet")
    sp.add_argument("--v", type=int, default=4, help="number of validators")
    sp.add_argument("--o", default="./mytestnet", help="output directory")
    sp.add_argument("--chain-id", default="")
    sp.add_argument("--starting-port", type=int, default=26656)
    sp.set_defaults(fn=cmd_testnet)

    sp = sub.add_parser("rollback", help="revert state by one height")
    sp.add_argument("--hard", action="store_true",
                    help="also remove the block at the rolled-back height")
    sp.set_defaults(fn=cmd_queued)

    sp = sub.add_parser(
        "wal-repair",
        help="quarantine mid-group consensus-WAL corruption on a stopped "
             "node (the repair WALCorruptionError names)")
    sp.set_defaults(fn=cmd_wal_repair)

    sp = sub.add_parser("inspect", help="serve read-only RPC over a stopped node's data")
    sp.add_argument("--rpc.laddr", dest="rpc_laddr", default="")
    sp.set_defaults(fn=cmd_queued)

    sp = sub.add_parser("light", help="verified light-client RPC proxy")
    sp.add_argument("chain_id")
    sp.add_argument("--primary", required=True, help="primary node RPC URL")
    sp.add_argument("--witness", default="",
                    help="comma-separated witness RPC URLs")
    sp.add_argument("--trusted-height", type=int, required=True)
    sp.add_argument("--trusted-hash", required=True,
                    help="hex header hash at the trusted height")
    sp.add_argument("--trusting-period", type=float, default=168 * 3600,
                    help="seconds (default one week)")
    sp.add_argument("--laddr", default="tcp://127.0.0.1:8888",
                    help="proxy listen address")
    sp.set_defaults(fn=cmd_queued)

    sp = sub.add_parser("debug", help="capture an operator debug bundle")
    sp.add_argument("--rpc.laddr", dest="rpc_laddr",
                    default="tcp://127.0.0.1:26657")
    sp.add_argument("--pprof.laddr", dest="pprof_laddr", default="",
                    help="node's rpc.pprof_laddr; adds a live CPU profile "
                         "+ thread stacks to the bundle")
    sp.add_argument("--profile-seconds", type=int, default=5)
    sp.add_argument("--output", default="", help="output tar.gz path")
    sp.set_defaults(fn=cmd_queued)

    sp = sub.add_parser(
        "trace-dump",
        help="pull the verify-plane flight recorder off a running node "
             "into a Perfetto-loadable trace file")
    sp.add_argument("--rpc.laddr", dest="rpc_laddr",
                    default="tcp://127.0.0.1:26657")
    sp.add_argument("--output", default="", help="output .json path")
    sp.add_argument("--slow", action="store_true",
                    help="also write the slow-batch capture ring")
    sp.set_defaults(fn=cmd_queued)

    sp = sub.add_parser(
        "netinfo",
        help="fleet wire-plane telemetry: per-peer/per-channel network "
             "accounting + live link models across RPC endpoints")
    sp.add_argument("--rpc.laddr", dest="rpc_laddr",
                    default="tcp://127.0.0.1:26657")
    sp.add_argument("--endpoints", default="",
                    help="comma-separated RPC endpoints (overrides "
                         "--rpc.laddr; one net_telemetry pull each)")
    sp.add_argument("--compact", action="store_true",
                    help="single-line JSON output")
    sp.set_defaults(fn=cmd_queued)

    sp = sub.add_parser(
        "heightline",
        help="fleet consensus anatomy: skew-aligned per-height phase "
             "durations, proposal propagation, stragglers + slow links "
             "across RPC endpoints")
    sp.add_argument("--rpc.laddr", dest="rpc_laddr",
                    default="tcp://127.0.0.1:26657")
    sp.add_argument("--endpoints", default="",
                    help="comma-separated RPC endpoints (overrides "
                         "--rpc.laddr; one consensus_timeline pull each)")
    sp.add_argument("--min-height", type=int, default=0)
    sp.add_argument("--limit", type=int, default=0,
                    help="newest N heights per node (0 = all retained)")
    sp.add_argument("--json", action="store_true",
                    help="print the raw aggregate as JSON")
    sp.add_argument("--compact", action="store_true",
                    help="single-line JSON output (with --json)")
    sp.add_argument("--trace", default="",
                    help="also write a Chrome trace of the fused "
                         "timeline to this path")
    sp.set_defaults(fn=cmd_queued)

    sp = sub.add_parser("loadtime", help="tx load generator + latency report")
    sp.add_argument("mode", choices=["run", "report"])
    sp.add_argument("--endpoints", default="",
                    help="comma-separated RPC URLs (report falls back to "
                         "the node home's blockstore when empty)")
    sp.add_argument("--rate", type=float, default=100.0, help="tx/s")
    sp.add_argument("--duration", type=float, default=10.0, help="seconds")
    sp.add_argument("--size", type=int, default=256, help="tx bytes")
    sp.add_argument("--method", default="broadcast_tx_async",
                    choices=["broadcast_tx_async", "broadcast_tx_sync"])
    sp.set_defaults(fn=cmd_queued)

    sp = sub.add_parser(
        "unsafe-reset-all",
        help="(unsafe) remove all data, reset privval state, drop addrbook")
    sp.add_argument("--keep-addr-book", action="store_true",
                    help="keep the address book intact")
    sp.set_defaults(fn=cmd_unsafe_reset_all)

    sp = sub.add_parser("reset-state", help="remove all the data and WAL")
    sp.set_defaults(fn=cmd_reset_state)

    sp = sub.add_parser(
        "unsafe-reset-priv-validator", aliases=["reset-priv-validator"],
        help="(unsafe) reset this node's validator to genesis state")
    sp.set_defaults(fn=cmd_reset_priv_validator)

    sp = sub.add_parser("gen-validator",
                        help="generate and print a fresh validator keypair")
    sp.set_defaults(fn=cmd_gen_validator)

    sp = sub.add_parser("gen-node-key",
                        help="generate node_key.json and print the node ID")
    sp.set_defaults(fn=cmd_gen_node_key)

    sp = sub.add_parser("compact-db",
                        help="force-compact a stopped node's sqlite stores")
    sp.set_defaults(fn=cmd_queued)

    sp = sub.add_parser("show-node-id")
    sp.set_defaults(fn=cmd_show_node_id)
    sp = sub.add_parser("show-validator")
    sp.set_defaults(fn=cmd_show_validator)
    sp = sub.add_parser("version")
    sp.set_defaults(fn=cmd_version)
    return p


if __name__ == "__main__":
    sys.exit(main())
