"""abci-cli: the standalone ABCI conformance/debug console.

Reference: abci/cmd/abci-cli/abci-cli.go — a client for exercising any ABCI
server (echo/info/query/check_tx/finalize_block/commit/proposals) plus a
built-in kvstore server, an interactive console, and batch mode over stdin.
Run as `python -m cometbft_tpu_torch.abci.cli ...`; speaks the reference's
varint-delimited proto wire by default (--wire json for the framework
frame), so it drives reference apps and this framework's apps alike.

Tx arguments accept "0x"-prefixed hex or raw strings (abci-cli.go's
stringOrHexToBytes).

The port's copy of cometbft_tpu/abci/cli.py.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import shlex
import sys

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.abci.client import ClientError, SocketClient

DEFAULT_ADDR = "tcp://127.0.0.1:26658"


def _arg_bytes(s: str) -> bytes:
    if s.startswith("0x") or s.startswith("0X"):
        return bytes.fromhex(s[2:])
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        s = s[1:-1]
    return s.encode()


def _print_resp(resp) -> None:
    import base64
    import dataclasses
    import enum

    def enc(v):
        if isinstance(v, bytes):
            return {"hex": v.hex().upper(), "str": v.decode("utf-8", "replace")} if v else ""
        if isinstance(v, enum.Enum):
            return v.name
        if dataclasses.is_dataclass(v):
            return {f.name: enc(getattr(v, f.name))
                    for f in dataclasses.fields(v)}
        if isinstance(v, list):
            return [enc(x) for x in v]
        if hasattr(v, "seconds"):
            return {"seconds": v.seconds, "nanos": v.nanos}
        return v

    try:
        print(json.dumps(enc(resp), indent=1))
    except TypeError:
        print(resp)


async def _run_command(cli, cmd: str, args: list[str]) -> None:
    if cmd == "echo":
        resp = await cli.echo(args[0] if args else "")
    elif cmd == "info":
        resp = await cli.info(abci.RequestInfo(version="abci-cli"))
    elif cmd == "query":
        path = ""
        data = b""
        rest = list(args)
        while rest:
            a = rest.pop(0)
            if a == "--path":
                path = rest.pop(0)
            else:
                data = _arg_bytes(a)
        resp = await cli.query(abci.RequestQuery(path=path, data=data))
    elif cmd == "check_tx":
        resp = await cli.check_tx(abci.RequestCheckTx(tx=_arg_bytes(args[0])))
    elif cmd == "finalize_block":
        resp = await cli.finalize_block(abci.RequestFinalizeBlock(
            txs=[_arg_bytes(a) for a in args]))
    elif cmd == "prepare_proposal":
        resp = await cli.prepare_proposal(abci.RequestPrepareProposal(
            max_tx_bytes=1 << 22, txs=[_arg_bytes(a) for a in args]))
    elif cmd == "process_proposal":
        resp = await cli.process_proposal(abci.RequestProcessProposal(
            txs=[_arg_bytes(a) for a in args]))
    elif cmd == "commit":
        resp = await cli.commit(abci.RequestCommit())
    else:
        print(f"unknown command {cmd!r} "
              "(echo/info/query/check_tx/finalize_block/prepare_proposal/"
              "process_proposal/commit)", file=sys.stderr)
        return
    _print_resp(resp)


async def _console(cli, lines) -> None:
    for line in lines:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = shlex.split(line)
        if parts[0] in ("quit", "exit"):
            return
        try:
            await _run_command(cli, parts[0], parts[1:])
        except ClientError as e:
            print(f"error: {e}", file=sys.stderr)


def _stdin_lines():
    if sys.stdin.isatty():
        while True:
            try:
                yield input("> ")
            except EOFError:
                return
    else:
        yield from sys.stdin


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="abci-cli", description=__doc__)
    p.add_argument("--address", default=DEFAULT_ADDR,
                   help=f"ABCI server address (default {DEFAULT_ADDR})")
    p.add_argument("--wire", choices=("proto", "json"), default="proto",
                   help="wire format: reference proto (default) or "
                        "framework json")
    p.add_argument("command", help="echo|info|query|check_tx|finalize_block|"
                                   "prepare_proposal|process_proposal|commit|"
                                   "console|batch|kvstore")
    # REMAINDER: command-local flags like `query --path /store k` must not
    # be eaten by this parser
    p.add_argument("args", nargs=argparse.REMAINDER)
    ns = p.parse_args(argv)

    if ns.command == "kvstore":
        # built-in server, as in the reference (abci-cli kvstore); a
        # grpc:// address serves the tendermint.abci.ABCI gRPC service
        from cometbft_tpu_torch.abci.kvstore import KVStoreApplication

        if ns.address.startswith("grpc://"):
            import time as _time

            from cometbft_tpu_torch.abci.grpc import serve_grpc

            server, bound = serve_grpc(KVStoreApplication(), ns.address)
            print(f"abci-cli kvstore (grpc) listening on {bound}",
                  file=sys.stderr)
            try:
                while True:
                    _time.sleep(3600)
            except KeyboardInterrupt:
                server.stop(None)
            return 0

        from cometbft_tpu_torch.abci.server import ABCIServer

        async def serve():
            srv = ABCIServer(KVStoreApplication(), ns.address)
            await srv.start()
            print(f"abci-cli kvstore listening on {srv.bound_addr()}",
                  file=sys.stderr)
            try:
                while True:
                    await asyncio.sleep(3600)
            finally:
                await srv.stop()

        try:
            asyncio.run(serve())
        except KeyboardInterrupt:
            pass
        return 0

    async def run():
        cli = SocketClient(ns.address, wire=ns.wire)
        try:
            if ns.command in ("console", "batch"):
                await _console(cli, _stdin_lines())
            else:
                await _run_command(cli, ns.command, ns.args)
        finally:
            await cli.close()

    try:
        asyncio.run(run())
    except ClientError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except (ConnectionError, OSError) as e:
        print(f"connection failed: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
