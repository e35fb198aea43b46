"""Wire codec for the socket ABCI transport.

Frame = 4-byte big-endian length + JSON body {"m": method, "r": request}.
Dataclasses serialize structurally; bytes fields go base64. This is the
framework's native app-server protocol (the analog of the reference's
varint-delimited proto Request/Response, abci/client/socket_client.go).

The port's copy of cometbft_tpu/abci/codec.py.
"""

from __future__ import annotations

import base64
import dataclasses
import enum
import json
import struct
from typing import Any

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.utils import cmttime

_REQUEST_TYPES: dict[str, type] = {
    "echo": abci.RequestEcho,
    "flush": abci.RequestFlush,
    "info": abci.RequestInfo,
    "query": abci.RequestQuery,
    "check_tx": abci.RequestCheckTx,
    "init_chain": abci.RequestInitChain,
    "prepare_proposal": abci.RequestPrepareProposal,
    "process_proposal": abci.RequestProcessProposal,
    "finalize_block": abci.RequestFinalizeBlock,
    "extend_vote": abci.RequestExtendVote,
    "verify_vote_extension": abci.RequestVerifyVoteExtension,
    "commit": abci.RequestCommit,
    "list_snapshots": abci.RequestListSnapshots,
    "offer_snapshot": abci.RequestOfferSnapshot,
    "load_snapshot_chunk": abci.RequestLoadSnapshotChunk,
    "apply_snapshot_chunk": abci.RequestApplySnapshotChunk,
}

_RESPONSE_TYPES: dict[str, type] = {
    "echo": abci.ResponseEcho,
    "flush": abci.ResponseFlush,
    "info": abci.ResponseInfo,
    "query": abci.ResponseQuery,
    "check_tx": abci.ResponseCheckTx,
    "init_chain": abci.ResponseInitChain,
    "prepare_proposal": abci.ResponsePrepareProposal,
    "process_proposal": abci.ResponseProcessProposal,
    "finalize_block": abci.ResponseFinalizeBlock,
    "extend_vote": abci.ResponseExtendVote,
    "verify_vote_extension": abci.ResponseVerifyVoteExtension,
    "commit": abci.ResponseCommit,
    "list_snapshots": abci.ResponseListSnapshots,
    "offer_snapshot": abci.ResponseOfferSnapshot,
    "load_snapshot_chunk": abci.ResponseLoadSnapshotChunk,
    "apply_snapshot_chunk": abci.ResponseApplySnapshotChunk,
}


def _to_jsonable(obj: Any) -> Any:
    if obj is None or isinstance(obj, (int, float, str, bool)):
        return obj
    if isinstance(obj, bytes):
        return {"__b": base64.b64encode(obj).decode()}
    if isinstance(obj, enum.Enum):
        return int(obj.value)
    if isinstance(obj, cmttime.Timestamp):
        return {"__t": [obj.seconds, obj.nanos]}
    if dataclasses.is_dataclass(obj):
        return {
            f.name: _to_jsonable(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    raise TypeError(f"cannot encode {type(obj)}")


def _from_jsonable(cls: type, data: Any) -> Any:
    if data is None:
        return None
    if isinstance(data, dict) and "__b" in data:
        return base64.b64decode(data["__b"])
    if isinstance(data, dict) and "__t" in data:
        return cmttime.Timestamp(*data["__t"])
    if dataclasses.is_dataclass(cls):
        kwargs = {}
        hints = {f.name: f.type for f in dataclasses.fields(cls)}
        resolved = _resolve_field_types(cls)
        for f in dataclasses.fields(cls):
            if f.name not in data:
                continue
            kwargs[f.name] = _coerce(resolved.get(f.name), data[f.name])
        return cls(**kwargs)
    return data


def _resolve_field_types(cls: type) -> dict[str, Any]:
    import typing

    try:
        return typing.get_type_hints(cls)
    except Exception:  # noqa: BLE001 - string annotations w/ fwd refs
        return {}


def _coerce(hint: Any, value: Any) -> Any:
    import typing

    if value is None:
        return None
    if isinstance(value, dict) and "__b" in value:
        return base64.b64decode(value["__b"])
    if isinstance(value, dict) and "__t" in value:
        return cmttime.Timestamp(*value["__t"])
    origin = typing.get_origin(hint)
    if origin in (list, tuple):
        (inner,) = typing.get_args(hint) or (None,)
        return [_coerce(inner, v) for v in value]
    if isinstance(hint, type):
        if dataclasses.is_dataclass(hint):
            return _from_jsonable(hint, value)
        if issubclass(hint, enum.Enum):
            return hint(value)
    return value


def _frame(body: dict) -> bytes:
    raw = json.dumps(body, separators=(",", ":")).encode()
    return struct.pack(">I", len(raw)) + raw


def _read_frame(rfile) -> dict:
    hdr = rfile.read(4)
    if len(hdr) < 4:
        raise EOFError("connection closed")
    (n,) = struct.unpack(">I", hdr)
    if n > 64 * 1024 * 1024:
        raise ValueError("frame too large")
    raw = rfile.read(n)
    if len(raw) < n:
        raise EOFError("truncated frame")
    return json.loads(raw)


async def _read_frame_async(reader) -> dict:
    hdr = await reader.readexactly(4)
    (n,) = struct.unpack(">I", hdr)
    if n > 64 * 1024 * 1024:
        raise ValueError("frame too large")
    raw = await reader.readexactly(n)
    return json.loads(raw)


def encode_request(method: str, req: Any) -> bytes:
    return _frame({"m": method, "r": _to_jsonable(req)})


def decode_request(rfile) -> tuple[str, Any]:
    return _decode_request_body(_read_frame(rfile))


def encode_response(method: str, resp: Any) -> bytes:
    return _frame({"m": method, "r": _to_jsonable(resp)})


def encode_exception(message: str) -> bytes:
    return _frame({"m": "exception", "r": message})


def decode_response(rfile) -> tuple[str, Any]:
    return _decode_response_body(_read_frame(rfile))


def _decode_request_body(body: dict) -> tuple[str, Any]:
    method = body["m"]
    cls = _REQUEST_TYPES.get(method)
    if cls is None:
        raise ValueError(f"unknown ABCI method {method!r}")
    return method, _from_jsonable(cls, body.get("r") or {})


def _decode_response_body(body: dict) -> tuple[str, Any]:
    method = body["m"]
    if method == "exception":
        return method, body.get("r")
    cls = _RESPONSE_TYPES.get(method)
    if cls is None:
        raise ValueError(f"unknown ABCI response {method!r}")
    return method, _from_jsonable(cls, body.get("r") or {})


async def decode_request_async(reader) -> tuple[str, Any]:
    return _decode_request_body(await _read_frame_async(reader))


async def decode_response_async(reader) -> tuple[str, Any]:
    return _decode_response_body(await _read_frame_async(reader))
