"""OpenPGP ASCII armor (RFC 4880 §6) — key-export framing.

Reference: crypto/armor/armor.go:24-60 (EncodeArmor/DecodeArmor over
golang.org/x/crypto/openpgp/armor). Implemented here directly from the
RFC: BEGIN/END lines, optional "Key: Value" headers, blank line, base64
body wrapped at 64 columns, and the "=" + base64(CRC-24/OpenPGP) checksum
line (poly 0x1864CFB, init 0xB704CE).

The port's copy of cometbft_tpu/crypto/armor.py (standard library only).
"""

from __future__ import annotations

import base64

_CRC24_INIT = 0xB704CE
_CRC24_POLY = 0x1864CFB
_WRAP = 64  # go's armor writer wraps at 64 columns


def _crc24(data: bytes) -> int:
    crc = _CRC24_INIT
    for b in data:
        crc ^= b << 16
        for _ in range(8):
            crc <<= 1
            if crc & 0x1000000:
                crc ^= _CRC24_POLY
    return crc & 0xFFFFFF


def encode_armor(block_type: str, headers: dict[str, str], data: bytes) -> str:
    lines = [f"-----BEGIN {block_type}-----"]
    for k in sorted(headers):
        lines.append(f"{k}: {headers[k]}")
    lines.append("")
    b64 = base64.b64encode(data).decode()
    lines.extend(b64[i:i + _WRAP] for i in range(0, len(b64), _WRAP))
    if not data:
        lines.append("")  # empty payload still carries a body slot
    crc = _crc24(data).to_bytes(3, "big")
    lines.append("=" + base64.b64encode(crc).decode())
    lines.append(f"-----END {block_type}-----")
    return "\n".join(lines) + "\n"


class ArmorError(ValueError):
    pass


def decode_armor(armor_str: str) -> tuple[str, dict[str, str], bytes]:
    """-> (block type, headers, data). Raises ArmorError on framing or
    checksum violations."""
    lines = [ln.rstrip("\r") for ln in armor_str.strip().split("\n")]
    if not lines or not lines[0].startswith("-----BEGIN ") \
            or not lines[0].endswith("-----"):
        raise ArmorError("missing BEGIN line")
    block_type = lines[0][len("-----BEGIN "):-len("-----")]
    end = f"-----END {block_type}-----"
    if lines[-1] != end:
        raise ArmorError(f"missing {end!r}")
    body = lines[1:-1]
    headers: dict[str, str] = {}
    i = 0
    while i < len(body) and body[i]:
        if ":" not in body[i]:
            break  # headerless armor: body starts immediately
        k, _, v = body[i].partition(":")
        headers[k.strip()] = v.strip()
        i += 1
    if i < len(body) and not body[i]:
        i += 1  # the blank separator
    b64_lines = []
    crc_line = None
    for ln in body[i:]:
        if ln.startswith("="):
            crc_line = ln
            break
        b64_lines.append(ln)
    try:
        data = base64.b64decode("".join(b64_lines), validate=True)
    except Exception as e:  # noqa: BLE001
        raise ArmorError(f"bad base64 body: {e}") from e
    if crc_line is not None:
        try:
            want = int.from_bytes(base64.b64decode(crc_line[1:], validate=True), "big")
        except Exception as e:  # noqa: BLE001
            raise ArmorError(f"bad checksum line: {e}") from e
        if _crc24(data) != want:
            raise ArmorError("CRC-24 checksum mismatch")
    return block_type, headers, data
