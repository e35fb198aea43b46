"""Authenticated encrypted connection (the p2p wire security layer).

Reference: p2p/conn/secret_connection.go:34-49 — a Station-to-Station
handshake: X25519 ephemeral ECDH -> transcript-bound KDF -> two
ChaCha20-Poly1305 session keys (one per direction) + a challenge that each
side signs with its long-lived ed25519 node key, proving identity. Data
flows in fixed-size sealed frames (1024 data bytes + 4-byte length header)
with 96-bit little-endian counter nonces, one counter per direction
(secret_connection.go:57-60,224-292).

The wire follows the reference exactly (secret_connection.go:71-175):
varint-delimited google.protobuf.BytesValue carries each side's ephemeral
pubkey; session keys come from HKDF-SHA256 over the raw DH secret (info
"TENDERMINT_SECRET_CONNECTION_KEY_AND_CHALLENGE_GEN", lower-key party
receives with the first 32 bytes); the sign-me challenge is extracted
from a Merlin transcript ("TENDERMINT_SECRET_CONNECTION_TRANSCRIPT_HASH"
binding the sorted ephemeral keys and the DH secret — the same Merlin
implementation as the sr25519 stack, byte-checked against merlin
vectors); authentication exchanges a varint-delimited
tendermint.p2p.AuthSigMessage over the now-encrypted channel. Sealed
1028-byte frames with 96-bit little-endian counter nonces.

The port's copy of cometbft_tpu/p2p/conn/secret_connection.py. The cipher
runs on the first available of three rungs (AEAD_RUNG): `cryptography`,
libcrypto through ctypes, or the numpy/Python copy in crypto/fallback.py;
all give the same bytes.
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import struct

from cometbft_tpu_torch.crypto import fallback
from cometbft_tpu_torch.crypto.fallback import InvalidTag

from cometbft_tpu_torch.crypto import ed25519

DATA_LEN_SIZE = 4
DATA_MAX_SIZE = 1024
TOTAL_FRAME_SIZE = DATA_MAX_SIZE + DATA_LEN_SIZE  # 1028 (connection.go:57)
AEAD_TAG_SIZE = 16
SEALED_FRAME_SIZE = TOTAL_FRAME_SIZE + AEAD_TAG_SIZE
NONCE_SIZE = 12

_HANDSHAKE_TIMEOUT = 10.0


class ErrHandshake(Exception):
    pass


# ---------------------------------------------------------------------------
# The cipher's rungs: the `cryptography` package when it imports, else the
# process's libcrypto through ctypes, else the numpy/Python copy. All three
# give the same bytes; AEAD_RUNG is the one this process uses.
# ---------------------------------------------------------------------------

def available_rungs() -> list[str]:
    """The rungs this process can run, in the order they are preferred."""
    out = []
    try:
        import cryptography.hazmat.primitives.ciphers.aead  # noqa: F401
        import cryptography.hazmat.primitives.asymmetric.x25519  # noqa: F401

        out.append("cryptography")
    except ImportError:
        pass
    from cometbft_tpu_torch.crypto import _libcrypto

    if _libcrypto.available():
        out.append("libcrypto")
    out.append("python")
    return out


AEAD_RUNG = available_rungs()[0]


def set_aead_rung(rung: str) -> str:
    """Pick the cipher's rung for connections made from now on (tests hold
    each rung against the others); returns the previous one."""
    global AEAD_RUNG
    if rung not in available_rungs():
        raise ValueError(f"AEAD rung {rung!r} is not available here")
    prev, AEAD_RUNG = AEAD_RUNG, rung
    return prev


def make_aead(key: bytes, rung: str | None = None):
    """A ChaCha20-Poly1305 of `rung` (AEAD_RUNG by default): encrypt and
    decrypt as cryptography's, decrypt raising its InvalidTag or ours."""
    rung = rung or AEAD_RUNG
    if rung == "cryptography":
        from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305

        return ChaCha20Poly1305(key)
    return fallback.ChaCha20Poly1305(key, native=rung == "libcrypto")


def x25519(scalar: bytes, u_bytes: bytes, rung: str | None = None) -> bytes:
    """X25519(k, u) on `rung`; u = 9 gives the public key of k."""
    rung = rung or AEAD_RUNG
    if rung == "cryptography":
        from cryptography.hazmat.primitives.asymmetric.x25519 import (
            X25519PrivateKey,
            X25519PublicKey,
        )

        priv = X25519PrivateKey.from_private_bytes(scalar)
        if u_bytes == fallback.X25519_BASEPOINT:
            return priv.public_key().public_bytes_raw()
        return priv.exchange(X25519PublicKey.from_public_bytes(u_bytes))
    return fallback.x25519(scalar, u_bytes, native=rung == "libcrypto")


def _invalid_tags() -> tuple[type, ...]:
    try:
        from cryptography.exceptions import InvalidTag as CryptoInvalidTag

        return (InvalidTag, CryptoInvalidTag)
    except ImportError:
        return (InvalidTag,)


def _hkdf(secret: bytes, info: bytes, length: int) -> bytes:
    """HKDF-SHA256 (RFC 5869), extract with empty salt + expand."""
    prk = hmac.new(b"\x00" * 32, secret, hashlib.sha256).digest()
    out = b""
    block = b""
    counter = 1
    while len(out) < length:
        block = hmac.new(prk, block + info + bytes([counter]), hashlib.sha256).digest()
        out += block
        counter += 1
    return out[:length]


def derive_secrets(dh_secret: bytes, loc_is_least: bool) -> tuple[bytes, bytes]:
    """secret_connection.go:335-364 deriveSecrets: HKDF-SHA256 over the raw
    DH secret. The party with the lexicographically smaller ephemeral
    pubkey receives with the first key; the other side mirrors."""
    okm = _hkdf(dh_secret, b"TENDERMINT_SECRET_CONNECTION_KEY_AND_CHALLENGE_GEN", 96)
    if loc_is_least:
        recv_key, send_key = okm[0:32], okm[32:64]
    else:
        send_key, recv_key = okm[0:32], okm[32:64]
    return recv_key, send_key


def handshake_challenge(lo_eph: bytes, hi_eph: bytes, dh_secret: bytes) -> bytes:
    """The 32-byte sign-me challenge (secret_connection.go:111-135): a
    Merlin transcript binding both ephemeral keys (sorted) and the DH
    secret."""
    from cometbft_tpu_torch.crypto.sr25519_math import Transcript

    t = Transcript(b"TENDERMINT_SECRET_CONNECTION_TRANSCRIPT_HASH")
    t.append_message(b"EPHEMERAL_LOWER_PUBLIC_KEY", lo_eph)
    t.append_message(b"EPHEMERAL_UPPER_PUBLIC_KEY", hi_eph)
    t.append_message(b"DH_SECRET", dh_secret)
    return t.challenge_bytes(b"SECRET_CONNECTION_MAC", 32)


class _NonceCounter:
    """96-bit little-endian counter nonce (secret_connection.go:57-60)."""

    __slots__ = ("_n",)

    def __init__(self) -> None:
        self._n = 0

    def next(self) -> bytes:
        n = self._n
        self._n += 1
        if self._n >= 1 << 64:
            # the reference rekeys long before this; we hard-fail
            raise OverflowError("nonce counter exhausted")
        return struct.pack("<4xQ", n)


class SecretConnection:
    """Wraps an (asyncio.StreamReader, StreamWriter) pair."""

    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        send_aead,
        recv_aead,
        remote_pubkey: ed25519.PubKey,
    ):
        self._reader = reader
        self._writer = writer
        self._send_aead = send_aead
        self._recv_aead = recv_aead
        self._send_nonce = _NonceCounter()
        self._recv_nonce = _NonceCounter()
        self.remote_pubkey = remote_pubkey
        self._recv_buf = b""
        self._send_lock = asyncio.Lock()
        self._bad_tag = _invalid_tags()

    @property
    def remote_host(self) -> str:
        """The remote SOCKET host — unforgeable, unlike any address the
        peer self-reports; the PEX address book keys its hashed-bucket
        source attribution on this."""
        try:
            peername = self._writer.get_extra_info("peername")
            return peername[0] if peername else ""
        except Exception:  # noqa: BLE001 - telemetry, never raises
            return ""

    # -------------------------------------------------------- handshake

    @classmethod
    async def make(
        cls,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        priv_key: ed25519.PrivKey,
    ) -> "SecretConnection":
        """MakeSecretConnection (secret_connection.go:71-130)."""
        from cometbft_tpu_torch.utils import protobuf as pb

        import secrets as _secrets

        rung = AEAD_RUNG
        eph_seed = _secrets.token_bytes(32)
        eph_pub = x25519(eph_seed, fallback.X25519_BASEPOINT, rung)

        # 1. concurrent ephemeral pubkey exchange as varint-delimited
        #    google.protobuf.BytesValue (secret_connection.go shareEphPubKey)
        bv = pb.Writer().bytes(1, eph_pub).output()
        writer.write(pb.marshal_delimited(bv))
        await writer.drain()
        rem_eph_pub = await asyncio.wait_for(
            _read_bytes_value(reader), _HANDSHAKE_TIMEOUT
        )
        if len(rem_eph_pub) != 32:
            raise ErrHandshake("bad ephemeral pubkey length")

        # 2. DH; session keys via HKDF on the raw DH secret; the sign-me
        #    challenge from the Merlin transcript (secret_connection.go:
        #    111-135)
        try:
            dh_secret = x25519(eph_seed, rem_eph_pub, rung)
        except ValueError as e:  # a low-order point: the all-zero secret
            raise ErrHandshake(str(e)) from e
        loc_is_least = eph_pub < rem_eph_pub
        lo, hi = sorted((eph_pub, rem_eph_pub))
        recv_key, send_key = derive_secrets(dh_secret, loc_is_least)
        challenge = handshake_challenge(lo, hi, dh_secret)
        conn = cls(
            reader,
            writer,
            make_aead(send_key, rung),
            make_aead(recv_key, rung),
            remote_pubkey=None,  # set below
        )

        # 3. authenticate: varint-delimited tendermint.p2p.AuthSigMessage
        #    {pub_key=1 (crypto.PublicKey oneof ed25519=1), sig=2} over the
        #    now-encrypted channel (secret_connection.go:155-175)
        sig = priv_key.sign(challenge)
        pk = pb.Writer().bytes(1, priv_key.pub_key().bytes_(), always=True)
        auth_msg = (pb.Writer()
                    .message(1, pk.output(), always=True)
                    .bytes(2, sig).output())
        await conn.write(pb.marshal_delimited(auth_msg))
        auth = await asyncio.wait_for(
            conn.read_delimited(1 << 20), _HANDSHAKE_TIMEOUT)
        rem_pub_bytes, rem_sig = _parse_auth_sig(auth)
        rem_pub = ed25519.PubKey(rem_pub_bytes)
        if not rem_pub.verify_signature(challenge, rem_sig):
            raise ErrHandshake("challenge verification failed")
        conn.remote_pubkey = rem_pub
        return conn

    # ------------------------------------------------------------ frames

    async def write(self, data: bytes) -> int:
        """Chunk into sealed frames (secret_connection.go:224-262). Empty
        writes send nothing (an empty frame would read as EOF on the far
        side)."""
        n = len(data)
        if n == 0:
            return 0
        async with self._send_lock:
            frames = bytearray()
            for off in range(0, len(data), DATA_MAX_SIZE):
                chunk = data[off : off + DATA_MAX_SIZE]
                frame = struct.pack("<I", len(chunk)) + chunk
                frame += b"\x00" * (TOTAL_FRAME_SIZE - len(frame))
                frames += self._send_aead.encrypt(self._send_nonce.next(), bytes(frame), None)
            self._writer.write(bytes(frames))
            await self._writer.drain()
        return n

    async def _read_frame(self) -> bytes:
        sealed = await self._reader.readexactly(SEALED_FRAME_SIZE)
        try:
            frame = self._recv_aead.decrypt(self._recv_nonce.next(), sealed, None)
        except self._bad_tag as e:
            raise ErrHandshake("frame decryption failed") from e
        (n,) = struct.unpack_from("<I", frame)
        if n > DATA_MAX_SIZE:
            raise ErrHandshake("frame length header exceeds max")
        return frame[DATA_LEN_SIZE : DATA_LEN_SIZE + n]

    async def read(self, n: int) -> bytes:
        """Read up to n plaintext bytes (one buffered frame at a time)."""
        if not self._recv_buf:
            self._recv_buf = await self._read_frame()
        out, self._recv_buf = self._recv_buf[:n], self._recv_buf[n:]
        return out

    async def readexactly(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            chunk = await self.read(n - len(out))
            if not chunk:
                raise asyncio.IncompleteReadError(bytes(out), n)
            out += chunk
        return bytes(out)

    # ------------------------------------------ varint-delimited msgs
    # (libs/protoio framing — what the reference speaks over the secret
    # channel for AuthSigMessage and the NodeInfo handshake)

    async def write_msg(self, msg: bytes) -> None:
        from cometbft_tpu_torch.utils.protobuf import marshal_delimited

        await self.write(marshal_delimited(msg))

    async def read_delimited(self, max_size: int = 1 << 22) -> bytes:
        from cometbft_tpu_torch.utils.protobuf import read_delimited_async

        try:
            return await read_delimited_async(self, max_size=max_size)
        except ValueError as e:
            raise ErrHandshake(str(e)) from e

    async def read_msg(self, max_size: int = 1 << 22) -> bytes:
        return await self.read_delimited(max_size)

    def close(self) -> None:
        try:
            self._writer.close()
        except Exception:  # noqa: BLE001 - best-effort close
            pass


async def _read_bytes_value(reader: asyncio.StreamReader) -> bytes:
    """One varint-delimited google.protobuf.BytesValue {value=1: bytes}
    from the raw stream (the pre-encryption ephemeral-key exchange)."""
    from cometbft_tpu_torch.utils.protobuf import read_delimited_async
    from cometbft_tpu_torch.utils import protobuf as pb

    try:
        body = await read_delimited_async(reader, max_size=64)
    except ValueError as e:
        raise ErrHandshake(str(e)) from e
    r = pb.Reader(body)
    val = b""
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            val = r.read_bytes()
        else:
            r.skip(w)
    return val


def _parse_auth_sig(data: bytes) -> tuple[bytes, bytes]:
    """tendermint.p2p.AuthSigMessage -> (ed25519 pubkey bytes, signature).
    Only the ed25519 oneof arm is accepted (the framework's node identity
    key type, as in the reference's default)."""
    from cometbft_tpu_torch.utils import protobuf as pb

    r = pb.Reader(data)
    pub, sig = b"", b""
    while not r.at_end():
        f, w = r.read_tag()
        if f == 1:
            pk = pb.Reader(r.read_bytes())
            while not pk.at_end():
                kf, kw = pk.read_tag()
                if kf == 1:  # crypto.PublicKey oneof: ed25519
                    pub = pk.read_bytes()
                else:
                    pk.skip(kw)
        elif f == 2:
            sig = r.read_bytes()
        else:
            r.skip(w)
    if len(pub) != 32 or len(sig) != 64:
        raise ErrHandshake("bad auth message")
    return pub, sig
