"""Framed unix-socket transport shared by the router and the workers.

Twin of ``tpu_inference/server/transport.py``; the frame bytes, the
``FrameError`` reasons and the ``ChaosTransport`` fault schedule are the
reference's (tests/test_torch_transport.py holds them equal). One
implementation of the wire format for both sides (`fleet.py`
imports the router half, `worker.py` the worker half), stdlib-only so
worker subprocesses can bootstrap it before heavyweight imports.

Frame layout (v2, checksummed)::

    [u32 magic "TPF1"][u32 json_len][u32 blob_len][u32 crc32c]
    [json bytes][blob bytes]

The CRC-32C covers ``pack(">II", json_len, blob_len) + json + blob`` —
lengths included so a corrupted length field that still lands inside
bounds cannot reframe the stream undetected. The magic word is the
desync detector: after a torn write the next read lands mid-payload,
and the odds of four aligned bytes spelling the magic are ~2^-32 —
the reader fails fast with a typed `FrameError` instead of
misinterpreting payload bytes as a length and hanging.

All read-side failures raise `FrameError` (a `ConnectionError`
subclass, so every existing "peer died" handler already routes it to
connection recycling). `reason` is a short machine-readable code:
``eof`` / ``magic`` / ``oversized`` / ``crc`` / ``json``.

`ChaosTransport` is the fault-injection shim: given a seeded policy it
perturbs sends — corrupt a byte, delay, tear the write, drop (modelled
as a connection reset: a SOCK_STREAM socket cannot silently lose bytes
mid-stream, so "the frame vanished" only happens as "the connection
broke"), or wedge (socket stays open, writes stop landing — the
failure only deadlines catch). Faults are drawn from a private
`random.Random(seed)` keyed only by the frame sequence, so the same
seed over the same traffic yields the same fault schedule — replay
lanes and tests pin scenarios exactly.
"""

from __future__ import annotations

import json
import random
import socket
import struct
import time
from typing import Optional, Tuple

from tpu_inference_torch.integrity import crc32c

MAX_FRAME = 1 << 31   # blob bound (KV exports are legitimately large)
MAX_JSON = 1 << 24    # control-plane JSON is small; 16 MB is already absurd
_MAGIC = 0x54504631   # "TPF1"
_HEADER = struct.Struct(">IIII")  # magic, json_len, blob_len, crc32c


class FrameError(ConnectionError):
    """The byte stream is not a valid frame (desync, truncation,
    checksum mismatch, bad JSON). Subclasses ConnectionError because
    the only safe recovery is the same: recycle the connection."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(detail or reason)
        self.reason = reason


def _read_exact(rfile, n: int) -> bytes:
    """Exact-size read without quadratic concat: one allocation,
    ``readinto`` a sliding memoryview. A 1 MB KV blob arriving in 64 KB
    socket chunks used to pay ~16 progressively larger copies; now it
    pays one. Returns immutable bytes — deserialize_host_pages builds
    numpy views over the result, so handing out a reusable buffer
    would alias pages across frames."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    reader = getattr(rfile, "readinto", None)
    while got < n:
        if reader is not None:
            k = reader(view[got:])
            if not k:
                raise FrameError("eof", "peer closed mid-frame")
            got += k
        else:
            chunk = rfile.read(n - got)
            if not chunk:
                raise FrameError("eof", "peer closed mid-frame")
            view[got:got + len(chunk)] = chunk
            got += len(chunk)
    return bytes(buf)


def recv_frame(rfile) -> Tuple[dict, bytes]:
    """Read one frame. Raises ConnectionError("peer closed") on clean
    EOF at a frame boundary, FrameError on anything malformed. Length
    bounds are enforced BEFORE allocation, so a garbage header cannot
    trigger a multi-GB read buffer."""
    hdr = rfile.read(_HEADER.size)
    if not hdr:
        raise ConnectionError("peer closed")
    if len(hdr) < _HEADER.size:
        hdr += _read_exact(rfile, _HEADER.size - len(hdr))
    magic, jlen, blen, want = _HEADER.unpack(hdr)
    if magic != _MAGIC:
        raise FrameError("magic", f"bad frame magic 0x{magic:08x} "
                                  "(stream desync)")
    if jlen > MAX_JSON or blen > MAX_FRAME:
        raise FrameError("oversized",
                         f"frame too large (json={jlen} blob={blen})")
    payload = _read_exact(rfile, jlen)
    blob = _read_exact(rfile, blen) if blen else b""
    got = crc32c(blob, crc32c(payload, crc32c(hdr[4:12])))
    if got != want:
        raise FrameError("crc", "frame checksum mismatch "
                                f"(want 0x{want:08x} got 0x{got:08x})")
    try:
        obj = json.loads(payload.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise FrameError("json", f"bad frame json: {e}") from None
    return obj, blob


def _frame_head(obj: dict, blob: bytes) -> bytes:
    payload = json.dumps(obj, separators=(",", ":")).encode()
    lens = struct.pack(">II", len(payload), len(blob))
    crc = crc32c(blob, crc32c(payload, crc32c(lens)))
    return _HEADER.pack(_MAGIC, len(payload), len(blob), crc) + payload


def encode_frame(obj: dict, blob: bytes = b"") -> bytes:
    return _frame_head(obj, blob) + blob


def _sendmsg_all(sock: socket.socket, head: bytes, blob: bytes) -> None:
    """Vectored send: header+json and the blob go out as one gather
    write, so the blob is never copied into a header+blob bytes object
    first (encode_frame's concat doubled the transient footprint of
    every KV transfer). Loops on partial sends — sendmsg may land any
    prefix of the iovec."""
    bufs = [memoryview(head), memoryview(blob)]
    while bufs:
        sent = sock.sendmsg(bufs)
        while bufs and sent >= len(bufs[0]):
            sent -= len(bufs[0])
            bufs.pop(0)
        if bufs and sent:
            bufs[0] = bufs[0][sent:]


def send_frame(sock: socket.socket, obj: dict, blob: bytes = b"", *,
               chaos: "Optional[ChaosTransport]" = None,
               verb: str = "", direction: str = "send") -> None:
    """Encode and write one frame, routing through the chaos shim when
    one is armed. Chaos faults surface as ConnectionError (drop/tear)
    or silently swallowed writes (wedge) — exactly the failure shapes a
    real broken transport produces."""
    if chaos is not None:
        # Chaos needs the full contiguous frame (corrupt/truncate act
        # on absolute byte offsets); it is a test-only shim, so the
        # concat copy is acceptable there.
        chaos.send(sock, encode_frame(obj, blob), verb, direction)
        return
    head = _frame_head(obj, blob)
    if blob and hasattr(sock, "sendmsg"):
        _sendmsg_all(sock, head, blob)
    else:
        sock.sendall(head + blob)


class ChaosPolicy:
    """Fault-injection knobs for one endpoint. Plain data; the
    stateful draw lives in ChaosTransport. ``verbs`` filters which
    frames are eligible (empty = all; matched against the RPC verb on
    the router side and the reply-verb/event name on the worker side);
    ``direction`` gates which side injects ("send" = router->worker,
    "recv" = worker->router, "both"). ``wedge_after`` > 0 arms a
    one-shot wedge: after that many eligible frames the connection goes
    silent (open but mute) until recycled; ``wedge_spent`` makes the
    replacement connection serve clean so liveness is preserved."""

    def __init__(self, *, seed: int = 0, corrupt_rate: float = 0.0,
                 drop_rate: float = 0.0, delay_rate: float = 0.0,
                 delay_s: float = 0.02, truncate_rate: float = 0.0,
                 wedge_after: int = 0, verbs: tuple = (),
                 direction: str = "both"):
        self.seed = int(seed)
        self.corrupt_rate = float(corrupt_rate)
        self.drop_rate = float(drop_rate)
        self.delay_rate = float(delay_rate)
        self.delay_s = float(delay_s)
        self.truncate_rate = float(truncate_rate)
        self.wedge_after = int(wedge_after)
        self.verbs = tuple(verbs or ())
        self.direction = str(direction or "both")
        self.wedge_spent = False

    @property
    def active(self) -> bool:
        return (self.corrupt_rate > 0 or self.drop_rate > 0
                or self.delay_rate > 0 or self.truncate_rate > 0
                or self.wedge_after > 0)

    def snapshot(self) -> dict:
        return {"seed": self.seed, "corrupt_rate": self.corrupt_rate,
                "drop_rate": self.drop_rate,
                "delay_rate": self.delay_rate, "delay_s": self.delay_s,
                "truncate_rate": self.truncate_rate,
                "wedge_after": self.wedge_after,
                "wedge_spent": self.wedge_spent,
                "verbs": list(self.verbs), "direction": self.direction}


class ChaosTransport:
    """Per-connection fault injector. Deterministic: the action for
    frame N is a pure function of (policy.seed, N), independent of
    wall clock or payload bytes, so pinned seeds reproduce schedules.

    Byte corruption only touches offset >= 12 (the CRC field or the
    payload), never the length words: flipping a length could make the
    reader block for bytes that are never coming, which is the *wedge*
    fault, injected explicitly — corruption should exercise the
    checksum path. Garbage-length handling is covered by the codec
    fuzz tests against the reader directly."""

    def __init__(self, policy: ChaosPolicy):
        self.policy = policy
        self.rng = random.Random(policy.seed)
        self.frames = 0
        self.wedged = False

    def _matches(self, verb: str, direction: str) -> bool:
        p = self.policy
        if p.direction not in ("both", direction):
            return False
        return not p.verbs or verb in p.verbs

    def decide(self, verb: str, direction: str) -> str:
        """Fault action for the next frame: "pass" | "delay" |
        "corrupt" | "truncate" | "drop" | "wedge"."""
        if self.wedged:
            # A wedged connection is mute for ALL traffic, filters or
            # not — that is what "wedged" means.
            return "wedge"
        if not self._matches(verb, direction):
            return "pass"
        p = self.policy
        self.frames += 1
        if p.wedge_after > 0 and not p.wedge_spent \
                and self.frames > p.wedge_after:
            self.wedged = True
            p.wedge_spent = True  # replacement connection serves clean
            return "wedge"
        u = self.rng.random()
        if u < p.drop_rate:
            return "drop"
        u -= p.drop_rate
        if u < p.truncate_rate:
            return "truncate"
        u -= p.truncate_rate
        if u < p.corrupt_rate:
            return "corrupt"
        u -= p.corrupt_rate
        if u < p.delay_rate:
            return "delay"
        return "pass"

    def send(self, sock: socket.socket, data: bytes, verb: str,
             direction: str) -> None:
        action = self.decide(verb, direction)
        if action == "pass":
            sock.sendall(data)
        elif action == "delay":
            time.sleep(self.policy.delay_s)
            sock.sendall(data)
        elif action == "corrupt":
            # Flip one byte in the CRC field or payload; the peer's
            # checksum rejects the frame and recycles the connection.
            buf = bytearray(data)
            off = 12 + self.rng.randrange(len(buf) - 12)
            buf[off] ^= 0xFF
            sock.sendall(bytes(buf))
        elif action == "truncate":
            # Torn write: a prefix lands, then the connection dies.
            n = 1 + self.rng.randrange(max(1, len(data) - 1))
            try:
                sock.sendall(data[:n])
            except OSError:
                pass
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            raise ConnectionError("chaos: torn write")
        elif action == "drop":
            # See module docstring: stream sockets cannot lose bytes
            # silently, so a dropped frame IS a connection reset.
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            raise ConnectionError("chaos: frame dropped "
                                  "(connection reset)")
        else:  # wedge: swallow the write, keep the socket open.
            pass
