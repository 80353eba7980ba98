"""The port's integrity, frame codec, transport chaos and KV wire format
against the reference's (tpu_inference/integrity.py,
server/transport.py, engine/kv_cache.py): CRC-32C bit-identical on every
path, frames and KV blobs byte-identical, the same typed rejections and
the same seeded fault schedules. Twins of tests/test_transport.py.
"""

import importlib.util
import io
import json
import socket
import struct
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from tpu_inference import integrity as rint
from tpu_inference.engine import kv_cache as rkvc
from tpu_inference.server import transport as rtr
from tpu_inference_torch import integrity as tint
from tpu_inference_torch.engine import kv_cache as tkvc
from tpu_inference_torch.server import transport as ttr

SIZES = (0, 1, 7, 64, 1337, 4095, 4096, 4097, 65536, 65543, 123457, 200000)


def _buf(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed + n).integers(
        0, 256, n, dtype=np.uint8).tobytes()


# ------------------------------------------------------------- crc32c


def _blocks_cpu(data, crc=0):
    """The card's block path, run on the CPU."""
    return tint._crc32c_blocks(data, crc, "cpu")


def test_crc32c_reference_vector():
    """The canonical check value (RFC 3720 B.4) on every port path,
    chained and unchained."""
    for fn in (tint.crc32c, tint._crc32c_np, tint._crc32c_fast, _blocks_cpu,
               tint._crc32c_py):
        assert fn(b"123456789") == 0xE3069283
        assert fn(b"") == 0
        assert fn(b"456789", fn(b"123")) == 0xE3069283


@pytest.mark.parametrize("path", ["crc32c", "_crc32c_np", "_crc32c_fast",
                                  "blocks_cpu"])
@pytest.mark.parametrize("n", SIZES)
def test_crc32c_paths_equal_reference(path, n):
    """Every port path (the extension when present, numpy, the dispatch
    used without the extension, the card's block path on the CPU) equals
    the reference's table walk and its crc32c, unchained, chained from a
    seed value, and chained across a cut."""
    fn = _blocks_cpu if path == "blocks_cpu" else getattr(tint, path)
    data = _buf(n)
    want = rint._crc32c_py(data)
    assert fn(data) == want == rint.crc32c(data)
    assert fn(data, 0x1234ABCD) == rint._crc32c_py(data, 0x1234ABCD)
    cut = n // 3
    assert fn(data[cut:], fn(data[:cut])) == want


def test_crc32c_numpy_path_when_the_extension_is_missing(monkeypatch):
    """Without google_crc32c the port's crc32c is its own fast path (the
    reference's is its 5.7 MB/s table walk), and it still equals the
    reference on a 1 MiB buffer and bytes-like inputs."""
    monkeypatch.setitem(sys.modules, "google_crc32c", None)
    spec = importlib.util.spec_from_file_location("_tint_noext",
                                                  tint.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.crc32c is mod._crc32c_fast
    data = _buf(1 << 20, seed=3)
    assert mod.crc32c(data) == rint.crc32c(data)
    assert mod.crc32c(bytearray(data)) == rint.crc32c(data)
    assert mod.crc32c(memoryview(data)[5:]) == rint.crc32c(data[5:])


# -------------------------------------------------------- frame codec

FRAMES = [
    ({"id": 1, "verb": "hello"}, b""),
    ({"ev": "token", "rid": 7, "t": 42, "k": 3}, b""),
    ({"id": 9, "verb": "import-kv", "digests": ["ab" * 16]},
     _buf(5000, seed=1)),
    ({"id": 2, "verb": "submit", "seq": {"prompt_tokens": list(range(40)),
                                         "temperature": 0.0}}, b"\x00\xff"),
]


@pytest.mark.parametrize("i", range(len(FRAMES)))
def test_frame_bytes_equal_reference_and_cross_decode(i):
    obj, blob = FRAMES[i]
    got, want = ttr.encode_frame(obj, blob), rtr.encode_frame(obj, blob)
    assert got == want
    assert ttr.recv_frame(io.BytesIO(want)) == (obj, blob)
    assert rtr.recv_frame(io.BytesIO(got)) == (obj, blob)


def _reason(mod, raw: bytes):
    try:
        mod.recv_frame(io.BytesIO(raw))
    except mod.FrameError as e:
        return e.reason
    except ConnectionError:
        return "closed"
    return "ok"


def _corruptions():
    frame = rtr.encode_frame({"id": 9, "verb": "submit"}, blob=b"kvkvkv")
    out = [("clean", frame), ("empty", b"")]
    for cut in (1, 3, 7, 15, 20, len(frame) - 1):
        out.append((f"cut{cut}", frame[:cut]))
    for off in (0, 3, 12, 15, 16, 25, len(frame) - 1):
        buf = bytearray(frame)
        buf[off] ^= 0x01
        out.append((f"flip{off}", bytes(buf)))
    out.append(("json_oversized", struct.pack(
        ">IIII", 0x54504631, rtr.MAX_JSON + 1, 0, 0)))
    out.append(("blob_oversized", struct.pack(
        ">IIII", 0x54504631, 2, 0xFFFFFFFF, 0) + b"{}"))
    payload = b"{not json"
    lens = struct.pack(">II", len(payload), 0)
    crc = rint.crc32c(payload, rint.crc32c(lens))
    out.append(("bad_json", struct.pack(
        ">IIII", 0x54504631, len(payload), 0, crc) + payload))
    return out


@pytest.mark.parametrize("name,raw", _corruptions(),
                         ids=[n for n, _ in _corruptions()])
def test_same_frame_error_reason_as_reference(name, raw):
    assert _reason(ttr, raw) == _reason(rtr, raw)


# Twins of tests/test_transport.py's codec cases.


def test_frame_roundtrip_and_clean_eof():
    a, b = socket.socketpair()
    rfile = b.makefile("rb")
    ttr.send_frame(a, {"id": 1, "verb": "hello"})
    ttr.send_frame(a, {"ev": "token", "t": 42}, blob=b"\x00\x01\xffbytes")
    assert ttr.recv_frame(rfile) == ({"id": 1, "verb": "hello"}, b"")
    obj, blob = ttr.recv_frame(rfile)
    assert obj["t"] == 42 and blob == b"\x00\x01\xffbytes"
    a.close()
    with pytest.raises(ConnectionError) as ei:
        ttr.recv_frame(rfile)
    assert not isinstance(ei.value, ttr.FrameError)
    b.close()


def test_frame_garbage_lengths_fail_before_allocation():
    """The bounds check precedes the payload read: the reader holds only
    the header, and the error is 'oversized', not 'eof'."""
    hdr = struct.pack(">IIII", 0x54504631, ttr.MAX_JSON + 1, 0, 0xDEADBEEF)
    assert _reason(ttr, hdr) == "oversized"


def test_frame_crc_rejects_any_flipped_byte():
    frame = ttr.encode_frame({"id": 9, "verb": "submit"}, blob=b"kvkvkv")
    for off in range(12, len(frame)):
        buf = bytearray(frame)
        buf[off] ^= 0x01
        assert _reason(ttr, bytes(buf)) == "crc"


def test_frame_error_is_connection_error():
    assert issubclass(ttr.FrameError, ConnectionError)


# -------------------------------------------------------- chaos shim


def _schedule(mod, policy_kw, n=300, verb="submit", direction="send"):
    t = mod.ChaosTransport(mod.ChaosPolicy(**policy_kw))
    return [t.decide(verb, direction) for _ in range(n)]


@pytest.mark.parametrize("kw", [
    dict(seed=1234, corrupt_rate=0.1, drop_rate=0.05, delay_rate=0.2,
         truncate_rate=0.05),
    dict(seed=42, corrupt_rate=0.1, verbs=("token",), direction="recv"),
    dict(seed=7, drop_rate=1.0, verbs=("cancel",)),
    dict(seed=9, wedge_after=3, direction="send"),
])
@pytest.mark.parametrize("verb,direction", [("submit", "send"),
                                            ("token", "recv")])
def test_chaos_schedule_equals_reference(kw, verb, direction):
    """The fault for frame N is the same pure function of (seed, N) on
    both sides."""
    assert (_schedule(ttr, kw, verb=verb, direction=direction)
            == _schedule(rtr, kw, verb=verb, direction=direction))


class _Capture:
    """A socket stand-in that records what is sent."""

    def __init__(self):
        self.out = b""

    def sendall(self, data):
        self.out += bytes(data)

    def shutdown(self, how):
        pass


@pytest.mark.parametrize("kw", [dict(seed=5, corrupt_rate=1.0),
                                dict(seed=6, corrupt_rate=0.5,
                                     delay_rate=0.3, delay_s=0.0)])
def test_chaos_corrupted_bytes_equal_reference(kw):
    """Corruption picks the same byte offsets from the same seed: the
    damaged frames are byte-identical, and each reader rejects them as
    'crc'."""
    outs = []
    for mod in (ttr, rtr):
        chaos = mod.ChaosTransport(mod.ChaosPolicy(**kw))
        frames = []
        for i in range(20):
            cap = _Capture()
            mod.send_frame(cap, {"id": i, "verb": "submit"},
                           blob=bytes([i]) * 64, chaos=chaos, verb="submit")
            frames.append(cap.out)
        outs.append(frames)
    assert outs[0] == outs[1]
    for raw in outs[0]:
        assert _reason(ttr, raw) in ("ok", "crc")


def test_chaos_wedge_one_shot():
    pol = ttr.ChaosPolicy(seed=0, wedge_after=3)
    t = ttr.ChaosTransport(pol)
    assert [t.decide("submit", "send") for _ in range(3)] == ["pass"] * 3
    assert t.decide("submit", "send") == "wedge"
    assert t.decide("healthz", "recv") == "wedge"
    assert pol.wedge_spent
    t2 = ttr.ChaosTransport(pol)
    assert [t2.decide("submit", "send") for _ in range(10)] == ["pass"] * 10


def test_chaos_drop_and_truncate_raise_connection_error():
    for kw in (dict(drop_rate=1.0), dict(truncate_rate=1.0)):
        a, b = socket.socketpair()
        chaos = ttr.ChaosTransport(ttr.ChaosPolicy(seed=3, **kw))
        with pytest.raises(ConnectionError):
            ttr.send_frame(a, {"id": 1, "verb": "submit"}, chaos=chaos,
                           verb="submit")
        a.close(), b.close()


# ------------------------------------------------ KV migration wire format


def _page_arrays(kind: str, n: int = 3, seed: int = 7):
    """n pages of numpy arrays per pool kind: (k, v, k_scale, v_scale)
    with the reference's host layouts ([L, page, Hkv, d_pool])."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if kind in ("f32", "bf16"):
            k, v = (rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
                    for _ in range(2))
            if kind == "bf16":
                k, v = k.astype(ml_dtypes.bfloat16), v.astype(
                    ml_dtypes.bfloat16)
            out.append((k, v, None, None))
        else:
            dt, d = (np.uint8, 8) if kind == "int4" else (np.int8, 16)
            lo, hi = (0, 256) if kind == "int4" else (-127, 128)
            k, v = (rng.integers(lo, hi, (2, 8, 2, d)).astype(dt)
                    for _ in range(2))
            ks, vs = (rng.random((2, 8, 2)).astype(np.float32)
                      for _ in range(2))
            out.append((k, v, ks, vs))
    return out


def _to_torch(a):
    if a is None:
        return None
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_numpy(t, like):
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


KINDS = ["f32", "bf16", "int8", "int4"]


@pytest.mark.parametrize("kind", KINDS)
def test_kv_blob_bytes_equal_reference(kind):
    arrs = _page_arrays(kind)
    ref = [rkvc.HostKVPage(*a) for a in arrs]
    port = [tkvc.HostKVPage(*(_to_torch(x) for x in a)) for a in arrs]
    want = rkvc.serialize_host_pages(ref)
    assert tkvc.serialize_host_pages(port) == want
    assert (tkvc.serialize_host_pages_parts(port)
            == rkvc.serialize_host_pages_parts(ref))
    if kind == "bf16":
        hlen = struct.unpack(">I", want[:4])[0]
        assert json.loads(want[4:4 + hlen])["k_dtype"] == "bfloat16"
    # Each side reads the other's blob back to the same values.
    for copy in (True, False):
        back = tkvc.deserialize_host_pages(want, copy=copy)
        for a, p in zip(arrs, back):
            for x, t in zip(a, p):
                if x is None:
                    assert t is None
                else:
                    np.testing.assert_array_equal(_to_numpy(t, x), x)
        assert [p.nbytes for p in back] == [p.nbytes for p in ref]
    for a, p in zip(arrs, rkvc.deserialize_host_pages(
            tkvc.serialize_host_pages(port))):
        for x, y in zip(a, p):
            if x is not None:
                np.testing.assert_array_equal(y, x)
    assert tkvc.serialize_host_pages([]) == rkvc.serialize_host_pages([])
    assert tkvc.deserialize_host_pages(tkvc.serialize_host_pages([])) == []


def _blob_damages():
    blob = rkvc.serialize_host_pages(
        [rkvc.HostKVPage(*a) for a in _page_arrays("int8", n=2)])
    out = [("clean", blob), ("empty", b"")]
    for cut in (1, 3, 10, len(blob) // 2, len(blob) - 1):
        out.append((f"cut{cut}", blob[:cut]))
    hlen = struct.unpack(">I", blob[:4])[0]
    for off in (0, 5, 4 + hlen, 4 + hlen + 100, len(blob) - 1):
        buf = bytearray(blob)
        buf[off] ^= 0x01
        out.append((f"flip{off}", bytes(buf)))
    meta = json.loads(blob[4:4 + hlen].decode())
    meta.pop("crc32c")
    hdr = json.dumps(meta).encode()
    out.append(("predigest",
                struct.pack(">I", len(hdr)) + hdr + blob[4 + hlen:]))
    return out


def _deser_verdict(mod, integrity_mod, blob):
    try:
        return len(mod.deserialize_host_pages(blob))
    except integrity_mod.KVIntegrityError:
        return "rejected"
    except Exception:  # noqa: BLE001
        return "error"


@pytest.mark.parametrize("name,blob", _blob_damages(),
                         ids=[n for n, _ in _blob_damages()])
def test_kv_blob_verdicts_equal_reference(name, blob):
    """verify_host_pages_blob gives the same verdict (the same reason
    text); deserialize accepts or rejects the same blobs."""
    assert tkvc.verify_host_pages_blob(blob) == \
        rkvc.verify_host_pages_blob(blob)
    if blob:
        got = _deser_verdict(tkvc, tint, blob)
        want = _deser_verdict(rkvc, rint, blob)
        assert got == want or (got == "rejected" and want == "error"), \
            (got, want)
