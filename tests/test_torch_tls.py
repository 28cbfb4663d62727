"""The port's TLS stack (swarm_tpu_torch.tls) against the JAX package's.

The port keeps its own copy of ``swarm_tpu/tls``; on the same inputs the
two must give the same ClientHello bytes, the same parsed server flights
and the same fingerprints.
"""

import dataclasses
import os
import struct

import pytest

from chip_smoke import server_hello
from swarm_tpu.tls import jarm as jjarm
from swarm_tpu.tls import jarm_table as jtable
from swarm_tpu.tls import wire as jwire
from swarm_tpu_torch.tls import jarm as tjarm
from swarm_tpu_torch.tls import jarm_table as ttable
from swarm_tpu_torch.tls import wire as twire


def fields(obj) -> dict:
    return dataclasses.asdict(obj)


def test_tables_match():
    assert ttable.DEFAULT_UPSTREAM_TABLE == jtable.DEFAULT_UPSTREAM_TABLE
    assert tjarm.CANONICAL == jjarm.CANONICAL
    assert tjarm.EMPTY_JARM == jjarm.EMPTY_JARM


@pytest.mark.parametrize("hostname", ["", "a.test", "xn--bcher-kva.example"])
def test_client_hellos_identical(hostname, monkeypatch):
    # the TLS 1.3 probes draw a session id from os.urandom: pin it
    monkeypatch.setattr(os, "urandom", lambda k: bytes(range(k)))
    rnd = bytes(range(100, 132))
    t_probes = tjarm.probe_set(hostname)
    j_probes = jjarm.probe_set(hostname)
    assert [fields(p) for p in t_probes] == [fields(p) for p in j_probes]
    for tp, jp in zip(t_probes, j_probes):
        assert twire.build_client_hello(tp, rnd) == jwire.build_client_hello(jp, rnd)


def _fragmented(raw: bytes, cut: int) -> bytes:
    hs = raw[5:]
    r1 = bytes([0x16]) + struct.pack("!HH", 0x0303, cut) + hs[:cut]
    r2 = bytes([0x16]) + struct.pack("!HH", 0x0303, len(hs) - cut) + hs[cut:]
    return r1 + r2


HELLO = server_hello(0xC02F, alpn=b"h2", exts=((0xFF01, b"\x00"), (0x0017, b"")))
HELLO13 = server_hello(0x1301, supported_version=0x0304)
ALERT = bytes([0x15]) + struct.pack("!HH", 0x0303, 2) + b"\x02\x28"
FLIGHTS = {
    "hello": HELLO,
    "hello13": HELLO13,
    "unknown_cipher": server_hello(0xBEEF),
    "junk_version": server_hello(0xC02F, legacy=0x4141),
    "fragmented": _fragmented(HELLO, 7),
    "trailing": HELLO + b"garbage-after",
    "ccs_first": bytes([0x14]) + struct.pack("!HH", 0x0303, 1) + b"\x01" + HELLO,
    "alert": ALERT,
    "alert_then_hello": ALERT + HELLO,
    "http": b"HTTP/1.1 400 Bad Request\r\n\r\n",
    "truncated_header": b"\x16\x03\x03",
    "truncated_body": HELLO[:20],
    "empty": b"",
}


@pytest.mark.parametrize("name", sorted(FLIGHTS))
def test_parse_and_hash_identical(name):
    raw = FLIGHTS[name]
    t = twire.parse_server_flight(raw)
    j = jwire.parse_server_flight(raw)
    assert fields(t) == fields(j)
    assert tjarm.ja3s(t) == jjarm.ja3s(j)
    assert tjarm.upstream_raw_result(t) == jjarm.upstream_raw_result(j)
    assert tjarm.jarm_hash([t] * 10) == jjarm.jarm_hash([j] * 10)


BANNER_SETS = {
    "all_hello": [HELLO] * 10,
    "mixed": [HELLO, HELLO13, b"", ALERT, FLIGHTS["http"], HELLO, b"", HELLO13,
              FLIGHTS["fragmented"], FLIGHTS["unknown_cipher"]],
    "junk_version": [FLIGHTS["junk_version"]] + [b""] * 9,
    "alerts_only": [ALERT] * 10,
    "dead": [b""] * 10,
}


@pytest.mark.parametrize("open_", [True, False])
@pytest.mark.parametrize("name", sorted(BANNER_SETS))
def test_fingerprint_from_banners_identical(name, open_):
    banners = BANNER_SETS[name]
    t = tjarm.fingerprint_from_banners("h.test", 443, banners, open_=open_)
    j = jjarm.fingerprint_from_banners("h.test", 443, banners, open_=open_)
    assert fields(t) == fields(j)
    assert t.line() == j.line()


def test_cipher_table_override_identical(tmp_path, monkeypatch):
    table = tmp_path / "jarm_ciphers.txt"
    table.write_text("# upstream order\nc02f\n1301\n009c\n")
    monkeypatch.setenv("SWARM_JARM_CIPHER_TABLE", str(table))
    for mod in (tjarm, jjarm):
        monkeypatch.setattr(mod, "_UPSTREAM_TABLE", None)
        monkeypatch.setattr(mod, "_UPSTREAM_TABLE_LOADED", False)
    assert tjarm.upstream_cipher_table() == jjarm.upstream_cipher_table()
    assert tjarm.upstream_cipher_table() == ("c02f", "1301", "009c")
    banners = BANNER_SETS["mixed"]
    t = tjarm.fingerprint_from_banners("h", 1, banners)
    j = jjarm.fingerprint_from_banners("h", 1, banners)
    assert t.jarm == j.jarm and t.jarm


def test_cipher_table_malformed_raises(tmp_path, monkeypatch):
    table = tmp_path / "bad.txt"
    table.write_text("zz\n")
    monkeypatch.setenv("SWARM_JARM_CIPHER_TABLE", str(table))
    monkeypatch.setattr(tjarm, "_UPSTREAM_TABLE", None)
    monkeypatch.setattr(tjarm, "_UPSTREAM_TABLE_LOADED", False)
    with pytest.raises(RuntimeError, match="malformed"):
        tjarm.upstream_cipher_table()
