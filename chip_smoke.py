#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``swarm_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with one CUDA card, and
prints one JSON line per phase:

1. ``device``  — the card (``nvidia-smi`` name and power limit); exits
   non-zero without a CUDA device.
2. ``build``   — compiles the cluster kernels, the match kernels, the md5
   kernel and the verdict kernel (``nvcc``, sm_90a, one library a source:
   ``cluster.cu``, ``match.cu``, ``md5.cu``, ``verdicts.cu``), the
   tensor-core rate probe
   (``ops/csrc/mma_rate.cu``, its own library) and the native scan
   library (``make``) from the checkout's sources, all in parallel; the
   seconds are set-up. Prints each kernel's registers and shared memory
   (``ptxas -v``) and fails if ptxas reports a spill.
3. ``mma``     — the probe's ``mma.sync`` rates: 1-bit m16n8k256
   .and.popc (the kernels' product; it prices each kernel's bound, as
   the data sheet gives no 1-bit rate), .xor.popc, and int8 m16n8k32.
4. ``kernels`` — each kernel against its plain PyTorch version on the
   card, at N in {1, 7, 16, 127, 128, 129, 300, 4097, 8193, 65536} on
   random and JARM-like rows and one all-duplicate set of 4,097, radius
   in {0, 0.5, 32, 40, 512}: rho, delta and parent must be exactly equal
   (tolerance 0: all values are integers or integer-valued f32), the
   parent kernel with its 32-bit key and with the 64-bit key it takes
   above 2^21 rows. Then times at N = 65,536, the parent kernel alone
   with either key in turns.
5. ``scale``   — ``density_cluster`` at N = 65,536 fingerprints of 512
   bits, radius 40: fingerprints/s.
6. ``trace``   — one such call under ``torch.profiler``: its span, the
   kernels' and copies' spans on the card, the card's idle share, and
   that idle time split among the call's host steps.
7. ``worker``  — the main path: local TLS listeners answering with
   synthesized ServerHellos, a stdlib stand-in of the server's worker
   routes handing out one ``jarm`` job, and the port's
   ``JobProcessor.process_jobs()`` on ``cuda``. The job must end
   ``complete`` with one line per target, 6 clusters, the dead and
   open-not-tls rows, output byte-identical to the same module run on
   the CPU, and both kernels launched.
8. ``corpus``  — the seeded synthetic corpus of the reference's shape
   (3,989 http templates; 6,895 word, 1,779 regex, 766 dsl matchers),
   compiled by the port; its compiled shape beside the reference's.
9. ``match_kernels`` — each match kernel (``ops/csrc/match.cu``:
   ``match_phase_a``, ``match_verify``, ``match_regex_scan``;
   ``ops/csrc/md5.cu``: ``match_md5``; ``ops/csrc/verdicts.cu``:
   ``match_verdicts``) against its plain version on the card, exact, on
   the very calls ``DeviceDB.match`` makes (``kernels.record_calls``)
   for: a 2,048-row stress batch (max_body 2,048, max_header 512, as
   bench.py, no content dedup), one row, empty rows, rows at full width,
   rows over the candidate budget, a batch over k_pairs, and a batch of
   the ``tests/data/templates`` corpus, whose workflow gates read the
   verdict kernel's m_value; the planes of each against the same batch
   through the plain versions. Then ``match_md5`` on the md5 edge
   lengths (0, 55, 56, 63, 64, 119, 120, W, ...) with bytes past each
   length that are not zero, against its plain version and hashlib, and
   ``match_verdicts`` on the stress batch's call without the digest,
   without the regex overlay, and on random slot planes.
10. ``match``  — ``MatchEngine`` as the worker builds it: its first
   batch as in 9, then ``MatchEngine.match`` of 2,048 rows, warm, called
   for a 2-second window: rows/s over the window (and, apart, the
   median call's rate, which leaves a GC pause out), ms by stage and by
   call, GC collections, unique rows and confirms per batch; a sample
   of rows against the oracle.
11. ``match_trace`` — one such call under ``torch.profiler``.
12. ``fingerprint_worker`` — the main path of the match: the stand-in
   server hands out one ``fingerprint`` job of 2,048 JSONL rows over the
   synthetic corpus, and the port's worker runs it on ``cuda``. It must
   end ``complete`` with one line per row, the first 256 byte-identical
   to the same module on the CPU and a sample to the oracle, and all
   five match kernels launched. The job's kernel calls are recorded.
13. ``match_timing`` — each match kernel on the job's recorded calls:
   exact against its plain version, ms per launch beside its plain
   version's, and its bound from the call's data (for ``match_md5``,
   one thread a row, also its latency bound: the longest row's
   dependent rounds at the card's maximum SM clock).

Then the ``{"kernels": [...]}`` summary (all seven kernels), the ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``. Any failed check raises
and the script exits non-zero without that line.
"""

from __future__ import annotations

import base64
import ctypes
import gc
import hashlib
import http.server
import json
import re
import socket
import struct
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
MMA_PROBE = REPO / "swarm_tpu_torch" / "ops" / "csrc" / "mma_rate.cu"

# H100 SXM data-sheet memory rate (700 W), for each kernel's bound
HBM_BYTES_PER_S = 3.35e12

API_KEY = "chip-smoke"

#: the host steps of ``density_cluster`` (``record_function`` spans)
HOST_SPANS = ("carry_packed", "density_order", "unpermute", "read_back", "label_pass")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# Inputs


def jarm_like_rows(rng: np.random.Generator, n: int) -> np.ndarray:
    """Synthetic JARM-style fingerprints: 64 base TLS stacks + one
    jittered character per host (as bench.py's jarm clustering bench)."""
    from swarm_tpu_torch.ops import cluster

    alphabet = np.frombuffer(b"0123456789abcdef", dtype=np.uint8)
    base = alphabet[rng.integers(0, 16, size=(64, 62))]
    picks = base[rng.integers(0, 64, size=n)].copy()
    jitter = rng.integers(0, 62, size=n)
    picks[np.arange(n), jitter] = alphabet[rng.integers(0, 16, size=n)]
    return cluster.pack_strings([bytes(r) for r in picks])


def random_rows(rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(0, 2**32, size=(n, 16), dtype=np.uint64).astype(np.uint32)


# ---------------------------------------------------------------------------
# Synthetic fingerprint corpus and response rows
#
# The reference's 3,989-template corpus is not in the repository; its
# shape is on record (BASELINE.md:19): 6,895 word, 1,779 regex and 766
# dsl matchers. The generator makes nuclei-shaped http templates of that
# shape from a seed, and the rows are bench.py's realistic mix with
# about one row in ten planted with the fragments of corpus templates.

#: the reference corpus's matcher counts (BASELINE.md:19) and templates
CORPUS_TEMPLATES = 3989
CORPUS_MATCHERS = {"word": 6895, "regex": 1779, "dsl": 766}

_SYLLABLES = (
    "ac", "me", "zor", "tek", "vi", "lo", "na", "qu", "ix", "pro", "dyn",
    "sys", "net", "ware", "cl", "oud", "sec", "gat", "hub", "cor", "flex",
    "ra", "ven", "tor", "ul", "sa", "mi", "ko", "bel", "tri", "um", "ox",
)
#: short dsl literals: the compiler's tiny (1-3 byte) slots
_TINY = ("q7", "zx9", "%$#", "k3y", "v2!", "~~", "0xz", "@@")
_SUFFIXES = ("", " Server", " Manager", " Admin", " Console", " Gateway", " CMS", " Portal")


def _name(rng) -> str:
    n = int(rng.integers(2, 5))
    return "".join(_SYLLABLES[int(i)] for i in rng.integers(0, len(_SYLLABLES), n))


def synthetic_corpus(seed: int = 0, n_templates: int = CORPUS_TEMPLATES,
                     counts: dict | None = None) -> tuple[list, list]:
    """Nuclei-shaped http templates (as parsed YAML dicts) with the given
    word / regex / dsl matcher counts (default: the reference corpus's),
    and the plants: for each template, response fragments that make it
    fire (body text, header lines, a status, or a whole body)."""
    rng = np.random.default_rng(seed)
    if counts is None:
        counts = {k: round(v * n_templates / CORPUS_TEMPLATES) for k, v in CORPUS_MATCHERS.items()}
    words = np.ones(n_templates, dtype=np.int64)
    extra = counts["word"] - n_templates
    np.add.at(words, rng.integers(0, n_templates, max(extra, 0)), 1)
    has_rx = np.zeros(n_templates, bool)
    has_rx[rng.choice(n_templates, counts["regex"], replace=False)] = True
    has_dsl = np.zeros(n_templates, bool)
    has_dsl[rng.choice(n_templates, counts["dsl"], replace=False)] = True
    docs, plants = [], []
    for i in range(n_templates):
        name = _name(rng)
        cap = name.capitalize()
        tid = f"synth-{i:04d}-{name}"
        matchers, extractors = [], []
        plant = {"body": [], "header": [], "status": None, "whole_body": None}
        for w in range(int(words[i])):
            shape = int(rng.integers(0, 6))
            word = (cap, f"powered by {cap}", f"<title>{cap}{_SUFFIXES[w % len(_SUFFIXES)]}</title>",
                    f"{name}.min.js", f"{cap}-Session", f"/{name}/static/")[shape]
            word = word[:40]
            if len(word) < 4:
                word = (word + "-app")[:40]
            part = ("body", "body", "body", "header", "all")[int(rng.integers(0, 5))]
            ci = bool(rng.random() < 0.25)
            m = {"type": "word", "words": [word], "part": part}
            if ci:
                m["case-insensitive"] = True
            if rng.random() < 0.15:
                m["words"].append(f"{cap} {int(rng.integers(1, 99))}")
                m["condition"] = "and" if rng.random() < 0.5 else "or"
            matchers.append(m)
            dest = "header" if part == "header" else "body"
            plant[dest].extend(m["words"] if m.get("condition") == "and" else m["words"][:1])
        if has_rx[i]:
            # about half are linear programs the device regex verifies;
            # the rest (lookarounds) stay prefilters the host confirms
            shape = int(rng.integers(0, 4)) if rng.random() < 0.53 else int(rng.integers(4, 6))
            ver = f"{int(rng.integers(1, 20))}.{int(rng.integers(0, 10))}.{int(rng.integers(0, 10))}"
            if shape == 0:
                pat, part, sample = f"(?i)server: {name}/([0-9.]+)", "header", f"Server: {cap}/{ver}"
            elif shape == 1:
                pat, part, sample = f"<title>{cap} v([0-9]+\\.[0-9]+)</title>", "body", f"<title>{cap} v{ver[:3]}</title>"
            elif shape == 2:
                pat, part, sample = f"{name}_version=([0-9]+)", "body", f"{name}_version={ver.split('.')[0]}"
            elif shape == 3:
                pat, part, sample = f"X-{cap}-Id: [a-f0-9]+", "header", f"X-{cap}-Id: {int(rng.integers(0, 1 << 30)):x}"
            elif shape == 4:
                pat, part, sample = f'<meta name="{name}" content="(?!none)([^"]+)"', "body", f'<meta name="{name}" content="{ver}"'
            else:
                pat, part, sample = f"(?i){name} (?:admin|login)(?= page)", "body", f"{cap} Login page"
            matchers.append({"type": "regex", "regex": [pat], "part": part})
            (plant["header"] if part == "header" else plant["body"]).append(sample)
            if shape in (0, 1, 2, 4):
                extractors.append({"type": "regex", "part": part, "group": 1, "regex": [pat]})
        if has_dsl[i]:
            shape = int(rng.integers(0, 10))
            if shape == 0:
                page = f"<html>{cap} default page</html>"
                dsl = f'md5(body) == "{hashlib.md5(page.encode()).hexdigest()}"'
                plant["whole_body"] = page
            elif shape <= 4:
                word = f"{cap} Dashboard"
                dsl = f'status_code == 200 && contains(body, "{word}")'
                plant["body"].append(word)
                plant["status"] = 200
            elif shape == 5:
                token = _TINY[i % len(_TINY)]
                dsl = f'status_code == 200 && contains(body, "{token}")'
                plant["body"].append(token)
                plant["status"] = 200
            elif shape <= 7:
                word = f"{name}-token"
                dsl = f'contains(tolower(header), "{word}")'
                plant["header"].append(f"Set-Cookie: {word}=1")
            else:
                word = f"{cap} build"
                dsl = f'len(body) > 100 && contains(body, "{word}")'
                plant["body"].append(word)
            matchers.append({"type": "dsl", "dsl": [dsl]})
        cond = "or"
        if rng.random() < 0.25 and plant["status"] in (None, 200):
            # the page and a 200: every matcher must hold
            cond = "and"
            matchers.append({"type": "status", "status": [200]})
            plant["status"] = 200
        doc = {
            "id": tid,
            "info": {"name": f"{cap} detection", "severity": "info", "tags": "tech,synthetic"},
            "http": [{
                "method": "GET", "path": ["{{BaseURL}}"],
                "matchers-condition": cond, "matchers": matchers,
            }],
        }
        if extractors:
            doc["http"][0]["extractors"] = extractors
        docs.append(doc)
        plants.append(plant)
    return docs, plants


def realistic_rows(n: int, seed: int = 7, plants: list | None = None) -> list[dict]:
    """The response mix of bench.py's ``realistic_rows`` (default pages,
    404s, redirects, bare replies, fingerprint-rich pages; content that
    repeats across hosts), as dicts of host, port, status, body and
    header bytes; with ``plants``, about one row in ten carries the
    fragments that make one to three corpus templates fire."""
    rng = np.random.default_rng(seed)
    servers = [
        b"nginx", b"nginx/1.18.0 (Ubuntu)", b"Apache/2.4.41 (Ubuntu)",
        b"Apache", b"cloudflare", b"Microsoft-IIS/10.0", b"openresty",
        b"LiteSpeed", b"AmazonS3", b"gws",
    ]
    rich = [
        b"<html><head><title>Grafana</title></head><body><script>window.grafanaBootData={settings:{buildInfo:{version:\"9.1.0\"}}}</script></body></html>",
        b"<html><head><title>Dashboard [Jenkins]</title></head><body>Jenkins</body></html>",
        b"<html><head><title>phpMyAdmin</title></head><body>phpMyAdmin</body></html>",
        b"<html><head><title>Sign in - GitLab</title></head><body class=gitlab>GitLab</body></html>",
        b"<meta name=\"generator\" content=\"WordPress 6.2\"><html><body>wp-content/themes</body></html>",
        b"<html><head><title>RouterOS router configuration page</title></head><body>mikrotik</body></html>",
    ]
    rows = []
    for i in range(n):
        r = rng.random()
        srv = servers[int(rng.integers(0, len(servers)))]
        extra_hdr = b""
        if r < 0.35:
            body = b"<html><head><title>Welcome to nginx!</title></head><body><h1>Welcome to nginx!</h1></body></html>"
            status = 200
        elif r < 0.55:
            body = b"<html><head><title>404 Not Found</title></head><body><center><h1>404 Not Found</h1></center><hr><center>nginx</center></body></html>"
            status = 404
        elif r < 0.70:
            body = b""
            status = 301
        elif r < 0.80:
            body = b"<html><head><title>403 Forbidden</title></head><body><center><h1>403 Forbidden</h1></center></body></html>"
            status = 403
        elif r < 0.90 or not plants:
            filler = bytes(rng.integers(97, 123, size=int(rng.integers(200, 1500)), dtype=np.uint8))
            body = b"<html><head><title>Home - Example Corp</title></head><body>" + filler + b"</body></html>"
            status = 200
            if r >= 0.90:
                body = rich[int(rng.integers(0, len(rich)))]
        else:
            # planted: the fragments of one to three corpus templates
            status = 200
            parts_b, parts_h = [], []
            whole = None
            for t in rng.choice(len(plants), int(rng.integers(1, 4)), replace=False):
                pl = plants[int(t)]
                parts_b += pl["body"]
                parts_h += pl["header"]
                status = pl["status"] or status
                whole = pl["whole_body"] or whole
            filler = bytes(rng.integers(97, 123, size=int(rng.integers(50, 400)), dtype=np.uint8))
            body = whole.encode() if whole else (
                b"<html><body>" + b" ".join(s.encode() for s in parts_b) + b" " + filler + b"</body></html>"
            )
            extra_hdr = b"".join(b"\r\n" + s.encode() for s in parts_h)
        hdr = (
            b"HTTP/1.1 %d X\r\nServer: %s\r\nContent-Type: text/html\r\n"
            b"Date: Tue, 29 Jul 2026 12:00:00 GMT" % (status, srv)
        ) + extra_hdr
        rows.append({"host": f"192.0.2.{i % 254}", "port": (80, 443, 8080)[i % 3],
                     "status": status, "body": body, "header": hdr})
    return rows


# ---------------------------------------------------------------------------
# Synthetic TLS servers


def server_hello(cipher, legacy=None, exts=(), alpn=b"", supported_version=None) -> bytes:
    """One ServerHello record (no crypto: the probe stops at the first flight)."""
    from swarm_tpu_torch.tls import wire

    legacy = wire.TLS12 if legacy is None else legacy
    ext_list = list(exts)
    if alpn:
        ext_list.append(
            (wire.EXT_ALPN, struct.pack("!HB", len(alpn) + 1, len(alpn)) + alpn)
        )
    if supported_version:
        ext_list.append(
            (wire.EXT_SUPPORTED_VERSIONS, struct.pack("!H", supported_version))
        )
    blob = b"".join(struct.pack("!HH", t, len(d)) + d for t, d in ext_list)
    body = (
        struct.pack("!H", legacy)
        + bytes(32)
        + b"\x00"  # empty session id
        + struct.pack("!H", cipher)
        + b"\x00"
        + struct.pack("!H", len(blob))
        + blob
    )
    hs = bytes([wire.HELLO_SERVER]) + struct.pack("!I", len(body))[1:] + body
    return bytes([wire.HANDSHAKE]) + struct.pack("!HH", legacy, len(hs)) + hs


def server_shapes() -> list[dict]:
    """Six distinct (cipher, extensions, ALPN, version) server choices;
    their fingerprints lie > 100 bits apart."""
    from swarm_tpu_torch.tls import wire

    reneg, ems = (wire.EXT_RENEG, b"\x00"), (wire.EXT_EMS, b"")
    ticket = (wire.EXT_SESSION_TICKET, b"")
    return [
        dict(cipher=0xC02F, exts=(reneg, ems), alpn=b"h2"),
        dict(cipher=0xC030, exts=(reneg,), alpn=b"http/1.1"),
        dict(cipher=0x1301, supported_version=wire.TLS13, alpn=b"h2"),
        dict(cipher=0x009C),
        dict(cipher=0xCCA8, exts=(ems, ticket)),
        dict(cipher=0x1302, supported_version=wire.TLS13, exts=(ticket,)),
    ]


class SyntheticTlsFleet:
    """Local TCP listeners: ``per_shape`` for each of the six server
    shapes, each answering every connection with its ServerHello; one
    plain-TCP listener that answers like an HTTP server; one refused
    port. ``targets`` lists them as ``127.0.0.1:<port>`` lines, in that
    order."""

    def __init__(self, per_shape: int = 8):
        self._stop = threading.Event()
        self._socks: list[socket.socket] = []
        self._threads: list[threading.Thread] = []
        self.targets: list[str] = []
        for shape in server_shapes():
            reply = server_hello(**shape)
            for _ in range(per_shape):
                self.targets.append(self._listen(reply))
        self.plain_target = self._listen(b"HTTP/1.1 400 Bad Request\r\n\r\n")
        self.targets.append(self.plain_target)
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        self.refused_target = f"127.0.0.1:{probe.getsockname()[1]}"
        probe.close()  # bound, never listening: connections are refused
        self.targets.append(self.refused_target)

    def _listen(self, reply: bytes) -> str:
        sock = socket.socket()
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(("127.0.0.1", 0))
        sock.listen(128)
        sock.settimeout(0.1)
        t = threading.Thread(target=self._serve, args=(sock, reply), daemon=True)
        t.start()
        self._socks.append(sock)
        self._threads.append(t)
        return f"127.0.0.1:{sock.getsockname()[1]}"

    def _serve(self, sock: socket.socket, reply: bytes) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with conn:
                try:
                    conn.settimeout(2.0)
                    head = conn.recv(5)  # record header, then its body
                    if len(head) == 5:
                        want = struct.unpack("!H", head[3:5])[0]
                        got = 0
                        while got < want:
                            chunk = conn.recv(want - got)
                            if not chunk:
                                break
                            got += len(chunk)
                    conn.sendall(reply)
                except OSError:
                    pass

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        for s in self._socks:
            s.close()

    def __enter__(self) -> "SyntheticTlsFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class StubServer:
    """Stdlib stand-in for the server's worker routes (``/get-job``,
    ``/get-input-chunk``, ``/put-output-chunk``, ``/update-job``) that
    hands out one job of ``module`` over the input ``blob``."""

    def __init__(self, blob: bytes, module: str = "jarm", api_key: str = API_KEY):
        scan = f"{module}_1"
        self.job = {
            "job_id": f"{scan}_0", "scan_id": scan, "chunk_index": 0,
            "module": module,
        }
        self.targets = blob
        self.statuses: list[str] = []
        self.output: bytes | None = None
        self._handed = False
        stub = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _reply(self, code: int, body: bytes = b"") -> None:
                self.send_response(code)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _authorized(self) -> bool:
                if self.headers.get("Authorization") != f"Bearer {api_key}":
                    self._reply(401)
                    return False
                return True

            def do_GET(self):
                if not self._authorized():
                    return
                if self.path.startswith("/get-job"):
                    if stub._handed:
                        return self._reply(204)
                    stub._handed = True
                    return self._reply(200, json.dumps(stub.job).encode())
                if self.path == f"/get-input-chunk/{scan}/0":
                    return self._reply(200, stub.targets)
                self._reply(404)

            def do_POST(self):
                if not self._authorized():
                    return
                body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
                if self.path == f"/update-job/{scan}_0":
                    stub.statuses.append(json.loads(body)["status"])
                    return self._reply(200, b"{}")
                if self.path == f"/put-output-chunk/{scan}/0":
                    stub.output = body
                    return self._reply(200, b"{}")
                self._reply(404)

        self._httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self._httpd.server_address[1]}"
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


# ---------------------------------------------------------------------------
# Phases


def phase_device() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit({
        "phase": "device", "nvidia_smi": smi,
        "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        "capability": list(torch.cuda.get_device_capability(0)),
        "torch": torch.__version__, "cuda": torch.version.cuda,
    })
    return smi


def phase_build() -> ctypes.CDLL:
    """Build everything; → the rate probe's library."""
    from swarm_tpu_torch.native import scanio
    from swarm_tpu_torch.ops import kernels

    probe_path = kernels.BUILD_DIR / "libswarm_mma_rate.so"
    # built anew from the checkout's sources, so that ptxas reports on
    # every kernel even where an earlier run left the libraries
    for _sources, lib_path in kernels.LIBRARIES.values():
        lib_path.unlink(missing_ok=True)
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(kernels.LIBRARIES) + 2) as pool:
        jobs = [pool.submit(kernels.load_library, name) for name in kernels.LIBRARIES]
        jobs.append(pool.submit(kernels.compile_library, (MMA_PROBE,), probe_path))
        jobs.append(pool.submit(scanio.ensure_lib))
        for job in jobs:
            job.result()
    ptxas = [k for name in kernels.LIBRARIES
             for k in kernels.ptxas_report(kernels.build_logs.get(name, ""))]
    emit({"phase": "build", "setup_seconds": time.perf_counter() - t0, "ptxas": ptxas})
    built = {k["kernel"].split("<")[0] for k in ptxas}
    for want in ("cluster_counts_kernel", "cluster_parent_kernel", "match_phase_a_kernel",
                 "match_verify_kernel", "match_regex_scan_kernel", "match_md5_kernel",
                 "match_verdicts_kernel"):
        if want not in built:
            raise AssertionError(f"build: ptxas reported no {want}")
    spilled = [k for k in ptxas if k.get("spill_stores") or k.get("spill_loads")]
    if spilled:
        raise AssertionError(f"build: ptxas reports spills: {spilled}")
    lib = ctypes.CDLL(str(probe_path))
    lib.mma_rate.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p, ctypes.c_void_p]
    lib.mma_rate.restype = ctypes.c_int
    return lib


def phase_mma(probe: ctypes.CDLL) -> float:
    """The probe's mma.sync rates, each warp issuing 8 independent
    products a round on register operands, 8 warps a block, 8 blocks an
    SM; → the 1-bit .and.popc rate in products/s."""
    import torch

    blocks = 8 * torch.cuda.get_device_properties(0).multi_processor_count
    iters = 2048
    mmas = blocks * 8 * iters * 8
    out = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def launch(variant: int) -> None:
        rc = probe.mma_rate(variant, iters, blocks, ctypes.c_void_p(out.data_ptr()), stream)
        if rc != 0:
            raise RuntimeError(f"mma_rate: CUDA error {rc} at launch")

    rates = {}
    for variant, name, k in ((1, "b1_and_popc_m16n8k256", 256),
                             (2, "b1_xor_popc_m16n8k256", 256), (0, "s8_m16n8k32", 32)):
        ms = cuda_ms(lambda: launch(variant), 3)
        rates[name] = {
            "ms": ms, "mma_per_s": mmas / ms * 1e3,
            "tops": mmas * 16 * 8 * k * 2 / ms / 1e9,
        }
    emit({"phase": "mma", "blocks": blocks, "iters": iters, "rates": rates})
    return rates["b1_and_popc_m16n8k256"]["mma_per_s"]


def sm_clock_hz() -> float:
    """The card's maximum SM clock (``nvidia-smi clocks.max.sm``), Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_kernels(rng: np.random.Generator, big: np.ndarray, b1_mma_per_s: float) -> dict:
    import torch

    from swarm_tpu_torch.ops import cluster, kernels

    sets = []
    for n in (1, 7, 16, 127, 128, 129, 300, 4097, 8193, 65536):
        sets.append((f"random{n}", random_rows(rng, n)))
        sets.append((f"jarm{n}", big if n == 65536 else jarm_like_rows(rng, n)))
    sets.append(("duplicate4097", np.repeat(random_rows(rng, 1), 4097, axis=0)))
    err = {"cluster_counts": 0.0, "cluster_parent": 0.0}
    cases = 0
    for name, packed in sets:
        x = cluster.carry_packed(packed, "cuda")
        for radius in (0.0, 0.5, 32.0, 40.0, 512.0):
            rho = kernels.cluster_counts(x, radius)
            rho_p = cluster.neighbor_counts_plain(x, radius)
            delta, parent = cluster.nearest_denser_in_order(x, rho)
            delta_p, parent_p = cluster.nearest_denser_plain(x, rho)
            # the 64-bit key the wrapper takes above 2^21 rows, here too
            delta_w, parent_w = cluster.nearest_denser_in_order(
                x, rho, lambda r, o: kernels.parent_in_order(r, o, key_shift=32))
            torch.cuda.synchronize()
            e_counts = float((rho - rho_p).abs().max())
            e_parent = max(
                float((delta.double() - delta_p.double()).abs().max()),
                float((parent - parent_p).abs().max()),
                float((delta_w.double() - delta_p.double()).abs().max()),
                float((parent_w - parent_p).abs().max()),
            )
            if e_counts or e_parent or not (
                torch.equal(rho, rho_p) and torch.equal(delta, delta_p)
                and torch.equal(parent, parent_p)
                and torch.equal(delta_w, delta_p) and torch.equal(parent_w, parent_p)
            ):
                raise AssertionError(
                    f"kernel != plain on {name} radius {radius}: "
                    f"counts err {e_counts}, parent err {e_parent}"
                )
            err["cluster_counts"] = max(err["cluster_counts"], e_counts)
            err["cluster_parent"] = max(err["cluster_parent"], e_parent)
            cases += 1

    # times at the scale the main path is sized for
    n = big.shape[0]
    radius = 40.0
    x = cluster.carry_packed(big, "cuda")
    rho = kernels.cluster_counts(x, radius)
    # the parent kernel alone, without the density-order glue (sort,
    # gather, scatter back), with the 32-bit and the 64-bit key in turns
    order = torch.argsort(-rho, stable=True)
    rows, order32 = x.index_select(0, order), order.to(torch.int32)
    key_ms = {21: [], 32: []}
    for shift in (21, 32, 32, 21):
        key_ms[shift].append(cuda_ms(lambda: kernels.parent_in_order(rows, order32, shift), 10))
    del rows, order32
    times = {
        "cluster_counts": (
            cuda_ms(lambda: kernels.cluster_counts(x, radius), 10),
            cuda_ms(lambda: cluster.neighbor_counts_plain(x, radius), 3),
        ),
        "cluster_parent": (
            cuda_ms(lambda: cluster.nearest_denser_in_order(x, rho), 10),
            cuda_ms(lambda: cluster.nearest_denser_plain(x, rho), 3),
        ),
    }
    planes = cluster.unpack_bits(x).to(torch.bfloat16)
    library_ms = cuda_ms(lambda: torch.matmul(planes, planes.T), 5)
    del planes
    torch.cuda.empty_cache()
    # least time: the larger of the bytes read and written once at the HBM
    # rate and the 1-bit products at the rate the mma phase measured.
    # Distance is symmetric and, of two rows, exactly one is the denser,
    # so either function needs each unordered pair once: N(N−1)/2 pairs,
    # 128 a 16×8 tile, one m16n8k256 .and.popc product per 256 bits
    # (hamming = pop_i + pop_j − 2·popc(a & b)), two for 512 bits.
    products = n * (n - 1) / 128
    io_bytes = {
        "cluster_counts": n * 64 + n * 4,
        "cluster_parent": n * 64 + n * 4 + n * 8,
    }
    design = {
        "cluster_counts": (
            "mma.sync b1 m16n8k256 .and.popc (hamming = popc(a&~b) + popc(~a&b)), "
            "packed rows, cp.async 3-stage, full square, threshold in the accumulator"
        ),
        "cluster_parent": (
            "mma.sync b1 m16n8k256 .and.popc, packed rows in density order, "
            "cp.async 3-stage, triangle (row tiles t and T-1-t a block), "
            "(d << 21 | j) min key, (d << 32 | j) above 2^21 rows"
        ),
    }
    out = {}
    for name, line in (("cluster_counts", 91), ("cluster_parent", 124)):
        ms, plain_ms = times[name]
        t_ops = products / b1_mma_per_s * 1e3
        t_bytes = io_bytes[name] / HBM_BYTES_PER_S * 1e3
        out[name] = {
            "name": name,
            "route": "cuda",
            "source": "swarm_tpu_torch/ops/csrc/cluster.cu",
            "replaces": f"swarm_tpu/ops/cluster.py:{line}",
            "design": design[name],
            "launches": 0,  # filled from the main path's run
            "match": True,
            "max_abs_err": err[name],
            "n": n,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_rate": "1-bit mma.sync m16n8k256 .and.popc, measured (mma phase)",
            "library_ms": library_ms,
            "library_call": (
                "torch.matmul bf16 [N,512]x[512,N] of the bit planes: the "
                "matrix-unit work of the Pallas kernel, not the whole function"
            ),
        }
    # the wrapper's time includes the density-order glue
    out["cluster_parent"]["kernel_only_ms"] = float(np.mean(key_ms[21]))
    out["cluster_parent"]["kernel_only_64bit_key_ms"] = float(np.mean(key_ms[32]))
    emit({"phase": "kernels", "cases": cases, "exact": True,
          "timing": {k: {"ms": v["ms"], "plain_ms": v["plain_ms"]} for k, v in out.items()},
          "parent_kernel_only_ms": {"key32": key_ms[21], "key64": key_ms[32]},
          "library_ms": library_ms})
    return out


def phase_scale(big: np.ndarray, smi: str) -> None:
    import torch

    from swarm_tpu_torch.ops import cluster

    n, radius, reps = big.shape[0], 40.0, 5
    labels, rho = cluster.density_cluster(big, radius, device="cuda")  # warm
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        labels, rho = cluster.density_cluster(big, radius, device="cuda")
    stop.record()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    clusters = int(np.unique(labels).size)
    # 64 base stacks, each host one character (≤ 8 bits) from its base:
    # every stack is one cluster
    if labels.shape != (n,) or rho.shape != (n,) or clusters != 64:
        raise AssertionError(f"scale: {clusters} clusters, shapes {labels.shape}")
    emit({
        "phase": "scale", "n": n, "bits": 512, "radius": radius, "reps": reps,
        "seconds": seconds, "fingerprints_per_s": reps * n / seconds,
        "ms_per_call": start.elapsed_time(stop) / reps, "clusters": clusters,
        "card": smi,
    })


def _union_us(spans: list[tuple[float, float]]) -> float:
    """Total length of the union of [start, end) spans."""
    total, reach = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > reach:
            total += e - max(s, reach)
            reach = e
    return total


def profile_call(run, name: str, span_names: tuple) -> dict:
    """One call of ``run`` under ``torch.profiler`` in a span ``name``:
    the call's span on the host, each kernel's and each copy's span on
    the card, the share of the call in which the card ran nothing, and
    the host steps (``record_function`` spans ``span_names``) with the
    card's idle time within each."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(name):
            run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    call = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == name]
    if len(call) != 1:
        raise AssertionError(f"trace: {len(call)} {name} spans")
    t0 = float(call[0]["ts"])
    t1 = t0 + float(call[0]["dur"])
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    spans = [(max(t0, float(e["ts"])), min(t1, float(e["ts"]) + float(e["dur"])))
             for e in device]
    busy_us = _union_us([(s, e) for s, e in spans if e > s])
    kernels_ms = {}
    for e in device:
        if e["cat"] == "kernel":
            # "(anonymous namespace)::cluster_counts_kernel(uint4 const*, ...)",
            # "(anonymous namespace)::match_regex_scan_kernel<3>(Variants, ...)"
            found = re.search(r"(\w+(?:<\d+>)?)\(", e["name"])
            short = found.group(1) if found else e["name"]
            kernels_ms[short] = kernels_ms.get(short, 0.0) + float(e["dur"]) / 1e3
    copies_ms = sum(float(e["dur"]) for e in device if e["cat"] != "kernel") / 1e3
    span_ms = (t1 - t0) / 1e3
    host_spans = {}
    for e in events:
        if e.get("cat") != "user_annotation" or e.get("name") not in span_names:
            continue
        s0, s1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        busy = _union_us([(max(s0, a), min(s1, b)) for a, b in spans if min(s1, b) > max(s0, a)])
        acc = host_spans.setdefault(e["name"], {"ms": 0.0, "card_idle_ms": 0.0})
        acc["ms"] += (s1 - s0) / 1e3
        acc["card_idle_ms"] += (s1 - s0 - busy) / 1e3
    missing = [s for s in span_names if s not in host_spans]
    if missing:
        raise AssertionError(f"trace: no host span for {missing}")
    idle_ms = span_ms - busy_us / 1e3
    return {
        "call_ms": span_ms, "device_events": len(device),
        "kernel_launches": sum(e["cat"] == "kernel" for e in device),
        "kernels_ms": kernels_ms, "copies_ms": copies_ms,
        "device_busy_ms": busy_us / 1e3,
        "idle_share": (idle_ms / span_ms) if device else None,
        "host_spans": host_spans,
        "idle_outside_spans_ms": idle_ms - sum(v["card_idle_ms"] for v in host_spans.values()),
    }


def phase_trace(big: np.ndarray) -> None:
    """One warm ``density_cluster`` call under ``torch.profiler``."""
    import torch

    from swarm_tpu_torch.ops import cluster

    radius = 40.0
    cluster.density_cluster(big, radius, device="cuda")  # warm
    torch.cuda.synchronize()
    out = profile_call(lambda: cluster.density_cluster(big, radius, device="cuda"),
                       "density_cluster", HOST_SPANS)
    out.pop("kernel_launches")
    emit({"phase": "trace", "n": big.shape[0], "radius": radius, **out})


def phase_worker() -> dict:
    from swarm_tpu_torch.ops import kernels
    from swarm_tpu_torch.worker.runtime import JobProcessor, WorkerConfig

    with SyntheticTlsFleet(per_shape=8) as fleet:
        blob = ("\n".join(fleet.targets) + "\n").encode()
        stub = StubServer(blob)
        try:
            cfg = WorkerConfig(
                server_url=stub.url, api_key=API_KEY, worker_id="chip-smoke",
                modules_dir=str(REPO / "modules"), max_jobs=1,
                poll_interval_idle_s=0.05, poll_interval_busy_s=0.0,
            )
            proc = JobProcessor(cfg, device="cuda")
            kernels.reset_launches()
            t0 = time.perf_counter()
            proc.process_jobs()
            seconds = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
        finally:
            stub.close()
        # the same module on the CPU (plain versions) must give the same bytes
        cpu = JobProcessor(cfg, device="cpu")
        twin = cpu._execute_jarm(cpu.registry.load("jarm"), blob)

    want = ["starting", "downloading", "executing", "uploading", "complete"]
    if stub.statuses != want:
        raise AssertionError(f"job statuses {stub.statuses}")
    lines = stub.output.decode().splitlines()
    if len(lines) != len(fleet.targets):
        raise AssertionError(f"{len(lines)} lines for {len(fleet.targets)} targets")
    if not any(ln.endswith("[dead]") for ln in lines):
        raise AssertionError("no [dead] line for the refused port")
    if not any(ln.endswith("[open not-tls]") for ln in lines):
        raise AssertionError("no [open not-tls] line for the plain listener")
    clusters = {ln.split(" cluster=")[1].split()[0] for ln in lines if " cluster=" in ln}
    if len(clusters) != 6:
        raise AssertionError(f"{len(clusters)} clusters, want 6")
    if stub.output != twin:
        raise AssertionError("cuda output differs from the CPU run")
    if min(launches["cluster_counts"], launches["cluster_parent"]) < 1:
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")
    emit({
        "phase": "worker", "status": stub.statuses[-1], "targets": len(fleet.targets),
        "lines": len(lines), "clusters": len(clusters), "seconds": seconds,
        "launches": launches, "cpu_twin_identical": True,
    })
    return launches


# ---------------------------------------------------------------------------
# The template-match path

# bench.py's batch (bench.py:119-121): the stress batch's widths, and the
# rows of the stress batch and of the fingerprint job
MAX_BODY, MAX_HEADER, JOB_ROWS = 2048, 512, 2048
# the match phase's window of warm MatchEngine.match calls, in seconds
# (at least three calls): long enough to take in the GC's pauses
MATCH_WINDOW_S = 2.0
# the reference corpus after compilation (BENCH_r05.json, corpus line)
REFERENCE_COMPILED = {"device_templates": 3750, "word_slots": 14291,
                      "device_regex_matchers": 944, "host_tail": 0}
# H100 SXM data-sheet rate of 32-bit operations outside the tensor cores
# (67 TFLOP/s float32), used as the rate of the kernels' 32-bit integer
# work: Hopper issues int32 at no more than that, so the bound is a floor
SCALAR_OPS_PER_S = 67e12
MATCH_KERNELS = ("match_phase_a", "match_verify", "match_regex_scan", "match_md5",
                 "match_verdicts")
#: md5's dependent chain a round (add, F, add, rotate, add after the
#: independent x + k + a) and the cycles of one dependent integer
#: operation, for the one-thread-a-row kernel's latency bound
MD5_CHAIN_OPS, DEPENDENT_OP_CYCLES = 4, 4
#: the md5 lengths where the padding changes shape (tests/test_torch_verdicts.py)
MD5_EDGE_LENGTHS = (0, 1, 55, 56, 63, 64, 119, 120, 127, 128, 183, 184)


def port_rows(dicts: list) -> list:
    from swarm_tpu_torch.fingerprints.model import Response

    return [Response(**d) for d in dicts]


def jsonl_rows(dicts: list) -> bytes:
    """Rows as the worker's ``jsonl`` input (bytes fields base64)."""
    lines = []
    for d in dicts:
        lines.append(json.dumps({
            "host": d["host"], "port": d["port"], "status": d["status"],
            "body_b64": base64.b64encode(d["body"]).decode(),
            "header_b64": base64.b64encode(d["header"]).decode(),
        }))
    return ("\n".join(lines) + "\n").encode()


def phase_corpus() -> tuple:
    """The synthetic corpus, parsed and compiled by the port."""
    from collections import Counter

    from swarm_tpu_torch.fingerprints.compile import compile_corpus
    from swarm_tpu_torch.fingerprints.nuclei import parse_template

    t0 = time.perf_counter()
    docs, plants = synthetic_corpus(0)
    templates = [parse_template(d) for d in docs]
    db = compile_corpus(templates)
    counts = Counter(m.type for tpl in templates for _, m in tpl.all_matchers())
    compiled = {
        "device_templates": db.num_templates, "word_slots": db.num_slots,
        "tables": len(db.tables), "tiny_slots": int(db.stats["tiny_slots"]),
        "device_regex_matchers": len(db.rx_m_ids), "host_tail": len(db.host_always),
        "md5_matchers": int(db.m_md5_check.sum()),
    }
    emit({"phase": "corpus", "templates": len(templates), "matchers": dict(counts),
          "compiled": compiled, "reference_compiled": REFERENCE_COMPILED,
          "seconds": time.perf_counter() - t0})
    for kind, n in CORPUS_MATCHERS.items():
        if counts[kind] != n:
            raise AssertionError(f"corpus: {counts[kind]} {kind} matchers, want {n}")
    if db.host_always or not db.m_md5_check.any() or not len(db.tiny_slot):
        raise AssertionError(f"corpus: compiled shape {compiled}")
    return templates, plants, db


def plain_versions() -> dict:
    """Each match kernel's plain PyTorch version, by kernel name."""
    from swarm_tpu_torch.ops import match, md5, regexdev

    return {"match_phase_a": match.phase_a_plain, "match_verify": match.verify_plain,
            "match_regex_scan": regexdev.regex_scan_plain, "match_md5": md5.md5_words,
            "match_verdicts": match.verdicts_plain}


class plain_kernels:
    """Route the match path's kernel calls to their plain versions for
    the comparisons here; the port itself never does this."""

    def __enter__(self):
        from swarm_tpu_torch.ops import kernels

        self._saved = {k: getattr(kernels, k) for k in MATCH_KERNELS}
        for name, fn in plain_versions().items():
            setattr(kernels, name, fn)

    def __exit__(self, *exc):
        from swarm_tpu_torch.ops import kernels

        for name, fn in self._saved.items():
            setattr(kernels, name, fn)


def _diff(a, b) -> float:
    """Largest absolute difference of two integer or bool tensors (two
    Nones: a plane neither computed)."""
    import torch

    if a is None or b is None:
        if a is not None or b is not None:
            raise AssertionError("one version computed a plane the other did not")
        return 0.0
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def check_calls(calls: list) -> dict:
    """Replay recorded match-kernel calls (``kernels.record_calls``):
    each kernel and its plain version on the same arguments on the card
    → the largest difference by kernel. Raises on any difference."""
    from swarm_tpu_torch.ops import kernels

    plain = plain_versions()
    err = {k: 0.0 for k in MATCH_KERNELS}
    for name, args in calls:
        got, want = getattr(kernels, name)(*args), plain[name](*args)
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        err[name] = max(err[name], *(_diff(a, b) for a, b in zip(got, want)))
    if any(err.values()):
        raise AssertionError(f"match kernels differ from their plain versions: {err}")
    return err


def _same_planes(planes, planes_p) -> None:
    for i, (a, b) in enumerate(zip(planes[:6], planes_p[:6])):
        if not np.array_equal(a, b):
            raise AssertionError(f"DeviceDB plane {i} differs from the plain versions")
    if (planes[6] is None) != (planes_p[6] is None) or (
        planes[6] is not None and not all(np.array_equal(a, b)
                                          for a, b in zip(planes[6], planes_p[6]))):
        raise AssertionError("workflow planes differ from the plain versions")


def match_case(dev_db, batch) -> dict:
    """One encoded batch through ``DeviceDB.match`` on the card with its
    kernel calls recorded. The planes must equal the same batch through
    the plain versions on the card, and each recorded call its plain
    version on the same arguments (:func:`check_calls`)."""
    from collections import Counter

    from swarm_tpu_torch.ops import kernels

    with kernels.record_calls() as calls:
        planes = dev_db.match(batch.streams, batch.lengths, batch.status)
    lc = dict(dev_db.last_compact)
    with plain_kernels():
        planes_p = dev_db.match(batch.streams, batch.lengths, batch.status)
    _same_planes(planes, planes_p)
    rx = [args for name, args in calls if name == "match_regex_scan"]
    return {
        "workflow_planes": planes[6] is not None,
        "rows": int(len(batch.status)), "budget": lc["budget"],
        "survivor_max": lc.get("survivor_max"), "verify_k": lc.get("verify_k"),
        "overflow_rows": int(planes[5].sum()),
        "k_pairs": sum(int(a[1].shape[0]) for a in rx),
        "rx_pairs": sum(int(a[3].sum()) for a in rx),
        "calls": dict(Counter(name for name, _ in calls)), "err": check_calls(calls),
    }


def kernel_work(name: str, args: tuple) -> tuple:
    """(bytes, operations) that one recorded call of a match kernel must
    move and do for its data, for its bound."""
    import torch

    if name == "match_phase_a":
        # the streams' bytes up to each length and the T blooms read once,
        # col and n_surv written once; 2q multiply-adds a window + a probe
        views, qs, _cs, bloom, budget, _k = args
        rows = views[0].data.shape[0]
        lens = [v.lengths.to(torch.int64) for v in views]
        q_ops = sum(int((n - q + 1).clamp(min=0).sum()) * (4 * int(q) + 8)
                    for n, q in zip(lens, qs))
        streams = {v.data.data_ptr(): int(n.sum()) for v, n in zip(views, lens)}
        return (sum(streams.values()) + bloom.numel() * 4 + rows * budget * 4 + rows * 4,
                q_ops)
    if name == "match_verify":
        # each live candidate's col entry, window, group search, entries
        # and up to 64 verify bytes; both [B, slots] planes written once
        _v, _q, _cs, col, kc, _tab, max_group, _sb, _sl, pw = args
        live = int((col[:, :kc] >= 0).sum())
        return (live * (4 + 8 + 64 + 4 * 16 + max_group * 40) + 2 * col.shape[0] * pw,
                live * (40 + max_group * (16 + 64)))
    if name == "match_md5":
        # each row's walked blocks read once (within the stream's width),
        # the lengths read, the digests (four 32-bit words) written; ~9
        # 32-bit operations a round, 64 rounds a block
        stream, lens, _max_len = args
        blocks = md5_blocks(stream, lens)
        read = (blocks * 64).clamp(max=stream.shape[1])
        rows = stream.shape[0]
        return int(read.sum()) + rows * 4 + rows * 16, int(blocks.sum()) * 64 * 9
    if name == "match_verdicts":
        # both slot planes, the scalars, digest (four 32-bit words) and
        # overlay and the corpus layout read once; the output planes
        # written once: t and op value and unc, m_unc, and m_value only
        # for a corpus with workflow gates; per row, ~6 operations a
        # member gathered and ~20 a matcher
        layout, value, _unc, _ln, _st, digest, rx = args
        rows, ns = value.shape
        nbytes = 2 * rows * ns + rows * (4 + 4 * 5)
        nbytes += 0 if digest is None else rows * 16
        nbytes += 0 if rx is None else 2 * rows * layout.n_rx
        nbytes += sum(t.numel() * t.element_size() for t in layout.csr.values())
        nbytes += rows * (2 * layout.nt + 2 * layout.nop + layout.nm)
        nbytes += rows * layout.nm if layout.has_gates else 0
        members = sum(int(layout.csr[k].numel())
                      for k in ("m_slot_idx", "m_neg_idx", "op_m_idx", "t_op_idx"))
        return nbytes, rows * (6 * members + 20 * layout.nm)
    # match_regex_scan: each live pair's bytes and one bytemap row per
    # byte; the shift-and's lane operations per byte
    variants, pair_b, pair_s, valid, rx, _wt, r_closure = args
    lens = torch.stack([v.lengths for v in variants], 1).to(torch.int64)
    pair_len = lens[pair_b, rx["var_of_seq"].to(torch.int64)[pair_s]]
    scan = int(pair_len[valid].sum())
    lanes = int(rx["bytemap"].shape[2])
    return (scan * (1 + 4 * lanes) + int(pair_b.numel()) * 17,
            scan * lanes * (8 + 3 * int(r_closure)) + scan * 12)


def md5_blocks(stream, lens):
    """Blocks the md5 kernel walks for each row: the padded message's
    floor((len + 72) / 64), at most the stream's width / 64 + 1."""
    return ((lens.to("cpu").long() + 72) // 64).clamp(0, stream.shape[1] // 64 + 1)


def _call_shape(name: str, args: tuple) -> dict:
    if name == "match_md5":
        blocks = md5_blocks(args[0], args[1])
        return {"rows": int(args[0].shape[0]), "width": int(args[0].shape[1]),
                "blocks": int(blocks.sum()), "max_blocks": int(blocks.max())}
    if name == "match_verdicts":
        layout, value = args[0], args[1]
        return {"rows": int(value.shape[0]), "slots": int(value.shape[1]),
                "matchers": layout.nm, "ops": layout.nop, "templates": layout.nt,
                "digest": args[5] is not None, "rx": args[6] is not None,
                "m_value": layout.has_gates}
    if name == "match_phase_a":
        return {"rows": int(args[0][0].data.shape[0]),
                "widths": sorted({int(v.data.shape[1]) for v in args[0]})}
    if name == "match_verify":
        return {"rows": int(args[3].shape[0]), "verify_k": int(args[4]),
                "live_candidates": int((args[3][:, : args[4]] >= 0).sum())}
    return {"pairs": int(args[1].shape[0]), "live_pairs": int(args[3].sum())}


def edge_batches(templates, plants) -> dict:
    """Encoded batches for the kernels' edge cases (no 256-row padding)."""
    from swarm_tpu_torch.fingerprints.model import Response
    from swarm_tpu_torch.ops.encoding import encode_batch

    def enc(rows):
        return encode_batch(rows, max_body=MAX_BODY, max_header=MAX_HEADER,
                            build_all=False, width_multiple=512)

    words = [w.encode() for tpl in templates for _, m in tpl.all_matchers()
             for w in m.words]
    planted = port_rows(realistic_rows(64, seed=3, plants=plants))
    full_body = b" ".join(words)[: MAX_BODY - 3] + b" " + words[0][:2]
    full = Response(host="h", port=80, status=200, body=full_body.ljust(MAX_BODY, b"."),
                    header=(b"Server: " + b" ".join(words[::7]))[:MAX_HEADER].ljust(MAX_HEADER, b"x"))
    # a body of corpus words, longer than the widths: truncated, and more
    # fired windows than the candidate budget
    dense = Response(host="h", port=80, status=200, body=b"".join(words)[: 3 * MAX_BODY],
                     header=b"X-A: " + b"".join(words[:40]))
    return {
        "one_row": enc(planted[:1]),
        "empty_rows": enc([Response(host="e", port=80)] * 5),
        "full_width": enc([full, full]),
        "budget_overflow": enc([dense] + planted[:3]),
    }


def tree_batch():
    """The ``tests/data/templates`` corpus (its workflow lowers gate
    planes) compiled by the port, and 256 encoded rows built from its
    words, statuses, a 16-byte body (its md5 check), a 1,500-byte body
    (its size dsl) and a widget header (its header regex)."""
    from swarm_tpu_torch.fingerprints.compile import compile_corpus
    from swarm_tpu_torch.fingerprints.model import Response
    from swarm_tpu_torch.fingerprints.nuclei import load_corpus
    from swarm_tpu_torch.ops.encoding import encode_batch

    templates, _ = load_corpus(REPO / "tests" / "data" / "templates")
    db = compile_corpus(templates)
    rng = np.random.default_rng(5)
    words = sorted({w for tpl in templates for _, m in tpl.all_matchers() for w in m.words})
    statuses = sorted({s for tpl in templates for _, m in tpl.all_matchers() for s in m.status}
                      | {200, 404})
    rows = []
    for i in range(256):
        pick = [words[j] for j in rng.choice(len(words), int(rng.integers(0, 4)), replace=False)]
        body = ("<html>" + " ".join(pick) + "</html>").encode()
        shape = i % 8
        if shape == 1:
            body = bytes(rng.integers(32, 127, 16, dtype=np.uint8))
        elif shape == 2:
            body = body.ljust(1500, b"x")
        header = b"Server: nginx"
        if shape == 3:
            header += b"\r\nX-Widget-Version: %d.%d" % (i % 7, i % 5)
        rows.append(Response(host=f"t{i}", port=80, status=int(rng.choice(statuses)),
                             body=body, header=header))
    return db, encode_batch(rows, max_body=4096, max_header=1024, build_all=False,
                            width_multiple=512)


def md5_edge_case() -> dict:
    """``match_md5`` on 1,024 rows at each of the worker's and the stress
    batch's body widths: the md5 edge lengths, W - 9, W - 8, W - 1, W and
    random lengths, every byte past a length not zero. Exact against its
    plain version on the card and against hashlib."""
    import torch

    from swarm_tpu_torch.ops import kernels
    from swarm_tpu_torch.ops.md5 import md5_words

    rng = np.random.default_rng(12)
    out = {}
    for width in (MAX_BODY, 4096):
        lens = [n for n in MD5_EDGE_LENGTHS] + [width - 9, width - 8, width - 1, width]
        lens = np.array(lens + rng.integers(0, width + 1, 1024 - len(lens)).tolist(),
                        dtype=np.int32)
        stream = rng.integers(1, 256, (len(lens), width), dtype=np.uint8)
        s, n = torch.from_numpy(stream).cuda(), torch.from_numpy(lens).cuda()
        got = kernels.match_md5(s, n)
        want = md5_words(s, n)
        host = np.stack([np.frombuffer(hashlib.md5(stream[i, :k].tobytes()).digest(), "<u4")
                         for i, k in enumerate(lens)]).astype(np.int64)
        err = max(_diff(got, want), float(np.abs(got.cpu().numpy() - host).max()))
        if err:
            raise AssertionError(f"match_md5 differs at width {width}: {err}")
        out[f"width_{width}"] = {"rows": len(lens), "edge_lengths": len(MD5_EDGE_LENGTHS) + 4}
    return out


def verdict_variants(args: tuple) -> dict:
    """``match_verdicts`` against its plain version on one recorded call
    without its digest (the md5 checks fail closed), without its regex
    overlay, without both, and on seeded random slot planes."""
    import torch

    from swarm_tpu_torch.ops import kernels
    from swarm_tpu_torch.ops.match import verdicts_plain

    layout, value, unc, ln, st, digest, rx = args
    if digest is None or rx is None:
        raise AssertionError("the recorded verdict call has no digest or no overlay")
    gen = torch.Generator(device=value.device).manual_seed(3)
    rand_v = torch.rand(value.shape, generator=gen, device=value.device) < 0.3
    rand_u = torch.rand(value.shape, generator=gen, device=value.device) < 0.2
    variants = {
        "no_digest": (layout, value, unc, ln, st, None, rx),
        "no_rx": (layout, value, unc, ln, st, digest, None),
        "neither": (layout, value, unc, ln, st, None, None),
        "random_planes": (layout, rand_v, rand_u, ln, st, digest, rx),
    }
    out = {}
    for name, a in variants.items():
        got, want = kernels.match_verdicts(*a), verdicts_plain(*a)
        err = max(_diff(x, y) for x, y in zip(got, want))
        if err:
            raise AssertionError(f"match_verdicts differs from its plain version ({name})")
        out[name] = {"t_unc": int(want[1].sum()), "m_unc": int(want[5].sum())}
    return out


def phase_match_kernels(templates, plants, db) -> dict:
    """Each match kernel against its plain version on the card, exact, on
    the calls ``DeviceDB.match`` makes for: a 2,048-row stress batch in
    bench.py's shape (encoded without content dedup, so wider than any
    batch the worker's engine gives), the edge cases, a candidate budget
    small enough that rows overflow it, and k_pairs below the stress
    batch's fired regex pairs; a batch of the workflow corpus
    (:func:`tree_batch`); md5 on its edge lengths (:func:`md5_edge_case`)
    and the verdict kernel on variants of the stress batch's call
    (:func:`verdict_variants`). Exactness only: the kernels are timed on
    the main path's own calls (:func:`phase_match_timing`)."""
    from swarm_tpu_torch.ops import kernels
    from swarm_tpu_torch.ops.encoding import encode_batch
    from swarm_tpu_torch.ops.match import DeviceDB

    dev_db = DeviceDB(db, device="cuda")
    stress = encode_batch(port_rows(realistic_rows(JOB_ROWS, plants=plants)),
                          max_body=MAX_BODY, max_header=MAX_HEADER, build_all=False,
                          width_multiple=512)
    cases = {"stress_2048_raw": match_case(dev_db, stress)}
    with kernels.record_calls() as calls:
        dev_db.match(stress.streams, stress.lengths, stress.status)
    (verdict_args,) = [a for n, a in calls if n == "match_verdicts"]
    variants = verdict_variants(verdict_args)
    del calls, verdict_args
    md5_edges = md5_edge_case()
    tree_db, tree = tree_batch()
    cases["workflow_tree"] = match_case(DeviceDB(tree_db, device="cuda"), tree)
    if not cases["workflow_tree"]["workflow_planes"]:
        raise AssertionError("the tree corpus's batch has no workflow planes")
    for name, batch in edge_batches(templates, plants).items():
        cases[name] = match_case(dev_db, batch)
    small = DeviceDB(db, candidate_k=4, device="cuda")
    small._meta, small._arrays = dev_db._ensure_layout()
    cases["small_budget"] = match_case(small, stress)
    # half the stress batch's fired (row, sequence) pairs fit: the rest
    # stay uncertain. The budget is CompiledDB.rx_k_pairs, shadowed on
    # the instance for this one case.
    fired = cases["stress_2048_raw"]["rx_pairs"]
    if not 2 <= fired < cases["stress_2048_raw"]["k_pairs"]:
        raise AssertionError(f"stress batch: {fired} fired regex pairs")
    half = fired // 2
    db.rx_k_pairs = lambda batch_rows: half
    try:
        cases["k_pairs_overflow"] = match_case(dev_db, stress)
    finally:
        del db.rx_k_pairs
    cases["k_pairs_overflow"]["pairs_over_budget"] = fired - half
    if not cases["budget_overflow"]["overflow_rows"] or not cases["small_budget"]["overflow_rows"]:
        raise AssertionError("no row overflowed the candidate budget")
    if cases["k_pairs_overflow"]["rx_pairs"] != half:
        raise AssertionError("the k_pairs case did not fill its pairs")
    for name, case in cases.items():
        # the tree corpus's batch: no fired regex pair needs the scan
        need = MATCH_KERNELS if name != "workflow_tree" else (
            "match_phase_a", "match_verify", "match_md5", "match_verdicts")
        missing = [k for k in need if not case["calls"].get(k)]
        if missing:
            raise AssertionError(f"case {name} made no call of {missing}")
    emit({"phase": "match_kernels", "exact": True, "cases": cases,
          "verdict_variants": variants, "md5_edges": md5_edges})
    return {k: max(c["err"][k] for c in cases.values()) for k in MATCH_KERNELS}


def phase_match(templates, plants, db, smi: str) -> tuple:
    """``MatchEngine`` as the worker builds it (its default batch_rows,
    max_body and max_header): its first batch's ``DeviceDB.match`` on the
    card against the plain versions (:func:`match_case`); then
    ``MatchEngine.match`` of 2,048 rows, warm, over a window of
    ``MATCH_WINDOW_S`` seconds: rows/s, host seconds by
    stage and of the host work outside the stages (dedup, result
    assembly, the rest), unique rows and confirms per batch; and a
    64-row sample against the oracle."""
    import torch

    from swarm_tpu_torch.ops import cpu_ref
    from swarm_tpu_torch.ops.engine import MatchEngine, _dedup_rows

    eng = MatchEngine(templates, db=db, device="cuda")
    rows = port_rows(realistic_rows(JOB_ROWS, plants=plants))
    first = rows[: eng.batch_rows]
    uniq, _back = _dedup_rows(first)
    first_batch = match_case(eng.device, eng.encode([first[u] for u in uniq]))

    eng.match(rows)  # warm
    torch.cuda.synchronize()
    st0 = dict(eng.stats.__dict__)
    stage = {k: 0.0 for k in ("upload_s", "phase_a_s", "scalar_read_s", "phase_b_s", "collect_s")}
    # calls for MATCH_WINDOW_S seconds, so that the rate takes in the
    # pauses of Python's cyclic GC as a long-running worker pays them;
    # each call's wall ms, and the collections in the window by
    # generation (a full, generation-2 collection walks every object the
    # corpus holds)
    per_call = []
    gc0 = [g["collections"] for g in gc.get_stats()]
    t0 = time.perf_counter()
    while len(per_call) < 3 or time.perf_counter() - t0 < MATCH_WINDOW_S:
        tc = time.perf_counter()
        results = eng.match(rows)
        per_call.append((time.perf_counter() - tc) * 1e3)
        for k in stage:
            stage[k] += eng.device.last_compact.get(k, 0.0)
    seconds = time.perf_counter() - t0
    reps = len(per_call)
    gc_runs = [g["collections"] - n for g, n in zip(gc.get_stats(), gc0)]
    st = {k: v - st0[k] for k, v in eng.stats.__dict__.items()}
    batches = st["batches"]
    # last_compact holds each call's last batch: a batch of each call
    ms = {"encode": st["encode_seconds"] / batches * 1e3}
    ms.update({k[:-2]: v / reps * 1e3 for k, v in stage.items()})
    ms["host_resolution"] = st["host_seconds"] / batches * 1e3
    # MatchEngine.match's host work outside those stages, on one batch:
    # the content dedup, and the per-row assembly of the results
    first_rows = rows[: eng.batch_rows]
    t0 = time.perf_counter()
    _dedup_rows(first_rows)
    outside = {"dedup": (time.perf_counter() - t0) * 1e3}
    packed = eng.match_packed(first_rows)
    t0 = time.perf_counter()
    eng.rowmatches_from_packed(packed, len(first_rows))
    outside["assemble"] = (time.perf_counter() - t0) * 1e3
    outside["rest"] = seconds / batches * 1e3 - sum(ms.values()) - sum(outside.values())

    # a sample against the oracle: every corpus template on 64 rows
    sample = list(range(0, JOB_ROWS, 64))[:48] + [i for i, r in enumerate(results)
                                                  if r.template_ids][:16]
    for i in sample:
        want_ids, want_ext = [], {}
        for tpl in templates:
            res = cpu_ref.match_template(tpl, rows[i])
            if res.matched:
                want_ids.append(tpl.id)
                if res.extractions:
                    want_ext[tpl.id] = res.extractions
        if results[i].template_ids != want_ids or results[i].extractions != want_ext:
            raise AssertionError(f"row {i} differs from the oracle")
    emit({
        "phase": "match", "planes_identical_to_plain": True, "first_batch": first_batch,
        "rows": JOB_ROWS, "batch_rows": eng.batch_rows, "max_body": eng.max_body,
        "max_header": eng.max_header, "reps": reps,
        "rows_per_s": reps * JOB_ROWS / seconds,
        # the median call's rate: leaves out a GC pause, so not the headline
        "rows_per_s_median_call": JOB_ROWS / float(np.median(per_call)) * 1e3,
        "batches_per_call": batches / reps,
        "ms_per_batch": seconds / batches * 1e3, "ms_by_stage": ms,
        "ms_outside_stages": outside, "ms_per_call": per_call, "gc_collections": gc_runs,
        "unique_rows_per_batch": st["unique_rows"] / batches,
        "confirms_per_batch": st["host_confirm_pairs"] / batches,
        "overflow_rows_per_batch": st["overflow_rows"] / batches,
        "last_compact": eng.device.last_compact,
        "hits": sum(len(r.template_ids) for r in results),
        "oracle_sample_rows": len(sample), "card": smi,
    })
    return eng, rows


#: the host steps of one MatchEngine batch (record_function spans)
MATCH_SPANS = (
    "engine.encode", "match.upload", "match.phase_a", "match.scalar_read", "match.verify",
    "match.tiny_slots", "match.md5", "match.regex", "match.verdicts", "match.collect",
    "engine.resolve",
)


def phase_match_trace(eng, rows) -> None:
    """One warm ``MatchEngine.match`` batch under ``torch.profiler``: the
    host time and the card's idle time of each step, the card's busy
    time, and the kernels it ran (the five match kernels by name, the
    torch ops summed)."""
    import torch

    torch.cuda.synchronize()
    out = profile_call(lambda: eng.match(rows), "match_batch", MATCH_SPANS)
    kernels_ms = out.pop("kernels_ms")
    ours = {k: v for k, v in kernels_ms.items() if k.startswith(MATCH_KERNELS)}
    rest = sorted(((v, k) for k, v in kernels_ms.items() if k not in ours), reverse=True)
    emit({
        "phase": "match_trace", "rows": len(rows), "match_kernels_ms": ours,
        "torch_ops_ms": sum(v for v, _ in rest), "top_torch_ops_ms": dict(
            (k[:80], v) for v, k in rest[:6]),
        **out,
    })


def phase_fingerprint_worker(templates, plants, db) -> dict:
    """The main path: the stand-in server hands out one ``fingerprint``
    job of 2,048 JSONL rows, the port's worker runs it on ``cuda``. The
    corpus goes to the worker as YAML files in its templates directory
    when PyYAML is installed; without it, the engine compiled here from
    the same dicts is placed in the worker's per-directory engine cache.
    The job must end ``complete``, one line per row, the first 256 lines
    byte-identical to the same module on the CPU, a sample equal to the
    oracle's, and all five match kernels launched. → (launches, the
    job's recorded kernel calls)."""
    import os
    import tempfile

    from swarm_tpu_torch.ops import cpu_ref, kernels
    from swarm_tpu_torch.ops.engine import MatchEngine, RowMatches
    from swarm_tpu_torch.worker.modules import format_match_line
    from swarm_tpu_torch.worker.runtime import JobProcessor, WorkerConfig

    dicts = realistic_rows(JOB_ROWS, seed=11, plants=plants)
    blob = jsonl_rows(dicts)
    docs, _ = synthetic_corpus(0)
    with tempfile.TemporaryDirectory() as corpus_dir:
        try:
            import yaml

            for doc in docs:
                (Path(corpus_dir) / f"{doc['id']}.yaml").write_text(yaml.safe_dump(doc))
            route = "yaml"
        except ImportError:
            route = "engine_cache"
        saved = os.environ.get("SWARM_TEMPLATES_DIR")
        os.environ["SWARM_TEMPLATES_DIR"] = corpus_dir
        stub = StubServer(blob, module="fingerprint")
        try:
            cfg = WorkerConfig(
                server_url=stub.url, api_key=API_KEY, worker_id="chip-smoke",
                modules_dir=str(REPO / "modules"), max_jobs=1,
                poll_interval_idle_s=0.05, poll_interval_busy_s=0.0,
            )
            proc = JobProcessor(cfg, device="cuda")
            if route == "engine_cache":
                proc.engines[corpus_dir] = MatchEngine(templates, db=db, device="cuda")
            kernels.reset_launches()
            t0 = time.perf_counter()
            with kernels.record_calls() as calls:
                proc.process_jobs()
            seconds = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            # the same module on the CPU (plain versions), first 256 rows
            cpu = JobProcessor(cfg, device="cpu")
            cpu.engines[corpus_dir] = MatchEngine(templates, db=db, device="cpu")
            head = b"".join(blob.splitlines(keepends=True)[:256])
            twin = cpu._execute_tpu(cpu.registry.load("fingerprint"), head)
        finally:
            stub.close()
            if saved is None:
                os.environ.pop("SWARM_TEMPLATES_DIR", None)
            else:
                os.environ["SWARM_TEMPLATES_DIR"] = saved

    want = ["starting", "downloading", "executing", "uploading", "complete"]
    if stub.statuses != want:
        raise AssertionError(f"fingerprint job statuses {stub.statuses}")
    lines = stub.output.decode().splitlines()
    if len(lines) != len(dicts):
        raise AssertionError(f"{len(lines)} lines for {len(dicts)} rows")
    if lines[:256] != twin.decode().splitlines():
        raise AssertionError("cuda output differs from the CPU run")
    rows = port_rows(dicts)
    for i in range(0, len(rows), 97):
        ids, ext = [], {}
        for tpl in templates:
            res = cpu_ref.match_template(tpl, rows[i])
            if res.matched:
                ids.append(tpl.id)
                if res.extractions:
                    ext[tpl.id] = res.extractions
        if lines[i] != format_match_line(rows[i], RowMatches(ids, ext)):
            raise AssertionError(f"line {i} differs from the oracle")
    missing = [k for k in MATCH_KERNELS if launches[k] < 1]
    if missing:
        raise AssertionError(f"match kernels not launched on the main path: {missing}")
    emit({
        "phase": "fingerprint_worker", "status": stub.statuses[-1], "route": route,
        "rows": len(dicts), "lines": len(lines), "seconds": seconds,
        "rows_with_hits": sum('"matches": []' not in ln for ln in lines),
        "launches": launches, "cpu_twin_identical_rows": 256,
    })
    return launches, calls


def phase_match_timing(calls: list, smi: str) -> dict:
    """Each match kernel on the exact calls the ``fingerprint`` job made
    (``kernels.record_calls`` around the worker run: its batches as the
    worker's engine deduplicated and encoded them): exact against its
    plain version, then its ms per launch (CUDA events) beside its plain
    version's, and its bound from each call's data, all averaged over
    the job's calls."""
    from swarm_tpu_torch.ops import kernels

    max_err = check_calls(calls)
    plain = plain_versions()
    clock_hz = sm_clock_hz()
    timing = {}
    for name in MATCH_KERNELS:
        per = []
        for call_name, args in calls:
            if call_name != name:
                continue
            nbytes, ops = kernel_work(name, args)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / SCALAR_OPS_PER_S * 1e3
            shape = _call_shape(name, args)
            if name == "match_md5":
                # one thread a row: the longest row's dependent rounds
                shape["latency_ms"] = (shape["max_blocks"] * 64 * MD5_CHAIN_OPS
                                       * DEPENDENT_OP_CYCLES / clock_hz * 1e3)
            per.append({
                **shape,
                "ms": cuda_ms(lambda a=args: getattr(kernels, name)(*a), 10),
                "plain_ms": cuda_ms(lambda a=args: plain[name](*a), 2),
                "bytes": nbytes, "operations": ops,
                "bytes_ms": t_bytes, "operations_ms": t_ops,
            })
        if not per:
            raise AssertionError(f"the job made no call of {name}")
        mean = {k: sum(p[k] for p in per) / len(per)
                for k in ("ms", "plain_ms", "bytes_ms", "operations_ms")}
        timing[name] = {
            "ms": mean["ms"], "plain_ms": mean["plain_ms"],
            "bound_ms": sum(max(p["bytes_ms"], p["operations_ms"]) for p in per) / len(per),
            "bound_by": "operations" if mean["operations_ms"] >= mean["bytes_ms"] else "bytes",
            "calls": per,
        }
        if name == "match_md5":
            timing[name]["latency_bound_ms"] = sum(p["latency_ms"] for p in per) / len(per)
    emit({"phase": "match_timing", "exact": True, "timing": timing, "sm_clock_hz": clock_hz,
          "card": smi})
    return timing, max_err


def main() -> int:
    smi = phase_device()
    import torch

    probe = phase_build()
    b1_rate = phase_mma(probe)
    rng = np.random.default_rng(0)
    big = jarm_like_rows(rng, 65536)
    summary = phase_kernels(rng, big, b1_rate)
    phase_scale(big, smi)
    phase_trace(big)
    launches = phase_worker()
    for name, entry in summary.items():
        entry["launches"] = launches[name]
    templates, plants, db = phase_corpus()
    max_err = phase_match_kernels(templates, plants, db)
    eng, rows = phase_match(templates, plants, db, smi)
    phase_match_trace(eng, rows)
    del eng
    launches, calls = phase_fingerprint_worker(templates, plants, db)
    timing, job_err = phase_match_timing(calls, smi)
    del calls
    replaces = {
        "match_phase_a": "swarm_tpu/ops/match.py:1350",
        "match_verify": "swarm_tpu/ops/match.py:1465",
        "match_regex_scan": "swarm_tpu/ops/regexdev.py:134",
        "match_md5": "swarm_tpu/ops/md5.py:42",
        "match_verdicts": "swarm_tpu/ops/match.py:1807",
    }
    sources = {"match_md5": "swarm_tpu_torch/ops/csrc/md5.cu",
               "match_verdicts": "swarm_tpu_torch/ops/csrc/verdicts.cu"}
    for name in MATCH_KERNELS:
        t = timing[name]
        summary[name] = {
            "name": name, "route": "cuda",
            "source": sources.get(name, "swarm_tpu_torch/ops/csrc/match.cu"),
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(max_err[name], job_err[name]),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "job_rows": JOB_ROWS,
        }
        if "latency_bound_ms" in t:
            summary[name]["latency_bound_ms"] = t["latency_bound_ms"]
    print(json.dumps({"kernels": list(summary.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
