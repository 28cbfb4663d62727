#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``swarm_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with one CUDA card, and
prints one JSON line per phase:

1. ``device``  — the card (``nvidia-smi`` name and power limit); exits
   non-zero without a CUDA device.
2. ``build``   — compiles the cluster kernels (``nvcc``, sm_90a), the
   tensor-core rate probe (``ops/csrc/mma_rate.cu``, its own library)
   and the native scan library (``make``) from the checkout's sources,
   in parallel; the seconds are set-up. Prints each cluster kernel's
   registers and shared memory (``ptxas -v``) and fails if ptxas
   reports a spill.
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

Then the ``{"kernels": [...]}`` summary, the ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``. Any failed check raises
and the script exits non-zero without that line.
"""

from __future__ import annotations

import ctypes
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
    hands out one ``jarm`` job over ``targets``."""

    def __init__(self, targets: bytes, api_key: str = API_KEY):
        self.job = {
            "job_id": "jarm_1_0", "scan_id": "jarm_1", "chunk_index": 0,
            "module": "jarm",
        }
        self.targets = targets
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
                if self.path == "/get-input-chunk/jarm_1/0":
                    return self._reply(200, stub.targets)
                self._reply(404)

            def do_POST(self):
                if not self._authorized():
                    return
                body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
                if self.path == "/update-job/jarm_1_0":
                    stub.statuses.append(json.loads(body)["status"])
                    return self._reply(200, b"{}")
                if self.path == "/put-output-chunk/jarm_1/0":
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
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        nvcc = pool.submit(kernels.load_library)
        probe = pool.submit(kernels.compile_library, (MMA_PROBE,), probe_path)
        make = pool.submit(scanio.ensure_lib)
        nvcc.result()
        probe.result()
        make.result()
    ptxas = kernels.ptxas_report(kernels.build_log)
    emit({"phase": "build", "setup_seconds": time.perf_counter() - t0, "ptxas": ptxas})
    built = {k["kernel"].split("<")[0] for k in ptxas}
    for want in ("cluster_counts_kernel", "cluster_parent_kernel"):
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


def phase_trace(big: np.ndarray) -> None:
    """One warm ``density_cluster`` call under ``torch.profiler``: the
    call's span on the host, each kernel's and each copy's span on the
    card, and the share of the call in which the card ran nothing."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from swarm_tpu_torch.ops import cluster

    radius = 40.0
    cluster.density_cluster(big, radius, device="cuda")  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("density_cluster"):
            cluster.density_cluster(big, radius, device="cuda")
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    call = [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name") == "density_cluster"]
    if len(call) != 1:
        raise AssertionError(f"trace: {len(call)} density_cluster spans")
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
            # "(anonymous namespace)::cluster_counts_kernel(uint4 const*, ...)"
            found = re.search(r"(\w+)\(", e["name"])
            short = found.group(1) if found else e["name"]
            kernels_ms[short] = kernels_ms.get(short, 0.0) + float(e["dur"]) / 1e3
    copies_ms = sum(float(e["dur"]) for e in device if e["cat"] != "kernel") / 1e3
    span_ms = (t1 - t0) / 1e3
    # the host steps inside the call (record_function spans of
    # ops/cluster.py) and the card's idle time within each
    host_spans = {}
    for e in events:
        if e.get("cat") != "user_annotation" or e.get("name") not in HOST_SPANS:
            continue
        s0, s1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        busy = _union_us([(max(s0, a), min(s1, b)) for a, b in spans if min(s1, b) > max(s0, a)])
        acc = host_spans.setdefault(e["name"], {"ms": 0.0, "card_idle_ms": 0.0})
        acc["ms"] += (s1 - s0) / 1e3
        acc["card_idle_ms"] += (s1 - s0 - busy) / 1e3
    missing = [name for name in HOST_SPANS if name not in host_spans]
    if missing:
        raise AssertionError(f"trace: no host span for {missing}")
    idle_ms = span_ms - busy_us / 1e3
    emit({
        "phase": "trace", "n": big.shape[0], "radius": radius,
        "call_ms": span_ms, "device_events": len(device),
        "kernels_ms": kernels_ms, "copies_ms": copies_ms,
        "device_busy_ms": busy_us / 1e3,
        "idle_share": (idle_ms / span_ms) if device else None,
        "host_spans": host_spans,
        "idle_outside_spans_ms": idle_ms - sum(v["card_idle_ms"] for v in host_spans.values()),
    })


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
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")
    emit({
        "phase": "worker", "status": stub.statuses[-1], "targets": len(fleet.targets),
        "lines": len(lines), "clusters": len(clusters), "seconds": seconds,
        "launches": launches, "cpu_twin_identical": True,
    })
    return launches


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
    print(json.dumps({"kernels": list(summary.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
