"""The five cases of ``tests/test_client_stream.py`` on the port: the
port's ``JobClient`` and ``swarm stream`` follow action against the
port's ``SwarmServer`` (docs/GATEWAY.md), on the CPU: chunks that
complete out of order, some after the stream attached, arrive in
index order; a server restart mid-stream resumes from the last acked
chunk through the idempotent chunk store; a dead-letter chunk is
skipped; an idle-timeout record makes the client reconnect from its
cursor; and the CLI's follow mode prints the chunks."""

import json
import threading
import time

import requests

from swarm_tpu_torch.client.cli import JobClient
from swarm_tpu_torch.config import Config
from swarm_tpu_torch.server.app import SwarmServer

from test_torch_server import one_torch_thread  # noqa: F401


def _make_server(tmp_path, **kw) -> SwarmServer:
    cfg = Config(
        host="127.0.0.1", port=0, api_key="sk",
        blob_root=str(tmp_path / "blobs"), doc_root=str(tmp_path / "docs"),
        gateway_stream_poll_s=0.01, gateway_stream_idle_timeout_s=5.0,
        **kw,
    )
    srv = SwarmServer(cfg)
    srv.start_background()
    return srv


def _submit(srv, scan_id, chunks):
    resp = requests.post(
        f"http://127.0.0.1:{srv.port}/queue",
        json={
            "module": "echo",
            "file_content": [f"row{i}\n" for i in range(chunks)],
            "batch_size": 1, "scan_id": scan_id,
        },
        headers={"Authorization": "Bearer sk"},
        timeout=10,
    )
    assert resp.status_code == 200


def _complete_chunk(srv, scan_id, index, worker="w"):
    """Walk one chunk through the real HTTP worker surface."""
    base = f"http://127.0.0.1:{srv.port}"
    auth = {"Authorization": "Bearer sk"}
    requests.post(
        base + f"/put-output-chunk/{scan_id}/{index}",
        data=f"output-{index}\n".encode(), headers=auth, timeout=10,
    )
    requests.post(
        base + f"/update-job/{scan_id}_{index}",
        json={"status": "complete"}, headers=auth, timeout=10,
    )


def _lease_all(srv, scan_id, chunks):
    leased = []
    base = f"http://127.0.0.1:{srv.port}"
    for _ in range(chunks):
        r = requests.get(
            base + "/get-job", params={"worker_id": "w"},
            headers={"Authorization": "Bearer sk"}, timeout=10,
        )
        if r.status_code == 200:
            leased.append(r.json()["job_id"])
    return leased


def test_stream_orders_chunks_and_sees_mid_stream_arrival(tmp_path):
    """Chunks completing OUT of order, some landing after the stream
    is already attached, arrive at the client IN index order."""
    srv = _make_server(tmp_path)
    try:
        _submit(srv, "s_1", 4)
        _lease_all(srv, "s_1", 4)
        _complete_chunk(srv, "s_1", 1)  # out of order before attach

        client = JobClient(f"http://127.0.0.1:{srv.port}", "sk")
        got: list = []

        def consume():
            for chunk, text in client.stream_results("s_1"):
                got.append((chunk, text))

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        time.sleep(0.3)  # stream attached, waiting on chunk 0
        assert got == []  # chunk 1 must NOT arrive before chunk 0
        _complete_chunk(srv, "s_1", 0)
        _complete_chunk(srv, "s_1", 3)
        time.sleep(0.3)
        _complete_chunk(srv, "s_1", 2)  # unblocks 2 then 3
        t.join(timeout=15)
        assert not t.is_alive(), "stream did not terminate on scan end"
        assert got == [(i, f"output-{i}\n") for i in range(4)]
    finally:
        srv.shutdown()


def test_stream_resumes_after_server_restart_from_last_acked(tmp_path):
    """Mid-stream disconnect + full server restart (fresh in-memory job
    table, SAME durable chunk store): the client reconnects with
    ?from=<last acked + 1> and the new server serves the remaining
    chunks from the idempotent blob store, then ends the stream."""
    srv = _make_server(tmp_path)
    port1 = srv.port
    _submit(srv, "s_2", 4)
    _lease_all(srv, "s_2", 4)
    for i in range(4):
        _complete_chunk(srv, "s_2", i)

    # consume exactly 2 records over the raw wire, then sever
    resp = requests.get(
        f"http://127.0.0.1:{port1}/stream/s_2",
        headers={"Authorization": "Bearer sk"}, stream=True, timeout=10,
    )
    acked = []
    for line in resp.iter_lines():
        if not line:
            continue
        rec = json.loads(line)
        acked.append(rec["chunk"])
        if len(acked) == 2:
            break
    resp.close()  # client-side disconnect mid-stream
    assert acked == [0, 1]
    srv.shutdown()  # the restart: job records die with the process

    srv2 = _make_server(tmp_path)  # same blob_root — the durable store
    try:
        client = JobClient(f"http://127.0.0.1:{srv2.port}", "sk")
        rest = list(client.stream_results("s_2", from_chunk=acked[-1] + 1))
        assert rest == [(2, "output-2\n"), (3, "output-3\n")]
    finally:
        srv2.shutdown()


def test_stream_skips_dead_letter_chunk(tmp_path):
    """A chunk that exhausts its attempts (dead letter) yields a skip —
    the stream moves past it instead of hanging forever."""
    srv = _make_server(tmp_path, max_attempts=1, retry_failed=True)
    try:
        _submit(srv, "s_3", 3)
        base = f"http://127.0.0.1:{srv.port}"
        auth = {"Authorization": "Bearer sk"}
        # lease all three; fail chunk 1 with a fenced terminal (one
        # attempt budget → straight to dead letter)
        jobs = _lease_all(srv, "s_3", 3)
        assert len(jobs) == 3
        _complete_chunk(srv, "s_3", 0)
        requests.post(
            base + "/update-job/s_3_1",
            json={"status": "cmd failed", "worker_id": "w"},
            headers=auth, timeout=10,
        )
        _complete_chunk(srv, "s_3", 2)
        client = JobClient(base, "sk")
        got = list(client.stream_results("s_3"))
        assert got == [(0, "output-0\n"), (2, "output-2\n")]
    finally:
        srv.shutdown()


def test_stream_idle_timeout_record_then_client_reconnects(tmp_path):
    """The server bounds stream handler lifetime with an idle-timeout
    record; the CLIENT treats it as a reconnect signal and continues
    from the cursor without data loss."""
    srv = _make_server(tmp_path)
    srv.cfg.gateway_stream_idle_timeout_s = 0.3
    try:
        _submit(srv, "s_4", 2)
        _lease_all(srv, "s_4", 2)
        _complete_chunk(srv, "s_4", 0)
        client = JobClient(f"http://127.0.0.1:{srv.port}", "sk")
        got: list = []

        def consume():
            for chunk, text in client.stream_results(
                "s_4", reconnect_delay_s=0.05
            ):
                got.append(chunk)

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        time.sleep(0.8)  # at least one idle timeout + reconnect cycle
        assert got == [0]
        _complete_chunk(srv, "s_4", 1)
        t.join(timeout=15)
        assert not t.is_alive()
        assert got == [0, 1]
    finally:
        srv.shutdown()


def test_cli_stream_follow_action_prints_chunks(tmp_path, capsys):
    """`swarm stream --scan-id X` (no --module) = follow mode."""
    from swarm_tpu_torch.client.cli import main as cli_main

    srv = _make_server(tmp_path)
    try:
        _submit(srv, "s_5", 2)
        _lease_all(srv, "s_5", 2)
        _complete_chunk(srv, "s_5", 0)
        _complete_chunk(srv, "s_5", 1)
        rc = cli_main(
            ["stream", "--scan-id", "s_5",
             "--server-url", f"http://127.0.0.1:{srv.port}",
             "--api-key", "sk"]
        )
        out = capsys.readouterr().out
        assert rc == 0
        assert out == "output-0\noutput-1\n"
    finally:
        srv.shutdown()
