"""The port's HTTP front end (``repro_torch.serving.frontend``).

The reference's seven front-end cases (``tests/test_frontend.py``) run
against the port, each over a port ``Engine`` and over a 1P+1D
``DisaggEngine`` (reduced tinyllama on the CPU, one front end on an
ephemeral loopback port per engine): plain and SSE round trips, a request
timeout keeping its partial tokens, validation and routing errors, the
GET endpoints, a structured 429 on a saturated queue, and a disconnect
freeing its slot. The HTTP tokens equal ``generate``'s for the same
prompt, and ``/stats`` serializes the engine's stats.

The reference's 429 case keeps its one slot busy with a JAX compile and
a 0.15 s sleep. The port compiles nothing, so a gate the test controls
holds the serving engine's decode chunk instead: the engine thread is
parked inside the running request's chunk while the test puts B, then C,
into the front end's inbox, so B queues and C is refused, whatever the
machine's speed.
"""
import http.client
import json
import socket
import threading
import time

import pytest
import torch

from repro_torch.configs.base import get_arch
from repro_torch.models import transformer as T
from repro_torch.serving.disagg import DisaggEngine
from repro_torch.serving.engine import Engine, ServeConfig
from repro_torch.serving.frontend import Frontend, FrontendConfig

torch.set_num_threads(2)

PROMPT = [3, 1, 4, 1, 5, 9]
SCFG = dict(max_new_tokens=8, cache_len=128, decode_chunk=1, max_slots=1,
            prefill_bucket=16, max_queue=1)


class _Gate:
    """Parks the serving engine's ``_run_chunk`` while held."""

    def __init__(self, eng):
        self.open = threading.Event()
        self.open.set()
        self.parked = threading.Event()
        run_chunk = eng._run_chunk

        def gated():
            if not self.open.is_set():
                self.parked.set()
                self.open.wait(60)
            run_chunk()
        eng._run_chunk = gated


@pytest.fixture(scope="module", params=["engine", "disagg"])
def fe(request):
    cfg = get_arch("tinyllama-1.1b", reduced=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    if request.param == "engine":
        eng = Engine(cfg, params, ServeConfig(**SCFG), device="cpu")
        serving = eng
    else:
        eng = DisaggEngine(cfg, params, ServeConfig(**SCFG), device="cpu")
        serving = eng.decode_engines[0]
    expect = {n: eng.generate([PROMPT])[0][:n] for n in (3, 4, 5)}
    front = Frontend(eng, FrontendConfig(model_name="tiny-test",
                                         request_timeout_s=30.0)).start()
    front.gate = _Gate(serving)
    front.serving = serving
    front.expect = expect
    yield front
    front.close()


def _post(fe, payload, timeout=90.0):
    conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=timeout)
    conn.request("POST", "/v1/completions", json.dumps(payload),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    return resp.status, body


def _get(fe, path):
    conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    return resp.status, body


def _wait(cond, what, limit=30.0):
    deadline = time.time() + limit
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.01)
    pytest.fail(f"timed out waiting for {what}")


def test_completion_roundtrip(fe):
    status, body = _post(fe, dict(prompt=PROMPT, max_tokens=5))
    assert status == 200
    choice = body["choices"][0]
    assert choice["token_ids"] == fe.expect[5]
    assert choice["finish_reason"] == "length"
    assert body["model"] == "tiny-test"
    assert body["usage"] == dict(prompt_tokens=len(PROMPT),
                                 completion_tokens=5,
                                 total_tokens=len(PROMPT) + 5)
    assert body["timing"]["ttft_s"] > 0
    assert body["timing"]["queue_wait_s"] >= 0
    assert _post(fe, dict(prompt=PROMPT, max_tokens=5))[1][
        "choices"][0]["token_ids"] == choice["token_ids"]


def test_streaming_sse(fe):
    conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=90)
    conn.request("POST", "/v1/completions",
                 json.dumps(dict(prompt=PROMPT, max_tokens=4, stream=True)),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "text/event-stream"
    events = []
    for raw in resp.read().split(b"\n\n"):
        if raw.startswith(b"data: ") and raw != b"data: [DONE]":
            events.append(json.loads(raw[len(b"data: "):]))
    conn.close()
    toks = [e["choices"][0]["token_id"] for e in events
            if "token_id" in e["choices"][0]]
    final = events[-1]
    assert toks == fe.expect[4]
    assert final["choices"][0]["finish_reason"] == "length"
    assert final["usage"]["completion_tokens"] == 4
    assert _post(fe, dict(prompt=PROMPT, max_tokens=4))[1][
        "choices"][0]["token_ids"] == toks


def test_request_timeout_keeps_partial_tokens(fe):
    """An overdue request is cancelled through cancel(): finish_reason
    "timeout", the tokens it already streamed kept."""
    status, body = _post(fe, dict(prompt=PROMPT, max_tokens=64,
                                  timeout_s=0.001))
    assert status == 200
    assert body["choices"][0]["finish_reason"] == "timeout"
    assert len(body["choices"][0]["token_ids"]) < 64


def test_validation_and_routing_errors(fe):
    status, body = _post(fe, dict(prompt="text prompt"))
    assert status == 400 and "token ids" in body["error"]["message"]
    assert _post(fe, dict())[0] == 400
    assert _post(fe, dict(prompt=PROMPT, max_tokens=0))[0] == 400
    conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=30)
    conn.request("POST", "/v1/completions", b"{not json",
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 400
    assert json.loads(resp.read())["error"]["type"] == \
        "invalid_request_error"
    conn.close()
    assert _get(fe, "/nope")[0] == 404


def test_get_endpoints(fe):
    status, body = _get(fe, "/health")
    assert status == 200 and body["status"] == "ok"
    assert body["model"] == "tiny-test"
    status, body = _get(fe, "/v1/models")
    assert status == 200 and body["data"][0]["id"] == "tiny-test"
    status, body = _get(fe, "/stats")
    assert status == 200
    assert body["frontend"]["completions"] > 0
    assert "requests" in body["engine"]
    json.dumps(fe.engine.stats)         # the router's dict included


def test_saturation_returns_structured_429(fe):
    """max_slots=1, max_queue=1: with A in the slot (parked in its decode
    chunk) and B queued, C is shed with HTTP 429 and the machine-readable
    reason; B and A then serve to the end."""
    gate = fe.gate
    gate.parked.clear()
    gate.open.clear()
    conns = []
    try:
        a = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=90)
        conns.append(a)
        a.request("POST", "/v1/completions",
                  json.dumps(dict(prompt=PROMPT * 4, max_tokens=100,
                                  stream=True)),
                  {"Content-Type": "application/json"})
        ra = a.getresponse()
        assert ra.status == 200
        _wait(gate.parked.is_set, "A to reach its decode chunk")
        b = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=90)
        conns.append(b)
        b.request("POST", "/v1/completions",
                  json.dumps(dict(prompt=PROMPT, max_tokens=2)),
                  {"Content-Type": "application/json"})
        _wait(lambda: fe._inbox.qsize() >= 1, "B in the inbox")
        c = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=90)
        conns.append(c)
        c.request("POST", "/v1/completions",
                  json.dumps(dict(prompt=PROMPT, max_tokens=2)),
                  {"Content-Type": "application/json"})
        _wait(lambda: fe._inbox.qsize() >= 2, "C in the inbox")
    finally:
        gate.open.set()
    rc = c.getresponse()
    body = json.loads(rc.read())
    assert rc.status == 429
    assert body["error"]["type"] == "engine_saturated"
    assert body["error"]["reason"] == "queue_full"
    rb = b.getresponse()
    assert rb.status == 200
    assert json.loads(rb.read())["choices"][0]["token_ids"] == \
        fe.expect[3][:2]
    assert ra.read().endswith(b"data: [DONE]\n\n")
    for conn in conns:
        conn.close()


def test_disconnect_cancels_request(fe):
    """A client that vanishes mid-stream does not keep its slot: the next
    token write fails, the handler cancels through the inbox, the slot
    frees and the next request serves."""
    before = _get(fe, "/stats")[1]["frontend"]["disconnects"]
    s = socket.create_connection(("127.0.0.1", fe.port), timeout=30)
    payload = json.dumps(dict(prompt=PROMPT, max_tokens=120,
                              stream=True)).encode()
    s.sendall(b"POST /v1/completions HTTP/1.1\r\n"
              b"Host: x\r\nContent-Type: application/json\r\n"
              + f"Content-Length: {len(payload)}\r\n\r\n".encode()
              + payload)
    assert s.recv(64)                    # the stream started
    s.close()
    _wait(lambda: _get(fe, "/stats")[1]["frontend"]["disconnects"] > before,
          "the disconnect to cancel the request")
    _wait(lambda: all(r is None for r in fe.serving._slots),
          "the slot to free")
    status, body = _post(fe, dict(prompt=PROMPT, max_tokens=3))
    assert status == 200
    assert body["choices"][0]["token_ids"] == fe.expect[3]
