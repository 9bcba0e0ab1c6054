"""Stdlib service client — submit/stream/fetch against the RPC front end.

A copy of :mod:`deap_tpu.serving.client`: the consumer half of
:mod:`deap_tpu_torch.serving.service`'s wire protocol. It imports
**nothing heavier than numpy** (for the byte-exact array codec in
:mod:`~deap_tpu_torch.serving.wire`): a box that submits jobs and reads
results never loads torch. One client per thread — it holds a single
keep-alive ``http.client`` connection.

::

    from deap_tpu_torch.serving.client import ServiceClient

    c = ServiceClient(service_url, token="s3cret")
    tid = c.submit("onemax", params={"seed": 7, "ngen": 40})
    for ev in c.stream(tid):          # NDJSON per-segment events
        print(ev["event"], ev.get("gen"))
    res = c.result(tid, wait=True)    # wire-encoded result pytree
    leaves = c.decode_leaves(res)     # numpy arrays, byte-exact
"""

from __future__ import annotations

import http.client
import json
import os
import socket
import sys
import threading
import urllib.parse
from typing import Any, Dict, Iterator, List, Optional

if "deap_tpu_torch" in sys.modules:
    from deap_tpu_torch.serving import wire
    from deap_tpu_torch.resilience.retry import RetryPolicy
    from deap_tpu_torch.telemetry import tracing
else:
    # standalone load (no deap_tpu_torch in the process — e.g. a submit
    # box that must never load torch): pull the codec and the retry
    # policy in by file path instead of importing the package, whose
    # __init__ imports torch. tests/test_torch_isolation.py pins the
    # no-torch guarantee in a subprocess.
    import importlib.util as _ilu
    import os as _os

    def _load(name: str, *relpath: str):
        spec = _ilu.spec_from_file_location(
            name,
            _os.path.join(_os.path.dirname(_os.path.abspath(__file__)),
                          *relpath))
        mod = _ilu.module_from_spec(spec)
        # register BEFORE exec: dataclass processing (tracing's
        # TraceContext) resolves string annotations through
        # sys.modules[cls.__module__]
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        return mod

    wire = _load("_deap_tpu_torch_serving_wire_standalone", "wire.py")
    RetryPolicy = _load("_deap_tpu_torch_resilience_retry_standalone",
                        _os.pardir, "resilience", "retry.py").RetryPolicy
    tracing = _load("_deap_tpu_torch_telemetry_tracing_standalone",
                    _os.pardir, "telemetry", "tracing.py")

__all__ = ["ClientAbandoned", "ServiceClient", "ServiceError",
           "RetryPolicy"]


class ClientAbandoned(RuntimeError):
    """Raised locally when this client's ``abandon_after_s`` fired:
    the long-poll socket was closed mid-wait (the load generator's
    impatient-client model). The *server* never sees an error — its
    handler thread wakes at ``view.done`` or the ``max_poll_s`` clamp,
    the response write fails with a caught ``BrokenPipeError``, and
    the tenant keeps running (now idle: ``gens_since_interaction``
    grows until the autoscaler spills it)."""


class ServiceError(RuntimeError):
    """A non-2xx response from the service (``.code`` holds the HTTP
    status; 401/403 auth, 404 unknown, 429 quota/overload — then
    ``.retry_after`` carries the server's Retry-After seconds — 503
    draining, 504 deadline exceeded)."""

    def __init__(self, code: int, message: str,
                 retry_after: Optional[float] = None,
                 payload: Optional[Dict[str, Any]] = None):
        super().__init__(f"HTTP {code}: {message}")
        self.code = code
        self.retry_after = retry_after
        self.payload = payload or {}


#: HTTP statuses a retrying client may safely re-attempt: 429 is an
#: explicit "come back later" (load shed / quota) and 503 a draining /
#: restarting service. 504 (deadline exceeded) is FINAL by design and
#: anything else is the caller's bug, not the network's.
RETRYABLE_STATUSES = (429, 503)


class ServiceClient:
    """One service connection, optionally self-healing.

    ``retry=RetryPolicy(...)`` turns on transparent retries: connection
    errors (a killed/restarting service) back off on the policy's
    jittered exponential schedule, and 429/503 responses honour the
    server's ``Retry-After`` (never less than the policy's own delay).
    Retrying a **submit** is only safe with an idempotency key — the
    first attempt may have been durably accepted while its response
    was lost; the key maps the retry back to the same tenant
    (``idempotent_replay``). Without ``retry``: a single reconnect
    attempt on a stale keep-alive."""

    def __init__(self, base_url: str, token: Optional[str] = None,
                 timeout: float = 600.0,
                 retry: Optional[RetryPolicy] = None,
                 abandon_after_s: Optional[float] = None):
        u = urllib.parse.urlparse(base_url)
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or 80
        self.token = token
        self.timeout = timeout
        self.retry = retry
        #: abandonment model: when set, any long-poll request
        #: (``wait=1``) has its socket closed after this many seconds
        #: and raises :class:`ClientAbandoned` — never retried, the
        #: caller walked away (the load generator's impatient client).
        self.abandon_after_s = (float(abandon_after_s)
                                if abandon_after_s is not None
                                else None)
        self._conn: Optional[http.client.HTTPConnection] = None
        self._abandon_timer: Optional[threading.Timer] = None
        self._abandoned = False
        self._rid_seq = 0

    # ------------------------------------------------------- plumbing ----

    def next_request_id(self) -> str:
        """A fresh client-generated request id. One id per *logical*
        request: retries inside :meth:`_request` reuse it, so a
        retried submit stays one trace server-side."""
        self._rid_seq += 1
        return f"req-cl-{os.getpid():x}-{self._rid_seq:x}"

    def _headers(self, request_id: Optional[str] = None
                 ) -> Dict[str, str]:
        h = {"Content-Type": "application/json"}
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        if request_id:
            # W3C trace propagation alongside the request id: both
            # derive deterministically from the id, so the server
            # (and a WAL-replaying restart of it) lands on the same
            # trace without the client holding any tracing state
            h["X-Request-Id"] = request_id
            h["traceparent"] = tracing.format_traceparent(
                tracing.trace_id_for(request_id),
                tracing.span_id_for(request_id, "client"))
        return h

    def _connect(self) -> http.client.HTTPConnection:
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout)
        return self._conn

    def _abandon(self) -> None:
        """The abandonment timer's target: close the live connection
        mid-long-poll. ``shutdown`` before ``close`` — closing alone
        doesn't wake the thread blocked in ``recv``; shutdown delivers
        it an immediate EOF. ``_request`` sees the ``_abandoned`` flag
        and raises :class:`ClientAbandoned` instead of retrying."""
        self._abandoned = True
        conn, self._conn = self._conn, None
        if conn is not None:
            try:
                if conn.sock is not None:
                    conn.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    def _request_once(self, method: str, path: str,
                      body: Optional[dict] = None,
                      request_id: Optional[str] = None):
        conn = self._connect()
        timer = None
        if self.abandon_after_s is not None and "wait=1" in path:
            timer = threading.Timer(self.abandon_after_s,
                                    self._abandon)
            timer.daemon = True
            self._abandon_timer = timer
            timer.start()
        try:
            conn.request(method, path,
                         body=(json.dumps(body).encode()
                               if body is not None else None),
                         headers=self._headers(request_id))
            resp = conn.getresponse()
            return resp, resp.read()
        finally:
            if timer is not None:
                timer.cancel()
                self._abandon_timer = None

    def _request(self, method: str, path: str,
                 body: Optional[dict] = None) -> Any:
        attempt = 0
        rid = self.next_request_id()
        max_retries = (self.retry.max_retries
                       if self.retry is not None else 1)
        while True:
            retry_after = None
            try:
                resp, data = self._request_once(method, path, body,
                                                request_id=rid)
            except (http.client.HTTPException, ConnectionError,
                    OSError):
                if self._abandoned:
                    # our own abandonment timer closed the socket —
                    # final by design, the modelled client walked away
                    self._abandoned = False
                    self.close()
                    raise ClientAbandoned(
                        f"abandoned long-poll after "
                        f"{self.abandon_after_s}s: {method} {path}")
                # stale keep-alive or a killed/restarting service:
                # reconnect and (with a policy) back off jittered
                self.close()
                if attempt >= max_retries:
                    raise
                if self.retry is not None:
                    self.retry.sleep(self.retry.delay(attempt))
                attempt += 1
                continue
            try:
                payload = json.loads(data) if data else {}
            except json.JSONDecodeError:
                payload = {"error":
                           data.decode("utf-8", "replace")[:200]}
            if resp.status >= 400:
                ra = resp.getheader("Retry-After")
                try:
                    retry_after = float(ra) if ra else None
                except ValueError:
                    retry_after = None
                if self.retry is not None \
                        and resp.status in RETRYABLE_STATUSES \
                        and attempt < max_retries:
                    delay = self.retry.delay(attempt)
                    if retry_after is not None:
                        delay = max(delay, retry_after)
                    self.retry.sleep(delay)
                    attempt += 1
                    continue
                raise ServiceError(resp.status,
                                   payload.get("error", resp.reason),
                                   retry_after=retry_after,
                                   payload=payload)
            payload["_status"] = resp.status
            return payload

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            finally:
                self._conn = None

    def __enter__(self) -> "ServiceClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ API ----

    def healthz(self) -> Dict[str, Any]:
        try:
            return self._request("GET", "/healthz")
        except ServiceError as e:
            if e.code == 503:
                # draining or stalled: the body says which
                return {"status": e.payload.get("status", "draining"),
                        **{k: v for k, v in e.payload.items()
                           if k != "status"}, "_status": 503}
            raise

    def metrics_text(self) -> str:
        conn = self._connect()
        conn.request("GET", "/metrics", headers=self._headers())
        resp = conn.getresponse()
        body = resp.read().decode("utf-8")
        if resp.status >= 400:
            raise ServiceError(resp.status, body[:200])
        return body

    def submit(self, problem: str, params: Optional[dict] = None,
               tenant_id: Optional[str] = None,
               idempotency_key: Optional[str] = None,
               deadline_s: Optional[float] = None) -> str:
        """Submit one job. ``idempotency_key`` makes the submit safe
        to retry (a duplicate key maps to the already-accepted
        tenant); ``deadline_s`` bounds how long the job may wait for
        admission — past it the service drops the job and result
        polls return 504."""
        body: Dict[str, Any] = {"problem": problem,
                                "params": params or {}}
        if tenant_id is not None:
            body["tenant_id"] = str(tenant_id)
        if idempotency_key is not None:
            body["idempotency_key"] = str(idempotency_key)
        if deadline_s is not None:
            body["deadline_s"] = float(deadline_s)
        return self._request("POST", "/v1/jobs", body)["tenant_id"]

    def submit_many(self, jobs: List[dict]) -> List[str]:
        """Batch submit: ``jobs`` is a list of ``{"problem",
        "params", "tenant_id"?, "idempotency_key"?, "deadline_s"?}``
        specs; one HTTP round trip, returns the tenant ids in order.
        With a retrying client, give every spec an idempotency key —
        a retried batch then maps back onto the accepted tenants."""
        return self._request("POST", "/v1/jobs",
                             {"jobs": jobs})["tenant_ids"]

    def results_many(self, tenant_ids: List[str], wait: bool = True,
                     timeout: Optional[float] = None
                     ) -> Dict[str, Dict[str, Any]]:
        """Batch result fetch: ``{tenant_id: status-dict}`` (each with
        ``result`` once finished); with ``wait`` the long-poll
        deadline is shared across the batch."""
        ids = ",".join(urllib.parse.quote(t) for t in tenant_ids)
        path = f"/v1/results?ids={ids}"
        if wait:
            t = timeout if timeout is not None else self.timeout
            path += f"&wait=1&timeout={t}"
        return self._request("GET", path)["results"]

    def status(self, tenant_id: str) -> Dict[str, Any]:
        return self._request(
            "GET", f"/v1/jobs/{urllib.parse.quote(tenant_id)}")

    def result(self, tenant_id: str, wait: bool = True,
               timeout: Optional[float] = None) -> Dict[str, Any]:
        """The job's status dict; once finished it carries ``result``
        (the wire-encoded pytree: ``treedef``/``leaves``/``digest``).
        ``wait=True`` long-polls until done/drained."""
        path = f"/v1/jobs/{urllib.parse.quote(tenant_id)}/result"
        if wait:
            t = timeout if timeout is not None else self.timeout
            path += f"?wait=1&timeout={t}"
        return self._request("GET", path)

    def drain(self) -> Dict[str, Any]:
        return self._request("POST", "/v1/drain")

    def stream(self, tenant_id: str) -> Iterator[Dict[str, Any]]:
        """Yield the job's NDJSON events (``status`` → ``segment``* →
        terminal ``finished``/``stopped``/``drained``) as dicts. Uses
        a dedicated connection (the stream holds it until the
        terminal event)."""
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        try:
            conn.request(
                "GET",
                f"/v1/jobs/{urllib.parse.quote(tenant_id)}/stream",
                headers=self._headers())
            resp = conn.getresponse()
            if resp.status >= 400:
                body = resp.read()
                try:
                    msg = json.loads(body).get("error", "")
                except json.JSONDecodeError:
                    msg = body.decode("utf-8", "replace")[:200]
                raise ServiceError(resp.status, msg)
            buf = b""
            while True:
                chunk = resp.read1(65536)
                if not chunk:
                    break
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if line.strip():
                        yield json.loads(line)
        finally:
            conn.close()

    # ------------------------------------------------------- decoding ----

    @staticmethod
    def decode_leaves(result_payload: Dict[str, Any]) -> List[Any]:
        """The byte-exact numpy leaves of a :meth:`result` payload."""
        return [wire.unpack(leaf)
                for leaf in result_payload["result"]["leaves"]]

    @staticmethod
    def decode_records(segment_event: Dict[str, Any]) -> Any:
        """Decode a ``segment`` stream event's ``records`` block back
        into numpy arrays (``None`` when the segment carried none)."""
        rec = segment_event.get("records")
        return None if rec is None else wire.unpack(rec)
