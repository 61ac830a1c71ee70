"""HTTP admin endpoints (reference: src/main/CommandHandler.{h,cpp}).

Full surface: /info /health /dumpflight /metrics /trace /tracespans
/profile /slo /quorum /peers /tx /scp /ll /logrotate /manualclose /bans
/unban /connect /droppeer /maintenance /clearmetrics /self-check
/upgrades /surveytopologytimesliced /getsurveyresult /getledgerentry.

/health answers 200 ("ok") or 503 ("degraded", with reasons) — the
load-balancer probe surface; /dumpflight serves the live post-mortem
bundle (flight events, span stack, metrics — util/eventlog).  Malformed
query parameters answer 400 (_BadRequest), never 500.

The admin server runs on its own threads and marshals work onto the main
thread: a ThreadingHTTPServer serves reads directly (GIL-atomic snapshots
of plain dicts) and marshals mutations (/tx, /manualclose, /connect, ...)
onto the clock's action queue, waiting for the main crank loop.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from ..util import logging as slog
from ..util import tracing
from ..util.metrics import registry

log = slog.get("CommandHandler")


class _BadRequest(Exception):
    """Malformed query parameter — surfaces as HTTP 400, never 500."""


def _hex_param(qs: dict, name: str, required: bool = True) -> bytes:
    raw = qs.get(name, [""])[0]
    if not raw:
        if required:
            raise _BadRequest(f"missing required hex param {name!r}")
        return b""
    try:
        return bytes.fromhex(raw)
    except ValueError:
        raise _BadRequest(f"param {name!r} must be hex") from None


def _int_param(qs: dict, name: str, default=None) -> int:
    raw = qs.get(name, [None])[0]
    if raw is None:
        if default is None:
            raise _BadRequest(f"missing required integer param {name!r}")
        return default
    try:
        return int(raw)
    except ValueError:
        raise _BadRequest(f"param {name!r} must be an integer") from None


class CommandHandler:
    def __init__(self, app, port: int, host: str = "127.0.0.1"):
        self.app = app
        self.host = host
        self.port = port
        self.server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        handler = self._make_handler()
        self.server = ThreadingHTTPServer((self.host, self.port), handler)
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        name="http-admin", daemon=True)
        self._thread.start()
        log.info("admin endpoint on http://%s:%d", self.host, self.port)

    def stop(self) -> None:
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self.server = None

    # ------------------------------------------------------------------
    def _on_main(self, fn, name: str = "http-cmd") -> dict:
        """Marshal a mutation onto the clock loop and wait (reference:
        CommandHandler routes through the app's main thread).  The
        current span, if any, gets the action's seconds waiting for the
        crank loop (`wait_s`: posted to started, or to the end of the
        wait where it never started), its seconds running (`run_s`) and
        `timed_out`."""
        done = threading.Event()
        result: dict = {}
        at: dict = {}

        def work() -> None:
            at["start"] = time.perf_counter()
            try:
                out = fn()
                if isinstance(out, dict):
                    result.update(out)
            except Exception as e:
                log.debug("admin action %s failed: %s", name, e)
                result.update({"status": "ERROR", "detail": str(e)})
            at["end"] = time.perf_counter()
            done.set()

        posted = time.perf_counter()
        self.app.clock.post_action(work, name=name)
        timed_out = not done.wait(timeout=10.0)
        start = at.get("start")
        end = at.get("end")
        tracing.annotate(
            wait_s=(start if start is not None else time.perf_counter())
            - posted,
            run_s=end - start if end is not None else None,
            timed_out=timed_out)
        if timed_out:
            return {"status": "ERROR", "detail": "timed out"}
        return result

    def _submit_tx_on_main(self, blob: bytes) -> dict:
        """/tx: one `http.tx` root span on this HTTP thread."""
        with tracing.span("http.tx"):
            return self._on_main(lambda: self.app.submit_tx(blob),
                                 name="http-tx")

    def _make_handler(self):
        handler_self = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            @staticmethod
            def _snap(fn):
                """Read main-thread state with retry: dict iteration can
                race a concurrent mutation (RuntimeError) — retry instead
                of surfacing a 500."""
                for _ in range(5):
                    try:
                        return fn()
                    except RuntimeError:
                        continue
                return fn()

            def _reply(self, obj, code=200):
                body = json.dumps(obj, indent=1).encode()
                self._reply_raw(body, "application/json", code)

            def _reply_raw(self, body: bytes, content_type: str, code=200):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                app = handler_self.app
                url = urlparse(self.path)
                try:
                    if url.path == "/info":
                        self._reply({"info": self._snap(app.info)})
                    elif url.path == "/health":
                        # NOT marshalled: a load-balancer probe must keep
                        # answering while the main loop is stalled — that
                        # stall is exactly what it exists to detect (the
                        # reads are GIL-atomic snapshots)
                        doc = self._snap(app.health)
                        self._reply(doc,
                                    200 if doc["status"] == "ok" else 503)
                    elif url.path == "/dumpflight":
                        # the live post-mortem: same bundle a crash writes
                        from ..util import eventlog
                        self._reply(self._snap(lambda: eventlog.flight_bundle(
                            "live dump via /dumpflight")))
                    elif url.path == "/metrics":
                        fmt = parse_qs(url.query).get("format", ["json"])[0]
                        if fmt == "prometheus":
                            from ..util.metrics import render_prometheus
                            text = self._snap(lambda: render_prometheus(
                                registry().snapshot()))
                            self._reply_raw(
                                text.encode(),
                                "text/plain; version=0.0.4; charset=utf-8")
                        else:
                            self._reply({"metrics": self._snap(app.metrics)})
                    elif url.path == "/trace":
                        qs = parse_qs(url.query)
                        slot = _int_param(qs, "slot", default=-1) \
                            if "slot" in qs else None
                        doc = self._snap(
                            lambda: tracing.to_chrome_trace(slot=slot))
                        self._reply_raw(json.dumps(doc).encode(),
                                        "application/json")
                    elif url.path == "/tracespans":
                        # incremental cross-node export: marks + finished
                        # root spans past the caller's watermark, plus a
                        # fresh clock anchor (util/fleettrace collector)
                        qs = parse_qs(url.query)
                        since = _int_param(qs, "since", default=0)
                        slot = _int_param(qs, "slot", default=-1) \
                            if "slot" in qs else None
                        doc = self._snap(
                            lambda: tracing.tracespans_doc(since,
                                                           slot=slot))
                        self._reply_raw(json.dumps(doc).encode(),
                                        "application/json")
                    elif url.path == "/profile":
                        # always-on sampling profiler (util/sampleprof)
                        from ..util import sampleprof
                        qs = parse_qs(url.query)
                        fmt = qs.get("format", ["json"])[0]
                        prof = sampleprof.profiler()
                        if fmt == "folded":
                            self._reply_raw(
                                (prof.folded() + "\n").encode(),
                                "text/plain; charset=utf-8")
                        else:
                            self._reply(self._snap(prof.snapshot))
                    elif url.path == "/slo":
                        tracker = getattr(app, "slo_tracker", None)
                        if tracker is None:
                            self._reply({"error": "no SLO tracker "
                                         "configured"}, 404)
                        else:
                            self._reply(self._snap(tracker.report))
                    elif url.path == "/timeseries":
                        # retrospective telemetry (util/timeseries):
                        # watermark-incremental history of the metric
                        # registry, same since/next_since contract as
                        # /tracespans
                        store = getattr(app, "timeseries", None)
                        if store is None:
                            self._reply({"error": "no time-series store "
                                         "configured"}, 404)
                        else:
                            from ..util.metrics import METRIC_NAME_RE
                            qs = parse_qs(url.query)
                            since = _int_param(qs, "since", default=0)
                            metric = qs.get("metric", [""])[0]
                            if metric and not METRIC_NAME_RE.match(metric):
                                raise _BadRequest(
                                    f"malformed metric name {metric!r}")
                            doc = self._snap(lambda: store.doc(
                                since, metric=metric or None))
                            self._reply_raw(json.dumps(doc).encode(),
                                            "application/json")
                    elif url.path == "/closecosts":
                        # per-close cost ledger (ledger/costs): one row
                        # per sealed ledger past the caller's watermark
                        ring = getattr(getattr(app, "lm", None),
                                       "close_costs", None)
                        if ring is None:
                            self._reply({"error": "no close-cost ledger "
                                         "configured"}, 404)
                        else:
                            qs = parse_qs(url.query)
                            since = _int_param(qs, "since", default=0)
                            doc = self._snap(lambda: ring.doc(since))
                            self._reply_raw(json.dumps(doc).encode(),
                                            "application/json")
                    elif url.path == "/quorum":
                        transitive = parse_qs(url.query).get(
                            "transitive", ["false"])[0] == "true"
                        self._reply(self._snap(
                            lambda: app.quorum_info(transitive)))
                    elif url.path == "/peers":
                        self._reply({"authenticated": self._snap(
                            lambda: [p.hex() for p in
                                     app.overlay.authenticated_peers])})
                    elif url.path == "/scp":
                        self._reply({
                            "state": app.herder.get_state_human(),
                            "tracking": app.herder
                            .tracking_consensus_ledger_index()})
                    elif url.path == "/tx":
                        qs = parse_qs(url.query)
                        blob = qs.get("blob", [""])[0]
                        try:
                            raw = bytes.fromhex(blob)
                        except ValueError:
                            self._reply({"status": "ERROR",
                                         "detail": "blob must be hex"}, 400)
                            return
                        self._reply(handler_self._submit_tx_on_main(raw))
                    elif url.path == "/ll":
                        self._log_level(parse_qs(url.query))
                    elif url.path == "/logrotate":
                        from ..util import logging as slog2
                        self._reply(handler_self._on_main(
                            slog2.rotate, name="logrotate")
                            or {"status": "rotated"})
                    elif url.path == "/manualclose":
                        self._reply(handler_self._on_main(
                            lambda: app.manual_close(), name="manualclose"))
                    elif url.path == "/bans":
                        # _snap: sorted() iterates the ban set while the
                        # main thread may ban/unban — retry the GIL-atomic
                        # snapshot instead of surfacing a transient 500
                        # (found by a thread-safety audit)
                        self._reply({"bans": self._snap(
                            lambda: [n.hex() for n in
                                     app.overlay.ban_manager
                                     .banned_nodes()])})
                    elif url.path == "/unban":
                        # marshalled: the ban table lives in the main
                        # thread's sqlite connection
                        nid = _hex_param(parse_qs(url.query), "node")
                        out = handler_self._on_main(
                            lambda: app.overlay.ban_manager.unban_node(nid),
                            name="unban")
                        self._reply(out or {"status": "unbanned"})
                    elif url.path == "/ban":
                        nid = _hex_param(parse_qs(url.query), "node")
                        out = handler_self._on_main(
                            lambda: app.overlay.ban_manager.ban_node(nid),
                            name="ban")
                        self._reply(out or {"status": "banned"})
                    elif url.path == "/connect":
                        qs = parse_qs(url.query)
                        host = qs.get("peer", [""])[0]
                        port = _int_param(qs, "port", default=11625)
                        self._reply(handler_self._on_main(
                            lambda: app.connect_to(host, port),
                            name="connect"))
                    elif url.path == "/droppeer":
                        nid = _hex_param(parse_qs(url.query), "node")
                        self._reply(handler_self._on_main(
                            lambda: app.drop_peer(nid),
                            name="droppeer"))
                    elif url.path == "/maintenance":
                        self._reply(handler_self._on_main(
                            app.maintainer.perform_maintenance,
                            name="maintenance"))
                    elif url.path == "/clearmetrics":
                        # marshalled: the registry is mutated by main-thread
                        # metric insertion; clearing from the HTTP thread
                        # would race snapshot/insert iteration
                        self._reply(handler_self._on_main(
                            lambda: registry().clear(), name="clearmetrics")
                            or {"status": "cleared"})
                    elif url.path == "/self-check":
                        self._reply(handler_self._on_main(
                            app.self_check, name="self-check"))
                    elif url.path == "/upgrades":
                        self._upgrades(parse_qs(url.query))
                    elif url.path == "/surveytopologytimesliced":
                        node = _hex_param(parse_qs(url.query), "node",
                                          required=False)
                        self._reply(handler_self._on_main(
                            lambda: app.survey_node(node or None),
                            name="survey"))
                    elif url.path == "/stopsurvey":
                        self._reply(handler_self._on_main(
                            lambda: app.stop_survey(), name="stopsurvey"))
                    elif url.path == "/getsurveyresult":
                        self._reply(self._snap(app.overlay.survey.results))
                    elif url.path == "/getledgerentry":
                        # marshalled: snapshot construction must not race
                        # add_batch's spill window on the main thread
                        key = _hex_param(parse_qs(url.query), "key")
                        self._reply(handler_self._on_main(
                            lambda: app.get_ledger_entry(key),
                            name="getledgerentry"))
                    else:
                        self._reply({"error": "unknown endpoint",
                                     "endpoints": sorted(_ENDPOINTS)}, 404)
                except _BadRequest as e:
                    self._reply({"error": str(e)}, 400)
                except Exception as e:  # admin surface must never crash
                    log.warning("admin request failed: %s", e)
                    self._reply({"error": str(e)}, 500)

            def _log_level(self, qs) -> None:
                from ..util import logging as slog2
                level = qs.get("level", [None])[0]
                partition = qs.get("partition", [None])[0]
                fmt = qs.get("format", [None])[0]
                # validate EVERY param before applying ANY of them: a
                # request that answers 400 must be side-effect free
                if fmt is not None and fmt not in slog2.LOG_FORMATS:
                    raise _BadRequest(
                        f"format must be one of {slog2.LOG_FORMATS}")
                if level is not None and level.upper() not in (
                        "DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL",
                        "FATAL"):
                    raise _BadRequest(f"unknown log level {level!r}")
                if partition is not None \
                        and partition not in slog2.PARTITIONS:
                    raise _BadRequest(f"unknown partition {partition!r}")
                if fmt is not None:
                    # runtime structured-logging switch (reference: the
                    # spdlog pattern swap behind /ll)
                    slog2.set_format(fmt)
                    if level is None:
                        self._reply({"status": "ok", "format": fmt})
                        return
                if level is None:
                    self._reply({"levels": slog2.current_levels(),
                                 "format": slog2.current_format()})
                    return
                # direct call, deliberately NOT marshalled: setLevel is a
                # thread-safe single attribute store, and /ll must keep
                # working while the main loop is stalled — that is exactly
                # when an operator reaches for it
                slog2.set_level(level.upper(), partition)
                self._reply({"status": "ok", "partition": partition or "all",
                             "level": level.upper(),
                             "format": slog2.current_format()})

            def _upgrades(self, qs) -> None:
                app = handler_self.app
                mode = qs.get("mode", ["get"])[0]
                if mode == "get":
                    self._reply(self._snap(
                        lambda: app.herder.upgrades.pending_json()))
                elif mode == "clear":
                    out = handler_self._on_main(
                        lambda: app.herder.upgrades.set_parameters(None),
                        name="upgrades-clear")
                    self._reply(out or {"status": "cleared"})
                elif mode == "set":
                    from ..herder.upgrades import UpgradeParameters

                    def opt(name):
                        return _int_param(qs, name, default=0) \
                            if name in qs else None

                    params = UpgradeParameters(
                        upgrade_time=_int_param(qs, "upgradetime", default=0),
                        protocol_version=opt("protocolversion"),
                        base_fee=opt("basefee"),
                        max_tx_set_size=opt("maxtxsetsize"),
                        base_reserve=opt("basereserve"))
                    out = handler_self._on_main(
                        lambda: app.herder.upgrades.set_parameters(params),
                        name="upgrades-set")
                    self._reply(out or {"status": "set"})
                else:
                    self._reply({"error": f"bad mode {mode}"}, 400)

        return Handler


_ENDPOINTS = [
    "/info", "/health", "/dumpflight", "/metrics", "/trace",
    "/tracespans", "/profile", "/slo", "/timeseries", "/closecosts",
    "/quorum",
    "/peers", "/scp", "/tx", "/ll",
    "/logrotate", "/manualclose", "/bans", "/ban", "/unban", "/connect",
    "/droppeer", "/maintenance", "/clearmetrics", "/self-check",
    "/upgrades", "/surveytopologytimesliced", "/stopsurvey",
    "/getsurveyresult", "/getledgerentry",
]
