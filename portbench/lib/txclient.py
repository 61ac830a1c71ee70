"""The /tx clients of the validator cells, as a process of their own, so
that their HTTP work takes nothing from the node's interpreter.

    python -m portbench.lib.txclient

reads on standard input a pickled plan, then lines "<seq> <monotonic s>"
as the node closes ledgers, and writes on standard output, once the window
has closed and every request has its answer, a pickled list of
(kind, index, due, sent, replied, status) a request, times on the
system-wide monotonic clock that the node's process reads too.

The plan: port, t_open (monotonic s), seconds, timeout_s, `paced`
[(due offset s, envelope hex)] posted open loop at their due times by
`paced_workers` threads; and `bursts`, a list of lists of envelope hex:
after each close whose time falls in the window the next list is posted
by `burst_clients` threads with no pacing, each request due at the close.
"""

from __future__ import annotations

import http.client
import json
import pickle
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor


def post(port: int, blob_hex: str, timeout: float) -> str:
    """GET /tx?blob=... on the node; its status, "HTTP <code>" or the
    name of the exception that ended the request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", "/tx?blob=" + blob_hex)
        r = conn.getresponse()
        body = r.read()
        if r.status != 200:
            return f"HTTP {r.status}"
        return json.loads(body).get("status", "NONE")
    except (OSError, http.client.HTTPException, ValueError) as e:
        return type(e).__name__
    finally:
        conn.close()


def run(plan: dict, closes) -> list:
    """Post the plan; `closes` yields (seq, monotonic s) of each close."""
    port, t_open = plan["port"], plan["t_open"]
    t_close, timeout = t_open + plan["seconds"], plan["timeout_s"]
    out, lock = [], threading.Lock()

    def one(kind, i, due, blob):
        sent = time.monotonic()
        status = post(port, blob, timeout)
        with lock:
            out.append((kind, i, due, sent, time.monotonic(), status))

    pool = ThreadPoolExecutor(plan["paced_workers"])
    burst_pool = ThreadPoolExecutor(plan["burst_clients"])
    bursts = iter(enumerate(plan["bursts"]))

    def on_closes():
        for _, at in closes:
            if not t_open <= at < t_close:
                continue
            k_batch = next(bursts, None)
            if k_batch is None:
                continue
            k, batch = k_batch
            for j, blob in enumerate(batch):
                burst_pool.submit(one, "burst", (k, j), at, blob)

    watcher = threading.Thread(target=on_closes, daemon=True)
    watcher.start()
    for i, (offset, blob) in enumerate(plan["paced"]):
        due = t_open + offset
        wait = due - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        pool.submit(one, "paced", i, due, blob)
    wait = t_close - time.monotonic()
    if wait > 0:
        time.sleep(wait)
    pool.shutdown(wait=True)
    # a close notified just before the window ended may still be posting
    time.sleep(0.2)
    burst_pool.shutdown(wait=True)
    return out


def _closes(stream):
    for line in stream:
        seq, at = line.split()
        yield int(seq), float(at)


def main() -> None:
    n = int(sys.stdin.buffer.readline())
    plan = pickle.loads(sys.stdin.buffer.read(n))
    text = (line.decode() for line in sys.stdin.buffer)
    out = run(plan, _closes(text))
    sys.stdout.buffer.write(pickle.dumps(out))
    sys.stdout.buffer.flush()


if __name__ == "__main__":
    main()
