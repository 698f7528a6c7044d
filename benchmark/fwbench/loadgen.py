"""The open-loop client of the serving cells, run as a child process so that
its threads do not share the server's interpreter lock.

Reads one JSON object on stdin: ``port``, ``seed``, ``num_mels``,
``requests`` (each: ``due`` seconds, ``frames``, ``offset`` into the mel
pool, ``seed``, ``speaker`` or null), ``keep`` (indices whose WAV bodies
come back), ``drain_s`` and ``workers``.  It builds every body first,
prints ``ready``, waits for a line on stdin, then sends each request at
its due time whether or not earlier ones have finished, and prints one
JSON object: per request the due, send and done times (seconds from the
start), HTTP status and body length, and the kept bodies (base64).
"""

from __future__ import annotations

import base64
import http.client
import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fwbench import traffic as tg  # noqa: E402


def main() -> int:
    spec = json.loads(sys.stdin.readline())
    pool = tg.mel_pool(spec["seed"], spec["num_mels"])
    reqs = spec["requests"]
    keep = set(spec["keep"])
    bodies = [tg.npy_bytes(tg.mel_at(pool, r["offset"], r["frames"]))
              for r in reqs]
    out = [{"due": r["due"], "sent": None, "done": None, "status": None,
            "bytes": 0} for r in reqs]
    kept: dict = {}
    lock = threading.Lock()
    deadline_box = [None]

    def send(i: int, t0: float) -> None:
        r = reqs[i]
        rec = out[i]
        rec["sent"] = time.perf_counter() - t0
        headers = {"Content-Type": "application/octet-stream",
                   "X-Seed": str(r["seed"])}
        if r.get("speaker") is not None:
            headers["X-Speaker-Id"] = str(r["speaker"])
        timeout = max(1.0, deadline_box[0] - time.perf_counter())
        try:
            conn = http.client.HTTPConnection("127.0.0.1", spec["port"],
                                              timeout=timeout)
            conn.request("POST", "/synthesize", body=bodies[i],
                         headers=headers)
            resp = conn.getresponse()
            body = resp.read()
            conn.close()
        except OSError as e:
            rec["status"] = f"error: {type(e).__name__}"
            return
        rec["done"] = time.perf_counter() - t0
        rec["status"] = resp.status
        rec["bytes"] = len(body)
        if i in keep and resp.status == 200:
            with lock:
                kept[i] = base64.b64encode(body).decode()

    print("ready", flush=True)
    sys.stdin.readline()
    t0 = time.perf_counter()
    last_due = max(r["due"] for r in reqs)
    deadline_box[0] = t0 + last_due + spec["drain_s"]
    with ThreadPoolExecutor(max_workers=spec["workers"]) as ex:
        futs = []
        for i, r in enumerate(reqs):
            wait = t0 + r["due"] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            futs.append(ex.submit(send, i, t0))
        for f in futs:
            f.result()
    json.dump({"requests": out, "kept": kept}, sys.stdout)
    sys.stdout.write("\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
