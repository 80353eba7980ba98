"""The load generator: a child process that drives the server over HTTP.

Started by ``run.py`` as ``python3 -m h100bench.loadgen``. It reads one
JSON line from standard input: the plan (traffic.py), the server's port
and ``t0``, the ``time.monotonic()`` at which the plan starts (the clock
is the machine's, shared with the parent). It sends each request of an
open plan when it is due, or keeps ``clients`` requests of a closed plan
in flight, each client sending its next one when its reply ends. Every
request is ``POST /api/generate``, streamed NDJSON over chunked HTTP/1.1
(one chunk a line), greedy, ending by length (``options.num_predict``).

One thread runs every connection on an asyncio loop, and the process
lowers its own priority (``NICE``), so the client takes as little as it
can from the server it measures; a second thread only reads standard
input. Only the standard library is used.

A line ``stop`` on standard input ends the sending. An open plan then
waits, up to ``GRACE_S``, for the first token of every request due at
or after ``window_start``; then every connection is closed, and the log
goes to standard output as one JSON line: per request the time it was
sent, the time of every token line, and, once done, the served token
ids.
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import threading
import time

GRACE_S = 60.0
NICE = 10
FINAL = b'"done": true'


async def _read_chunk(reader: asyncio.StreamReader) -> bytes:
    """One chunk of a chunked body (b"" at its end)."""
    size = int((await reader.readline()).split(b";")[0], 16)
    data = await reader.readexactly(size + 2)
    return data[:-2]


class Client:
    def __init__(self, plan: dict, port: int, t0: float):
        self.plan, self.port, self.t0 = plan, port, t0
        self.log: dict = {}
        self.tasks: set = set()

    def register(self, req: dict) -> dict:
        rec = {"id": req["id"], "prompt_tokens": req["prompt_tokens"],
               "num_predict": req["num_predict"], "tokens": [],
               "done": False, "error": None}
        if "due" in req:
            rec["due"] = self.t0 + req["due"]
        self.log[req["id"]] = rec
        return rec

    async def send(self, req: dict) -> None:
        """One request, start to end (or until it is cancelled)."""
        rec = self.register(req)
        body = json.dumps({"model": "bench", "prompt": req["prompt"],
                           "stream": True,
                           "options": {"temperature": 0,
                                       "num_predict": req["num_predict"]}
                           }).encode()
        head = (f"POST /api/generate HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n")
        rec["sent"] = time.monotonic()
        writer = None
        try:
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           self.port)
            writer.write(head.encode() + body)
            status = (await reader.readline()).split()
            headers = {}
            while (line := await reader.readline()) not in (b"\r\n", b""):
                k, _, v = line.decode().partition(":")
                headers[k.strip().lower()] = v.strip()
            if status[1] != b"200":
                n = int(headers.get("content-length", 0))
                rec["error"] = (f"HTTP {status[1].decode()}: "
                                f"{(await reader.read(n))[:200]!r}")
                return
            while data := await _read_chunk(reader):
                if FINAL not in data:
                    rec["tokens"].append(time.monotonic())
                    continue
                msg = json.loads(data)
                gen = msg["context"][msg["prompt_eval_count"]:]
                # A tail line carries no token: keep one time per token.
                del rec["tokens"][len(gen):]
                rec.update(done=True, done_reason=msg.get("done_reason"),
                           generated=gen)
                return
        except (OSError, ValueError, IndexError,
                asyncio.IncompleteReadError) as e:
            rec["error"] = f"{type(e).__name__}: {e}"
        finally:
            if writer is not None:
                writer.close()

    def _spawn(self, coro) -> None:
        task = asyncio.get_running_loop().create_task(coro)
        self.tasks.add(task)
        task.add_done_callback(self.tasks.discard)

    async def _open_loop(self) -> None:
        for req in self.plan["requests"]:
            await asyncio.sleep(max(0.0, self.t0 + req["due"]
                                    - time.monotonic()))
            self._spawn(self.send(req))

    async def _closed_loop(self) -> None:
        it = iter(self.plan["requests"])

        async def client():
            for req in it:
                await self.send(req)

        await asyncio.sleep(max(0.0, self.t0 - time.monotonic()))
        for _ in range(self.plan["clients"]):
            self._spawn(client())

    def _first_tokens_due(self) -> bool:
        w0 = self.t0 + self.plan.get("window_start", 0.0)
        return any(r.get("due", 0.0) >= w0 and not r["tokens"]
                   and not r["done"] and r["error"] is None
                   for r in self.log.values())

    async def run(self, stop: asyncio.Event) -> list:
        """Send until ``stop``; in an open plan wait for the window's
        first tokens; cancel every request still open; the log."""
        sender = asyncio.get_running_loop().create_task(
            self._open_loop() if self.plan["loop"] == "open"
            else self._closed_loop())
        await stop.wait()
        sender.cancel()
        if self.plan["loop"] == "open":
            limit = time.monotonic() + GRACE_S
            while self._first_tokens_due() and time.monotonic() < limit:
                await asyncio.sleep(0.05)
        tasks = list(self.tasks) + [sender]
        for task in tasks:
            task.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        return sorted(self.log.values(), key=lambda r: r["id"])


async def _main(msg: dict) -> list:
    loop = asyncio.get_running_loop()
    stop = asyncio.Event()

    def wait_for_stop():
        for line in sys.stdin:
            if line.strip() == "stop":
                break
        loop.call_soon_threadsafe(stop.set)

    threading.Thread(target=wait_for_stop, daemon=True).start()
    return await Client(msg["plan"], msg["port"], msg["t0"]).run(stop)


def main() -> int:
    os.nice(NICE)
    msg = json.loads(sys.stdin.readline())
    log = asyncio.run(_main(msg))
    sys.stdout.write(json.dumps({"requests": log}) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
