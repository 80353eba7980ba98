"""The load generator: a child process that drives the server over HTTP.

Started by ``run.py`` as ``python3 -m h100bench.loadgen``. It reads one
JSON line from standard input: the plan (traffic.py), the server's port
and ``t0``, the ``time.monotonic()`` at which the plan starts (the clock
is the machine's, shared with the parent). It sends each request of an
open plan when it is due, or keeps ``clients`` requests of a closed plan
in flight, each client sending its next one when its reply ends, or
starts each session of a sessions plan when it is due and sends its
turns one after another, each its think time after the previous reply
ended. Every request is ``POST /api/generate``, streamed NDJSON over
chunked HTTP/1.1 (one chunk a line), greedy, ending by length
(``options.num_predict``).

A session continues its conversation as an Ollama client does on
``/api/generate``. Its first turn's prompt is the chat transcript that
the port's ``/api/chat`` renders under the byte tokenizer (no chat
template: ``"role: content"`` lines, then ``"assistant:"``) of the
system prompt and the first user message. Every later turn sends the
previous turn's final ``context`` (its prompt's token ids and the served
ones) with the transcript's next lines as ``prompt``: ``"\nuser: "``,
the message, ``"\nassistant:"``. So each turn carries the whole
history, every earlier reply as the token ids the server served.

One thread runs every connection on an asyncio loop, and the process
lowers its own priority (``NICE``), so the client takes as little as it
can from the server it measures; a second thread only reads standard
input. Only the standard library is used.

A line ``stop`` on standard input ends the sending: no session sends
another turn. An open or sessions plan then waits, up to ``GRACE_S``,
for the first token of every request due at or after ``window_start``;
then every connection is closed, and the log goes to standard output as
one JSON line: per request the time it was sent, the time of every
token line, and, once done, the served token ids; for a session's turn
also its session, turn and prompt, and for a later turn the context it
continued; and the number of sessions that ended before a turn that
would pass the plan's ``max_context``.
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
# A session's turn k is request session * TURN_IDS + k.
TURN_IDS = 64


def chat_transcript(messages: list) -> str:
    """The prompt the port's /api/chat renders from (role, content)
    pairs without a chat template."""
    return "\n".join(f"{r}: {c}" for r, c in messages) + "\nassistant:"


def prompt_tokens(text: str) -> int:
    """Tokens of a prompt under the byte tokenizer: BOS, then one a
    UTF-8 byte."""
    return 1 + len(text.encode("utf-8"))


def session_turn(plan: dict, session: dict, k: int, context):
    """(prompt, tokens) of turn ``k`` of ``session``: the first turn's
    chat transcript, or a later turn's next lines after ``context``, the
    previous turn's final token ids; None where the prompt and its reply
    would pass the plan's ``max_context``."""
    user = session["turns"][k]["user"]
    if k == 0:
        prompt = chat_transcript(
            [("system", plan["systems"][session["system"]]), ("user", user)])
        n = prompt_tokens(prompt)
    else:
        # The port drops the new prompt's BOS after a context.
        prompt = f"\nuser: {user}\nassistant:"
        n = len(context) + prompt_tokens(prompt) - 1
    if n + session["turns"][k]["num_predict"] > plan["max_context"]:
        return None
    return prompt, n


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
        self.stopping = False
        self.sessions_cut = 0

    def register(self, req: dict) -> dict:
        rec = {"id": req["id"], "prompt_tokens": req["prompt_tokens"],
               "num_predict": req["num_predict"], "tokens": [],
               "done": False, "error": None}
        if "due" in req:
            rec["due"] = self.t0 + req["due"]
        for k in ("session", "turn", "prompt", "context"):
            if k in req:
                rec[k] = req[k]
        self.log[req["id"]] = rec
        return rec

    async def send(self, req: dict, final: dict = None) -> dict:
        """One request, start to end (or until it is cancelled); with
        ``final``, its final record's ``context`` is put there."""
        rec = self.register(req)
        body = {"model": "bench", "prompt": req["prompt"], "stream": True,
                "options": {"temperature": 0,
                            "num_predict": req["num_predict"]}}
        if "context" in req:
            body["context"] = req["context"]
        body = json.dumps(body).encode()
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
                return rec
            while data := await _read_chunk(reader):
                if FINAL not in data:
                    rec["tokens"].append(time.monotonic())
                    continue
                msg = json.loads(data)
                gen = msg["context"][msg["prompt_eval_count"]:]
                # A tail line carries no token: keep one time per token.
                del rec["tokens"][len(gen):]
                rec.update(done=True, done_reason=msg.get("done_reason"),
                           generated=gen,
                           prompt_eval_count=msg["prompt_eval_count"])
                if final is not None:
                    final["context"] = msg["context"]
                return rec
        except (OSError, ValueError, IndexError, KeyError,
                asyncio.IncompleteReadError) as e:
            rec["error"] = f"{type(e).__name__}: {e}"
        finally:
            if writer is not None:
                writer.close()
        return rec

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

    async def _sessions_loop(self) -> None:
        for session in self.plan["sessions"]:
            await asyncio.sleep(max(0.0, self.t0 + session["due"]
                                    - time.monotonic()))
            self._spawn(self._session(session))

    async def _session(self, session: dict) -> None:
        """A session's turns, each due its think time after the previous
        reply ended; none after ``stop``, an error or a turn that would
        pass the context."""
        context, due = None, session["due"]
        for k, turn in enumerate(session["turns"]):
            if k:
                due = time.monotonic() - self.t0 + turn["think_s"]
                await asyncio.sleep(turn["think_s"])
            if self.stopping:
                return
            got = session_turn(self.plan, session, k, context)
            if got is None:
                self.sessions_cut += 1
                return
            req = {"id": session["id"] * TURN_IDS + k, "prompt": got[0],
                   "prompt_tokens": got[1], "num_predict": turn["num_predict"],
                   "due": due, "session": session["id"], "turn": k}
            if context is not None:
                req["context"] = context
            final: dict = {}
            rec = await self.send(req, final)
            if not rec["done"]:
                return
            context = final["context"]

    def _first_tokens_due(self) -> bool:
        w0 = self.t0 + self.plan.get("window_start", 0.0)
        return any(r.get("due", 0.0) >= w0 and not r["tokens"]
                   and not r["done"] and r["error"] is None
                   for r in self.log.values())

    async def run(self, stop: asyncio.Event) -> list:
        """Send until ``stop``; in an open or sessions plan wait for the
        window's first tokens; cancel every request still open; the
        log."""
        loops = {"open": self._open_loop, "closed": self._closed_loop,
                 "sessions": self._sessions_loop}
        sender = asyncio.get_running_loop().create_task(
            loops[self.plan["loop"]]())
        await stop.wait()
        self.stopping = True
        sender.cancel()
        if self.plan["loop"] != "closed":
            limit = time.monotonic() + GRACE_S
            while self._first_tokens_due() and time.monotonic() < limit:
                await asyncio.sleep(0.05)
        tasks = list(self.tasks) + [sender]
        for task in tasks:
            task.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        return sorted(self.log.values(), key=lambda r: r["id"])


async def _main(msg: dict) -> dict:
    loop = asyncio.get_running_loop()
    stop = asyncio.Event()

    def wait_for_stop():
        for line in sys.stdin:
            if line.strip() == "stop":
                break
        loop.call_soon_threadsafe(stop.set)

    threading.Thread(target=wait_for_stop, daemon=True).start()
    client = Client(msg["plan"], msg["port"], msg["t0"])
    log = await client.run(stop)
    return {"requests": log, "sessions_cut": client.sessions_cut}


def main() -> int:
    os.nice(NICE)
    msg = json.loads(sys.stdin.readline())
    out = asyncio.run(_main(msg))
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
