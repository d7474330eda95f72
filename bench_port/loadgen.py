"""The open-loop load generator: its own process, keep-alive HTTP/1.1
connections on one asyncio loop, ``POST /recommend`` on a schedule drawn
from the seed whether or not earlier requests have finished.

    python3 bench_port/loadgen.py --port P --rate R --seconds S --seed N \
        --users U --zipf A --k K --sample M --out results.json

Arrivals are a Poisson process at ``--rate`` over ``--seconds``; users
are Zipf(``--zipf``)-popular over ``--users`` raw ids (1..U, ranks
shuffled by the seed). Each request is timed from its due time, so a
stall counts against every request behind it. ``--sample`` requests,
drawn from the seed, keep their answers for the check. It prints
``START`` when the first request is due and ``END`` when the last one
is, then waits up to ``--drain`` seconds for the answers still out and
writes one JSON file: each request's due time, latency (None where it
failed), status, how late it was sent, and the sampled answers.
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import sys

import numpy as np


def schedule(seed: int, rate: float, seconds: float, users: int, zipf: float):
    """-> (due times [n] in s from the start, raw user ids [n])."""
    rng = np.random.default_rng([int(seed), 7])
    n_max = int(rate * seconds * 1.5 + 100)
    gaps = rng.exponential(1.0 / rate, n_max)
    due = np.cumsum(gaps) - gaps[0]
    due = due[due < seconds]
    pop = np.arange(1, users + 1, dtype=np.float64) ** -zipf
    rank_to_user = rng.permutation(users) + 1
    ranks = rng.choice(users, len(due), p=pop / pop.sum())
    return due, rank_to_user[ranks]


def sample_indices(seed: int, n: int, m: int) -> set:
    rng = np.random.default_rng([int(seed), 11])
    return set(rng.choice(n, min(m, n), replace=False).tolist()) if n else set()


async def _read_response(reader):
    head = await reader.readuntil(b"\r\n\r\n")
    lines = head.split(b"\r\n")
    code = int(lines[0].split(b" ", 2)[1])
    length = 0
    for h in lines[1:]:
        name, _, val = h.partition(b":")
        if name.strip().lower() == b"content-length":
            length = int(val.strip())
    body = await reader.readexactly(length) if length else b""
    return code, body


class Generator:
    def __init__(self, args):
        self.a = args
        self.due, self.users = schedule(args.seed, args.rate, args.seconds, args.users,
                                        args.zipf)
        n = len(self.due)
        self.sample = sample_indices(args.seed, n, args.sample)
        self.latency = [None] * n
        self.status = [0] * n
        self.late = [0.0] * n
        self.answers = {}
        self.bodies = [self._request(int(u)) for u in self.users]
        self.idle = []
        self.opened = 0

    def _request(self, user: int) -> bytes:
        body = json.dumps({"user_id": user, "k": self.a.k}).encode()
        return (b"POST /recommend HTTP/1.1\r\nHost: bench\r\n"
                b"Content-Type: application/json\r\nContent-Length: "
                + str(len(body)).encode() + b"\r\n\r\n" + body)

    async def _connect(self):
        self.opened += 1
        return await asyncio.open_connection("127.0.0.1", self.a.port)

    async def _one(self, i: int, t_due: float, loop) -> None:
        self.late[i] = loop.time() - t_due
        conn = self.idle.pop() if self.idle else None
        try:
            if conn is None:
                conn = await self._connect()
            reader, writer = conn
            writer.write(self.bodies[i])
            code, payload = await _read_response(reader)
            self.status[i] = code
            if code == 200:
                self.latency[i] = loop.time() - t_due
                if i in self.sample:
                    self.answers[i] = json.loads(payload)
            self.idle.append(conn)
        except (OSError, ConnectionError, asyncio.IncompleteReadError,
                asyncio.LimitOverrunError, ValueError) as e:
            self.status[i] = -1
            if conn is not None:
                conn[1].close()
            print(f"loadgen: request {i} failed: {e!r}", file=sys.stderr)

    async def run(self) -> None:
        loop = asyncio.get_running_loop()
        self.idle = [await self._connect() for _ in range(self.a.connections)]
        t0 = loop.time() + 0.02
        print("START", flush=True)
        tasks = []
        for i, d in enumerate(self.due):
            t_due = t0 + float(d)
            # the loop's timers wake in whole milliseconds: sleep to within
            # one of the due time, then poll the sockets until it comes
            wait = t_due - loop.time()
            if wait > 2e-3:
                await asyncio.sleep(wait - 1.5e-3)
            while loop.time() < t_due:
                await asyncio.sleep(0)
            tasks.append(asyncio.ensure_future(self._one(i, t_due, loop)))
        rest = t0 + self.a.seconds - loop.time()
        if rest > 0:
            await asyncio.sleep(rest)
        print("END", flush=True)
        done, pending = await asyncio.wait(tasks, timeout=self.a.drain) if tasks else ((), ())
        for t in pending:
            t.cancel()
        for t in done:
            t.result()
        for _, w in self.idle:
            w.close()

    def result(self) -> dict:
        return {"n": len(self.due), "due": self.due.tolist(), "latency": self.latency,
                "status": self.status, "late": self.late, "users": self.users.tolist(),
                "answers": {str(i): a for i, a in self.answers.items()},
                "connections_opened": self.opened}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--rate", type=float, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--users", type=int, required=True)
    ap.add_argument("--zipf", type=float, default=1.0)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--sample", type=int, default=0)
    # opened before the first request is due, so that a burst finds a
    # connection waiting (one is opened only past this many in flight)
    ap.add_argument("--connections", type=int, default=512)
    ap.add_argument("--drain", type=float, default=60.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    gen = Generator(args)
    # a full collection over the window's tasks stalls the schedule by ms
    gc.disable()
    asyncio.run(gen.run())
    with open(args.out, "w") as f:
        json.dump(gen.result(), f)
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
