"""Requests per scoring call of the asyncio server's ``LoopCoalescer``
over the window (its ``stats()`` at the window's ends)."""


def read(res, ctx):
    s = res["stats"]
    return s["batch_mean"] if s.get("served") else None
