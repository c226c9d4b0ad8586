"""90th percentile, over the requests submitted in the window, of the
time from the end of the dispatch that enqueued a request's last
prefill chunk to its first token's ingest (the program's
``prefill_enqueued`` and ``first_token`` stamps): the device's work on
the tick, and in overlap mode the next tick's dispatch before the read.
A request with no first token at the window's end counts with its wait
so far.  Nothing to read without the program's stamps."""

from yardstick.program import request_waits
from yardstick.stats import percentile


def read(rec):
    prog = rec.get("program")
    if not prog:
        return None
    return percentile(request_waits(prog)["lag"], 90)
