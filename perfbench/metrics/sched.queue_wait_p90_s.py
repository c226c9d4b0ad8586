"""90th percentile, over the requests submitted in the window, of the
wait from submission to admission to a slot (the program's ``submit``
and ``admit`` stamps); a request not admitted by the window's end
counts with its wait so far.  Nothing to read without the program's
stamps."""

from yardstick.program import request_waits
from yardstick.stats import percentile


def read(rec):
    prog = rec.get("program")
    if not prog:
        return None
    return percentile(request_waits(prog)["queue"], 90)
