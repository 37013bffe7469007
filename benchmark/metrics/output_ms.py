"""Host time at an output boundary, ms: from the end of one interval's
graph replays (synchronised in the traced run) to the next ``make_scan``
call, and from the window's start to its first one: the fetch, the NaN
watchdog and the CSV write.  The mean over the window's boundaries."""


def read(rec):
    gaps = rec.output_gaps_s
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
