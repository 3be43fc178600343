"""Device: the wall time on the card of the tick that carried a delivered
frame, from its first shard's start to its last shard's completion, as the
program stamps it with CUDA timing events on the host clock (the
recorder's ``device``; no profiler), mean over the window's delivered
frames. None where no delivered frame carries the stage."""

from streambench import stats


def read(rec):
    return stats.mean([(f["span"]["stages"]["device"][1]
                        - f["span"]["stages"]["device"][0]) * 1e3
                       for f in rec["delivered"]
                       if "device" in f["span"]["stages"]])
