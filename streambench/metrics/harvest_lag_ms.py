"""Lane scheduler: the finished tick of a delivered frame waiting for the
ticker thread to harvest it, from the dispatch's end (or the tick's device
completion, where later) to the harvest's start (the recorder's
``harvest_lag``), mean over the window's delivered frames. None where no
delivered frame carries the stage."""

from streambench import stats


def read(rec):
    return stats.mean([(f["span"]["stages"]["harvest_lag"][1]
                        - f["span"]["stages"]["harvest_lag"][0]) * 1e3
                       for f in rec["delivered"]
                       if "harvest_lag" in f["span"]["stages"]])
