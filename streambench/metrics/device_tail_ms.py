"""Device: the card still working on a delivered frame's tick after the
host's launch of it ended, up to the harvest's start (the recorder's
``device_tail``, 0 where the tick finished before its dispatch ended), mean
over the window's delivered frames. None where no delivered frame carries
the stage (no device stamps: the program before them, or the CPU)."""

from streambench import stats


def read(rec):
    return stats.mean([(f["span"]["stages"]["device_tail"][1]
                        - f["span"]["stages"]["device_tail"][0]) * 1e3
                       for f in rec["delivered"]
                       if "device_tail" in f["span"]["stages"]])
