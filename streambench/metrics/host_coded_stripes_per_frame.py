"""Lane scheduler: stripes the lane coded on the host in the window
because the device packer's per-stripe budget overflowed (the program's
``host_fallback_stripes_total``, read at the window's start and close),
per frame delivered in the window."""


def read(rec):
    n = rec.get("counters", {}).get("host_fallback_stripes_total")
    if n is None or not rec["delivered"]:
        return None
    return n / len(rec["delivered"])
