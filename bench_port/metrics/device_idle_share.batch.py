"""The share of the traced window in which no device activity ran, in %:
1 - (the union of the kernel, copy and set intervals) / the window."""


def read(rec):
    return rec.idle_share_pct()
