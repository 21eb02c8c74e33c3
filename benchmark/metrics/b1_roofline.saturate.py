"""B1 (csrc/strongly_see.cu): the launches' least time by bounds.py over
their device time in the traced window (%)."""


from readers import roofline_pct


def read(rec):
    return roofline_pct(rec, "b1")
