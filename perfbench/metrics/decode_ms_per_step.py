"""decode_ms_per_step: the wall time of every decode step in the window
(each ending in the argmax that the host reads) over their number."""


def read(r):
    h = r.host
    if not h.get("decode_steps"):
        return None
    return 1e3 * h["decode_s"] / h["decode_steps"]
