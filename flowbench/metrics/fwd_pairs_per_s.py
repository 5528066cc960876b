"""fwd_pairs_per_s: pairs whose flow reached the host in the window, over
the window's seconds (host clock)."""


def read(rec):
    if rec.entry != "forward" or not rec.completed:
        return None
    return rec.completed / rec.window_s
