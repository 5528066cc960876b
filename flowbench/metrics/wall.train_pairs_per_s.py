"""wall.train_pairs_per_s: samples trained in the window, over the window's
seconds (host clock); a step counts once its loss is a host float.

The wall-clock rate of a host-bound step: per layer, since it follows the
speed of the host's cores from run to run further than a bound can hold."""


def read(rec):
    if rec.entry != "train" or not rec.completed:
        return None
    return rec.completed / rec.window_s
