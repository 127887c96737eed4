"""device: the share, in percent, of the profiled stretch in which no kernel,
copy or fill ran on the card."""


def read(cell, win):
    if win.summary is None or win.summary.window_s <= 0:
        return None
    return win.summary.idle_pct()
