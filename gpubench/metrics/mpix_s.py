"""Output pixels of every call completed in the window, over the window's
seconds, in millions a second (host clock; the window ends when the last
call's output is on the host)."""


def read(run):
    return sum(px for _, _, px in run.calls) / run.window_s / 1e6
