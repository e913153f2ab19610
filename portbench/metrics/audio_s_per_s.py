"""Audio seconds in every packet delivered inside the window, per second of
the window (host clock)."""


def read(run):
    return run.audio_s / run.window_s
