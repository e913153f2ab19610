"""The card's vocoder time per second of audio delivered: the device
milliseconds of the `server.vocode` span (each packet egress replay) and
of the `server.fast_first` span (each first-packet replay), counter deltas
over the traced window, over the audio seconds of the window's packets."""


def read(run):
    ms = run.counters.get("server.vocode.device_ms")
    if not ms or not run.audio_s:
        return None
    return (ms + run.counters.get("server.fast_first.device_ms", 0.0)) / run.audio_s
