"""Host conversion (the generators' convert calls of each event, on the
feeder's thread beside the card's work) in nanoseconds a photon: the
program's "convert" spans of the traced window over its "photons"
counter."""

from benchmark import spans as S


def read(data):
    if data.get("driver") != "stream":
        return None
    return S.per_photon_ns(S.recorded(), "convert")
