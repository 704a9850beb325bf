"""Host conversion (the generators' convert: particles and pulses to
steps) in nanoseconds a photon, on the host clock, over a sample of the
cell's events."""


def read(data):
    if data.get("driver") != "stream":
        return None
    return data["convert_s_per_photon"] * 1e9
