"""Slot assignment (sources/ppc.assign_steps_to_slots) in nanoseconds a
photon, on the host clock, over a sample of the cell's events."""


def read(data):
    if data.get("driver") != "stream":
        return None
    return data["assign_s_per_photon"] * 1e9
