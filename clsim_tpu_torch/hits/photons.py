"""Photon-record post-processing: PhotonBatch construction, string/OM-id
remapping, and npz round-trip (the photon-level checkpoint).

PyTorch counterpart of clsim_tpu.hits.photons.  The reference remaps device
string/DOM indices to detector IDs when photons are downloaded
(I3CLSimStepToPhotonConverterOpenCL.cxx:1563-1614) and persists photons
between the two pipeline halves so hit generation can run later / elsewhere
(I3CLSimMakePhotons -> .i3 file -> I3CLSimMakeHitsFromPhotons,
python/traysegments/I3CLSimMakeHitsFromPhotons.py:55).  Here the records of
a propagation result become a compact PhotonBatch of host numpy arrays with
real (string_id, om_id) pairs, and save/load is a plain npz file.

Both record contracts are accepted: the engine's per-slot rings ((N, cap)
fields, (N,) counts) and the fused path's flat records ((1, R) fields,
count [R]); compact_records turns either into the flat one on its device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import DetectorGeometry, to_numpy
from ..types import PhotonBatch

_SCALAR_FIELDS = [
    "pos_x", "pos_y", "pos_z", "time", "dir_theta", "dir_phi",
    "wavelength", "cherenkov_dist", "num_scatters", "weight",
    "identifier", "start_x", "start_y", "start_z", "start_time",
    "start_theta", "start_phi", "group_velocity", "dist_in_abs_lens",
]


def _ring_mask(rec_count, cap: int, device=None) -> torch.Tensor:
    """(slots, cap) mask of the valid ring entries: min(count, cap) per
    slot (a slot that overflowed wrapped, oldest records overwritten)."""
    count = torch.as_tensor(rec_count, device=device).to(torch.int64)
    pos = torch.arange(cap, device=count.device)
    return pos[None, :] < torch.clamp(count, max=cap)[:, None]


def compact_records(rec: dict, rec_count):
    """Records of either contract -> the flat one: (rec with (1, R)
    tensors, rec_count [R] int32), on the records' device.  The
    scatter-history fields ((N, cap, H) each) become (1, R, H)."""
    n_slots, cap = rec["time"].shape
    valid = _ring_mask(rec_count, cap, rec["time"].device).reshape(-1)
    flat = {k: v.reshape((n_slots * cap,) + v.shape[2:])[valid][None]
            for k, v in rec.items()}
    n = flat["time"].shape[1]
    return flat, torch.tensor([n], dtype=torch.int32,
                              device=rec["time"].device)


def records_to_photon_batch(rec: dict, rec_count, geo: DetectorGeometry
                            ) -> PhotonBatch:
    """Compact the records into a flat PhotonBatch of numpy arrays.

    Ring semantics: slot s holds min(rec_count[s], capacity) valid records
    in ring order; overflowed slots wrapped (oldest records overwritten),
    like the reference's bounded output buffer with its overflow clamp
    (…OpenCL.cxx:1027-1031).  Device flat DOM indices are remapped to
    detector (string_id, om_id) pairs here, on download.  The
    scatter-history fields stay out of the batch, as in the JAX package
    (clsim_tpu/hits/photons.py:44-45)."""
    n_slots, cap = rec["time"].shape
    mask = to_numpy(_ring_mask(to_numpy(rec_count), cap)).reshape(-1)
    flat = {k: to_numpy(v).reshape(-1)[mask] for k, v in rec.items()
            if k in _SCALAR_FIELDS or k == "dom"}
    dom = flat.pop("dom").astype(np.int64)
    string_id = to_numpy(geo.dom_string_id)[dom]
    om_id = to_numpy(geo.dom_om_id)[dom]
    return PhotonBatch(
        valid=np.ones(int(mask.sum()), bool),
        string_id=string_id.astype(np.int32),
        om_id=om_id.astype(np.int32),
        **{k: flat[k] for k in _SCALAR_FIELDS})


def photon_batch_dom_index(batch: PhotonBatch, geo: DetectorGeometry):
    """Inverse remap: (string_id, om_id) -> flat DOM index in `geo` (what
    the device needs again when hits are generated from a file)."""
    sid = to_numpy(geo.dom_string_id).astype(np.int64)
    oid = to_numpy(geo.dom_om_id).astype(np.int64)
    code = sid * 100000 + oid
    order = np.argsort(code, kind="stable")
    want = (np.asarray(batch.string_id, np.int64) * 100000
            + np.asarray(batch.om_id, np.int64))
    pos = np.searchsorted(code[order], want)
    pos = np.clip(pos, 0, len(code) - 1)
    idx = order[pos]
    if not (code[idx] == want).all():
        raise ValueError("photon batch references (string, om) pairs not in "
                         "this geometry")
    return idx.astype(np.int32)


def save_photons_npz(path, batch: PhotonBatch) -> None:
    """Persist a PhotonBatch (the MakePhotons half of the two-phase flow)."""
    np.savez_compressed(
        path, **{f: np.asarray(getattr(batch, f))
                 for f in PhotonBatch._fields})


def load_photons_npz(path) -> PhotonBatch:
    with np.load(path) as z:
        return PhotonBatch(**{f: z[f] for f in PhotonBatch._fields})
