"""Run statistics: the I3CLSimEventStatistics / GetStatistics() equivalent
(public/clsim/I3CLSimEventStatistics.h, I3CLSimStepToPhotonConverterOpenCL.cxx
:1625-1637): photon counts and device/host timing per run, with the same
derived keys the reference's benchmark consumes."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict


@dataclasses.dataclass
class RunStatistics:
    total_num_photons_generated: float = 0.0
    total_num_photons_at_doms: float = 0.0
    total_weight_at_doms: float = 0.0
    total_device_time_ns: float = 0.0
    total_host_time_ns: float = 0.0
    num_kernel_calls: int = 0
    # fused-path loss counters (kernel CNT_DROPPED / CNT_ALIVE): nonzero
    # means a production run lost hits or gave up on photons
    total_num_hits_dropped: float = 0.0
    total_num_photons_abandoned: float = 0.0

    def record(self, n_generated, n_hits, weight_hits,
               device_time_s, host_time_s,
               n_dropped: float = 0.0, n_abandoned: float = 0.0):
        self.total_num_photons_generated += float(n_generated)
        self.total_num_photons_at_doms += float(n_hits)
        self.total_weight_at_doms += float(weight_hits)
        self.total_device_time_ns += device_time_s * 1e9
        self.total_host_time_ns += host_time_s * 1e9
        self.num_kernel_calls += 1
        self.total_num_hits_dropped += float(n_dropped)
        self.total_num_photons_abandoned += float(n_abandoned)

    def as_dict(self) -> Dict[str, float]:
        gen = max(self.total_num_photons_generated, 1.0)
        host = max(self.total_host_time_ns, 1e-9)
        return {
            "TotalNumPhotonsGenerated": self.total_num_photons_generated,
            "TotalNumPhotonsAtDOMs": self.total_num_photons_at_doms,
            "TotalWeightAtDOMs": self.total_weight_at_doms,
            "TotalDeviceTime": self.total_device_time_ns,
            "TotalHostTime": self.total_host_time_ns,
            "NumKernelCalls": float(self.num_kernel_calls),
            "AverageDeviceTimePerPhoton": self.total_device_time_ns / gen,
            "AverageHostTimePerPhoton": self.total_host_time_ns / gen,
            "DeviceUtilization": self.total_device_time_ns / host,
            "TotalNumHitsDropped": self.total_num_hits_dropped,
            "TotalNumPhotonsAbandoned": self.total_num_photons_abandoned,
        }
