"""HetRL profiler (§4.1): collects hardware information.

Port of ``repro.core.profiler``.  In a physical deployment this probes
GPUs and links; here it (a) reads the device topology graph (the
simulated environment's ground truth: ``profile_topology``) and (b)
calibrates *achievable* compute throughput and memory bandwidth of the
actual local device by micro-benchmarking (``profile_local``, what
``obs.calibrate.fit_calibration(measure_local=True)`` records): the
reference's work at its defaults (a chain of ``iters`` fp32 ``size``²
matmuls; ``iters`` passes of an ``mbytes``-MB copy-scale), timed on the
host clock up to a device synchronize.  The device is ``cuda`` unless
the caller names another (``resolve_device`` turns TF32 off there, so
fp32 means fp32).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.core.topology import Topology
from repro_torch.device import resolve_device, resolve_dtype, synchronize


@dataclasses.dataclass
class HardwareInfo:
    tflops: Dict[int, float]
    mem_gb: Dict[int, float]
    hbm_gbps: Dict[int, float]
    latency_s: "np.ndarray"
    bandwidth_gbps: "np.ndarray"


def profile_topology(topo: Topology) -> HardwareInfo:
    return HardwareInfo(
        tflops={d.id: d.spec.fp16_tflops for d in topo.devices},
        mem_gb={d.id: d.spec.mem_gb for d in topo.devices},
        hbm_gbps={d.id: d.spec.hbm_gbps for d in topo.devices},
        latency_s=topo.latency_s.copy(),
        bandwidth_gbps=topo.bandwidth_gbps.copy(),
    )


def calibrate_local_device(size: int = 1024, iters: int = 8,
                           dtype="float32", device=None) -> float:
    """Achievable matmul TFLOP/s of the local device."""
    dev = resolve_device(device)
    x = torch.ones((size, size), dtype=resolve_dtype(dtype), device=dev)
    torch.matmul(x, x)
    synchronize(dev)
    t0 = time.perf_counter()
    y = x
    for _ in range(iters):
        y = torch.matmul(y, x)
    synchronize(dev)
    dt = time.perf_counter() - t0
    flops = 2 * size ** 3 * iters
    return flops / dt / 1e12


def calibrate_local_hbm(mbytes: int = 64, iters: int = 8,
                        dtype="float32", device=None) -> float:
    """Achievable memory bandwidth (GB/s) of the local device.

    Microbenches an elementwise copy-scale over a ``mbytes``-MB array:
    each call streams the buffer in and out once (2x the array bytes),
    which is the traffic pattern the cost model's C_hbm decode roofline
    assumes.  Together with ``calibrate_local_device`` this is the
    measured (TFLOP/s, GB/s) pair ``obs.calibrate`` records per profiled
    host."""
    dev = resolve_device(device)
    dt_ = resolve_dtype(dtype)
    n = max(mbytes * (1 << 20) // torch.empty((), dtype=dt_).element_size(),
            1)
    x = torch.ones((n,), dtype=dt_, device=dev)
    y = x * 1.0000001
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        y = y * 1.0000001
    synchronize(dev)
    dt = max(time.perf_counter() - t0, 1e-9)
    nbytes = 2 * x.numel() * x.element_size() * iters  # read + write a call
    return nbytes / dt / 1e9



def profile_local(device=None) -> Dict[str, float]:
    """Local-device microbenchmark pair the calibration pass records
    (``cuda`` unless ``device`` names another)."""
    return {"tflops": calibrate_local_device(device=device),
            "hbm_gbps": calibrate_local_hbm(device=device)}
