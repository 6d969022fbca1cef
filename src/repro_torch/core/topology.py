"""Device topology graph G_D for heterogeneous environments (§3.1, §5.1).

Devices carry compute capability (TFLOPS), memory capacity and HBM
bandwidth; every device pair carries latency alpha (s) and bandwidth beta
(GB/s).  Builders reproduce the paper's 64-GPU testbed (24×A100, 24×L40S,
16×L4 — Table 1) under the four network scenarios of §5.1, and additionally
a TPU-native pool (DESIGN.md hardware adaptation).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class GPUSpec:
    name: str
    fp16_tflops: float
    mem_gb: float
    hbm_gbps: float
    intra_node_gbps: float  # NVLink / PCIe / ICI, GB/s per pair


# Table 1 of the paper
A100 = GPUSpec("A100", 312.0, 40.0, 2039.0, 600.0 / 8)
L40S = GPUSpec("L40S", 366.0, 48.0, 864.0, 64.0 / 8)
L4 = GPUSpec("L4", 121.0, 24.0, 300.0, 64.0 / 8)
# TPU-native (v5e; DESIGN.md) — 197 TF bf16, 16 GB, 819 GB/s HBM, ICI 50 GB/s
TPU_V5E = GPUSpec("TPUv5e", 197.0, 16.0, 819.0, 50.0)
TPU_V4 = GPUSpec("TPUv4", 275.0, 32.0, 1200.0, 50.0)


@dataclasses.dataclass(frozen=True)
class Device:
    id: int
    spec: GPUSpec
    machine: int
    zone: int
    region: str


@dataclasses.dataclass
class Topology:
    devices: List[Device]
    latency_s: np.ndarray     # [N, N] seconds
    bandwidth_gbps: np.ndarray  # [N, N] GB/s

    @property
    def n(self) -> int:
        return len(self.devices)

    def alpha(self, a: int, b: int) -> float:
        return float(self.latency_s[a, b])

    def beta(self, a: int, b: int) -> float:
        return float(self.bandwidth_gbps[a, b])

    def comp(self, d: int) -> float:
        return self.devices[d].spec.fp16_tflops * 1e12

    def mem(self, d: int) -> float:
        return self.devices[d].spec.mem_gb * 1e9

    def hbm(self, d: int) -> float:
        return self.devices[d].spec.hbm_gbps * 1e9

    def locality(self, a: int, b: int) -> int:
        """Affinity score: 3 same machine, 2 same zone, 1 same region."""
        da, db = self.devices[a], self.devices[b]
        if da.machine == db.machine:
            return 3
        if da.zone == db.zone and da.region == db.region:
            return 2
        if da.region == db.region:
            return 1
        return 0

    def locality_matrix(self) -> np.ndarray:
        """[N, N] pairwise locality scores (cached)."""
        cached = getattr(self, "_loc_mat", None)
        if cached is not None:
            return cached
        n = self.n
        mat = np.zeros((n, n), np.float64)
        for a in range(n):
            for b in range(a + 1, n):
                mat[a, b] = mat[b, a] = self.locality(a, b)
        self._loc_mat = mat
        return mat

    def subset_mean_tflops(self, ids: Sequence[int]) -> float:
        return float(np.mean([self.devices[d].spec.fp16_tflops
                              for d in ids])) if ids else 0.0


# ---------------------------------------------------------------------------
# Network synthesis
# ---------------------------------------------------------------------------

_EU_REGIONS = ["paris", "stockholm", "london", "ireland", "spain", "zurich",
               "frankfurt", "milan"]
_US_REGIONS = ["virginia", "ohio"]

_INTRA_REGION_LAT_S = 2e-4       # 0.2 ms within an AZ
_INTRA_REGION_BW = 100.0 / 8     # 100 Gbps EFA -> GB/s
_INTRA_MACHINE_LAT_S = 5e-6


def _pair_params(rng, lat_range_ms, bw_range_gbps):
    lat = rng.uniform(*lat_range_ms) * 1e-3
    bw = rng.uniform(*bw_range_gbps) / 8.0  # Gbps -> GB/s
    return lat, bw


def _build(devices: List[Device], region_lat_bw, seed=0) -> Topology:
    n = len(devices)
    lat = np.zeros((n, n))
    bw = np.zeros((n, n))
    for i, j in itertools.product(range(n), range(n)):
        if i == j:
            bw[i, j] = max(devices[i].spec.hbm_gbps, 1.0)
            continue
        di, dj = devices[i], devices[j]
        if di.machine == dj.machine:
            lat[i, j] = _INTRA_MACHINE_LAT_S
            bw[i, j] = min(di.spec.intra_node_gbps, dj.spec.intra_node_gbps)
        elif di.region == dj.region:
            lat[i, j] = _INTRA_REGION_LAT_S
            bw[i, j] = _INTRA_REGION_BW
        else:
            key = tuple(sorted((di.region, dj.region)))
            lat[i, j], bw[i, j] = region_lat_bw[key]
    return Topology(devices, lat, bw)


def _mk_devices(counts: Dict[str, int], region_of, zone_of=None,
                gpus_per_machine=8) -> List[Device]:
    """counts: spec-name -> count. region_of(idx)->region."""
    specs = {"A100": A100, "L40S": L40S, "L4": L4,
             "TPUv5e": TPU_V5E, "TPUv4": TPU_V4}
    devices = []
    machine = 0
    idx = 0
    for name, cnt in counts.items():
        per = 4 if name == "L4" else gpus_per_machine
        for m in range(0, cnt, per):
            nm = min(per, cnt - m)
            for _ in range(nm):
                region = region_of(idx)
                zone = zone_of(idx) if zone_of else 0
                devices.append(Device(idx, specs[name], machine, zone, region))
                idx += 1
            machine += 1
    return devices


def build_testbed(scenario: str, seed: int = 0,
                  counts: Optional[Dict[str, int]] = None) -> Topology:
    """The paper's 64-GPU testbed under one of the four §5.1 scenarios."""
    rng = np.random.default_rng(seed)
    counts = counts or {"A100": 24, "L40S": 24, "L4": 16}
    total = sum(counts.values())

    if scenario == "single_region":
        devices = _mk_devices(counts, lambda i: "virginia")
        return _build(devices, {})

    if scenario == "multi_region_hybrid":
        # Ohio + Virginia; last quarter of Virginia GPUs are at the edge.
        def region_of(i):
            return "ohio" if i < total // 2 else "virginia"
        devices = _mk_devices(counts, region_of)
        pair = {("ohio", "virginia"): (10e-3, 5.0 / 8)}
        topo = _build(devices, pair)
        edge = [d.id for d in devices if d.region == "virginia"][-total // 4:]
        for e in edge:
            for j in range(total):
                if j == e or devices[j].machine == devices[e].machine:
                    continue
                cap = 1.0 / 8
                topo.bandwidth_gbps[e, j] = min(topo.bandwidth_gbps[e, j], cap)
                topo.bandwidth_gbps[j, e] = min(topo.bandwidth_gbps[j, e], cap)
                if devices[j].region != "virginia":
                    # edge GPUs reach other regions only via Virginia relay:
                    # slow but not disconnected
                    relay = 0.5 / 8
                    topo.bandwidth_gbps[e, j] = topo.bandwidth_gbps[j, e] = relay
                    topo.latency_s[e, j] = topo.latency_s[j, e] = 25e-3
        return topo

    if scenario == "multi_country":
        regions = _EU_REGIONS
        def region_of(i):
            return regions[i * len(regions) // total]
        devices = _mk_devices(counts, region_of)
        pair = {tuple(sorted(p)): _pair_params(rng, (5, 30), (1.9, 5.0))
                for p in itertools.combinations(regions, 2)}
        return _build(devices, pair)

    if scenario == "multi_continent":
        regions = _EU_REGIONS[:6] + _US_REGIONS
        def region_of(i):
            return regions[i * len(regions) // total]
        devices = _mk_devices(counts, region_of)
        pair = {}
        for p in itertools.combinations(regions, 2):
            cross = (p[0] in _US_REGIONS) != (p[1] in _US_REGIONS)
            rng_lat = (30, 60) if cross else (5, 30)
            rng_bw = (0.9, 3.0) if cross else (1.9, 5.0)
            pair[tuple(sorted(p))] = _pair_params(rng, rng_lat, rng_bw)
        return _build(devices, pair)

    raise ValueError(f"unknown scenario {scenario!r}")


SCENARIOS = ["single_region", "multi_region_hybrid", "multi_country",
             "multi_continent"]


def build_host(n: int, spec: GPUSpec = A100) -> Topology:
    """Homogeneous single-machine topology with `n` devices — the proxy
    the execution engine plans against when no scheduler plan is given
    (one device id per local accelerator)."""
    devices = [Device(i, spec, 0, 0, "local") for i in range(n)]
    return _build(devices, {})


# ---------------------------------------------------------------------------
# Topology drift (§6 online redeployment): constructible degradations
# ---------------------------------------------------------------------------

def topo_equal(a: Optional["Topology"], b: Optional["Topology"]) -> bool:
    """Structural equality — same devices (spec/placement) and the same
    latency/bandwidth matrices.  Used by the elasticity controller to
    decide whether a topology feed actually drifted."""
    if a is b:
        return True
    if a is None or b is None or a.n != b.n:
        return False
    for da, db in zip(a.devices, b.devices):
        if (da.spec, da.machine, da.zone, da.region) != \
                (db.spec, db.machine, db.zone, db.region):
            return False
    return np.array_equal(a.latency_s, b.latency_s) and \
        np.array_equal(a.bandwidth_gbps, b.bandwidth_gbps)


def degrade_links(topo: Topology, *, bw_factor: float = 0.05,
                  lat_factor: float = 10.0,
                  pairs: Optional[Sequence[Tuple[int, int]]] = None,
                  regions: Optional[Sequence[str]] = None,
                  fraction: float = 1.0, seed: int = 0) -> Topology:
    """A degraded copy of `topo`: selected inter-device links lose
    bandwidth (×bw_factor) and gain latency (×lat_factor).

    Link selection, most specific first:
      * ``pairs``   — explicit (a, b) device pairs (applied symmetrically);
      * ``regions`` — two names degrade the links *between* those regions,
        one name degrades every cross-machine link touching it;
      * default     — every cross-machine link, subsampled to ``fraction``
        with a seeded rng so scenarios are reproducible.

    The diagonal (HBM) is never touched; the input topology is not
    mutated."""
    n = topo.n
    mask = np.zeros((n, n), dtype=bool)
    if pairs is not None:
        for a, b in pairs:
            mask[a, b] = mask[b, a] = True
    else:
        cross = np.array(
            [[topo.devices[i].machine != topo.devices[j].machine
              for j in range(n)] for i in range(n)])
        if regions is not None:
            regs = list(regions)
            in_r = np.array([d.region in regs for d in topo.devices])
            if len(regs) >= 2:
                r0 = np.array([d.region == regs[0] for d in topo.devices])
                r1 = np.array([d.region in regs[1:] for d in topo.devices])
                mask = cross & (np.outer(r0, r1) | np.outer(r1, r0))
            else:
                mask = cross & (in_r[:, None] | in_r[None, :])
        else:
            mask = cross
        if fraction < 1.0:
            rng = np.random.default_rng(seed)
            iu = np.triu_indices(n, k=1)
            keep = rng.random(len(iu[0])) < fraction
            sub = np.zeros((n, n), dtype=bool)
            sub[iu[0][keep], iu[1][keep]] = True
            sub |= sub.T
            mask &= sub
    np.fill_diagonal(mask, False)
    lat = topo.latency_s.copy()
    bw = topo.bandwidth_gbps.copy()
    lat[mask] *= lat_factor
    bw[mask] *= bw_factor
    return Topology(list(topo.devices), lat, bw)


def scale_compute(topo: Topology, factor: float, *,
                  device_class: Optional[str] = None,
                  ids: Optional[Sequence[int]] = None) -> Topology:
    """A copy of `topo` with selected devices' compute and HBM throughput
    multiplied by ``factor`` (< 1 models thermal throttling / preemption
    pressure on a device class).  Selection: explicit ``ids``, else every
    device whose spec name equals ``device_class``, else all devices.
    Link matrices are untouched; the input topology is not mutated."""
    chosen = set(int(d) for d in ids) if ids is not None else None
    devices = []
    for d in topo.devices:
        hit = (chosen is not None and d.id in chosen) or \
            (chosen is None and (device_class is None
                                 or d.spec.name == device_class))
        if hit:
            spec = dataclasses.replace(
                d.spec, fp16_tflops=d.spec.fp16_tflops * factor,
                hbm_gbps=d.spec.hbm_gbps * factor)
            devices.append(dataclasses.replace(d, spec=spec))
        else:
            devices.append(d)
    return Topology(devices, topo.latency_s.copy(),
                    topo.bandwidth_gbps.copy())


def drop_devices(topo: Topology, ids: Sequence[int]) -> Topology:
    """The topology with `ids` removed and the survivors re-indexed to a
    dense 0..n'-1 id space (matrices restricted accordingly).  Plans built
    against the old topology become invalid on the result — ``reschedule``
    treats such incumbents as infinitely costly."""
    gone = set(int(d) for d in ids)
    keep = [d.id for d in topo.devices if d.id not in gone]
    if not keep:
        raise ValueError("cannot drop every device")
    devices = [dataclasses.replace(topo.devices[d], id=i)
               for i, d in enumerate(keep)]
    idx = np.asarray(keep)
    return Topology(devices, topo.latency_s[np.ix_(idx, idx)].copy(),
                    topo.bandwidth_gbps[np.ix_(idx, idx)].copy())


@dataclasses.dataclass(frozen=True)
class DriftEvent:
    """One medium-granularity fleet/network change: from `iteration` on,
    the environment looks like `topo`."""
    iteration: int
    description: str
    topo: Topology


@dataclasses.dataclass
class DriftSchedule:
    """A deterministic topology feed for tests/benchmarks: ``topo_at(it)``
    returns the environment the fleet is in at iteration ``it`` (the base
    topology until the first event fires)."""
    base: Topology
    events: List[DriftEvent]

    def __post_init__(self):
        self.events = sorted(self.events, key=lambda e: e.iteration)

    def topo_at(self, iteration: int) -> Topology:
        topo = self.base
        for e in self.events:
            if e.iteration <= iteration:
                topo = e.topo
        return topo

    @classmethod
    def generate(cls, base: Topology, *, seed: int = 0, n_events: int = 2,
                 first_iteration: int = 5, every: int = 10,
                 recover: bool = True) -> "DriftSchedule":
        """Seeded random degradation scenario: `n_events` successive
        cross-machine link degradations (random severity and coverage),
        optionally followed by a recovery back to the base topology."""
        rng = np.random.default_rng(seed)
        events = []
        it = first_iteration
        for k in range(n_events):
            bw_f = float(rng.uniform(0.02, 0.2))
            lat_f = float(rng.uniform(5.0, 20.0))
            frac = float(rng.uniform(0.5, 1.0))
            events.append(DriftEvent(
                it, f"degrade x{1 / bw_f:.0f} bw on {frac:.0%} of "
                    f"cross-machine links",
                degrade_links(base, bw_factor=bw_f, lat_factor=lat_f,
                              fraction=frac, seed=seed + k)))
            it += every
        if recover:
            events.append(DriftEvent(it, "network recovers", base))
        return cls(base, events)


DRIFT_SCENARIOS = ["degrade_cross", "degrade_severe", "drop_tail", "flaky"]


def drift_scenario(name: str, base: Topology, *, at: int = 5,
                   seed: int = 0) -> DriftSchedule:
    """Named degradation scenarios for the launcher/benchmarks:
      degrade_cross  — cross-machine bandwidth /20, latency ×10 at `at`;
      degrade_severe — cross-machine bandwidth /100, latency ×50 at `at`;
      drop_tail      — the last quarter of the fleet disappears at `at`;
      flaky          — seeded multi-event drift (DriftSchedule.generate)."""
    if name == "degrade_cross":
        ev = DriftEvent(at, "cross-machine links degrade 20x",
                        degrade_links(base, bw_factor=0.05, lat_factor=10.0))
        return DriftSchedule(base, [ev])
    if name == "degrade_severe":
        ev = DriftEvent(at, "cross-machine links degrade 100x",
                        degrade_links(base, bw_factor=0.01, lat_factor=50.0))
        return DriftSchedule(base, [ev])
    if name == "drop_tail":
        tail = [d.id for d in base.devices[-max(base.n // 4, 1):]]
        ev = DriftEvent(at, f"devices {tail} leave the fleet",
                        drop_devices(base, tail))
        return DriftSchedule(base, [ev])
    if name == "flaky":
        return DriftSchedule.generate(base, seed=seed, first_iteration=at)
    raise ValueError(f"unknown drift scenario {name!r}; "
                     f"options: {DRIFT_SCENARIOS}")


def build_tpu_pool(n_v5e: int = 32, n_v4: int = 16, seed: int = 0) -> Topology:
    """TPU-native heterogeneous pool: a v5e slice + a v4 slice joined by DCN
    (the TPU analogue of the paper's cross-region setting)."""
    counts = {"TPUv5e": n_v5e, "TPUv4": n_v4}
    total = n_v5e + n_v4
    def region_of(i):
        return "v5e-slice" if i < n_v5e else "v4-slice"
    devices = _mk_devices(counts, region_of, gpus_per_machine=4)
    pair = {("v4-slice", "v5e-slice"): (1e-3, 6.25)}  # DCN ~50 Gbps, 1 ms
    return _build(devices, pair)
