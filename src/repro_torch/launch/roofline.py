"""Roofline terms of a dry-run cell on NVIDIA H100 SXM5 (twin of
:mod:`repro.launch.roofline`, whose constants are a TPU's).

    compute    t_c = per-device FLOPs / peak FLOP/s
    memory     t_m = per-device bytes accessed / HBM bandwidth
    collective t_x = per-device collective wire bytes / link bandwidth

plus the "usefulness" ratio MODEL_FLOPS / counted FLOPs (catches remat and
redundancy waste) and the roofline fraction
    frac = t_model / max(t_c, t_m, t_x),   t_model = MODEL_FLOPS/(chips·peak)
which is 1.0 for a perfectly compute-bound, zero-waste program.

Every constant here is a datasheet figure (NVIDIA's H100 data sheet, SXM5
part at 700 W, dense rates; NVLink 4 and InfiniBand NDR line rates), not a
reading.  A card set below 700 W runs slower under load.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12      # bf16 tensor cores, dense, FLOP/s a GPU
BF16_RATE = PEAK_FLOPS
FP32_RATE = 67e12        # float32 outside the tensor cores, FLOP/s a GPU
HBM_BW = 3.35e12         # HBM3 bytes/s a GPU (SXM5)
# device-memory rates by part, as nvidia-smi names the card
MEM_RATE = {"PCIe": 2.0e12, "NVL": 3.9e12, "SXM": HBM_BW}
NODE_GPUS = 8            # GPUs a node, joined all to all by NVLink
NVLINK_BW = 450e9        # NVLink 4, bytes/s a GPU a direction
IB_BW = 50e9             # InfiniBand NDR (400 Gb/s), bytes/s a GPU a direction


def mem_rate(name: str) -> float:
    """The device-memory rate of the card ``name`` (nvidia-smi's name)."""
    for key, rate in MEM_RATE.items():
        if key in name:
            return rate
    return MEM_RATE["SXM"]


def axes_within_node(mesh, axes) -> bool:
    """Whether a collective over mesh ``axes`` stays inside a node: the
    mesh is laid out row-major over the devices (its last axis innermost,
    nodes of :data:`NODE_GPUS` consecutive devices), so the group spans
    the product of its axes' sizes times the stride of the outermost."""
    names, shape = list(mesh.axis_names), mesh.shape
    if not axes:
        return True
    outer = min(names.index(a) for a in axes)
    span = 1
    for a in names[outer:]:
        span *= shape[a]
    return span <= NODE_GPUS


def link_bw(mesh, axes) -> float:
    """The per-direction link rate a collective over ``axes`` moves at."""
    return NVLINK_BW if axes_within_node(mesh, axes) else IB_BW


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops_global: float
    collective_s_per_device: float = 0.0   # the bytes over their links' rates
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    dominant: str = ""
    useful_ratio: float = 0.0    # MODEL_FLOPS / global counted FLOPs
    fraction: float = 0.0        # roofline fraction (see module docstring)

    def finalize(self) -> "Roofline":
        self.t_compute = self.flops_per_device / PEAK_FLOPS
        self.t_memory = self.bytes_per_device / HBM_BW
        self.t_collective = self.collective_s_per_device
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.dominant = max(terms, key=terms.get)
        counted = self.flops_per_device * self.chips
        self.useful_ratio = (self.model_flops_global / counted
                             if counted else 0.0)
        t_model = self.model_flops_global / (self.chips * PEAK_FLOPS)
        bound = max(terms.values())
        self.fraction = t_model / bound if bound else 0.0
        return self

    def asdict(self):
        return dataclasses.asdict(self)

    def row(self) -> str:
        return (f"{self.arch:22s} {self.shape:12s} {self.mesh:9s} "
                f"tc={self.t_compute*1e3:9.3f}ms tm={self.t_memory*1e3:9.3f}ms "
                f"tx={self.t_collective*1e3:9.3f}ms dom={self.dominant:10s} "
                f"useful={self.useful_ratio:6.2f} frac={self.fraction:6.3f}")
