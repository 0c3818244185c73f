"""Hardware profiles for the analytic latency model.

The paper calibrates its simulator against NVIDIA A100 operator profiles; we
additionally provide the TPU v5e profile used by the roofline analysis so the
simulator and the dry-run share constants. ``mfu`` is the sustained fraction
of peak compute the latency model assumes for dense prefill operators (Vidur
profiles encode the same information empirically).
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["HW", "A100", "TPU_V5E", "RTX3090"]

GB = 1e9
Gb = 1e9 / 8


@dataclass(frozen=True)
class HW:
    name: str
    flops: float          # peak matmul FLOP/s (bf16)
    hbm_bw: float         # bytes/s
    nic_bw: float         # bytes/s per endpoint (network share per GPU)
    scaleup_bw: float     # bytes/s intra-server fabric per endpoint
    mfu: float = 0.45     # sustained fraction of peak for prefill GEMMs
    hbm_eff: float = 0.75


# Simulation default (§6.1: latency profiles calibrated on A100; 8 NICs per
# 8-GPU server at 200 Gbps; NVSwitch 900 GB/s).
A100 = HW("a100", flops=312e12, hbm_bw=2039 * GB, nic_bw=200 * Gb,
          scaleup_bw=900 * GB)

# Testbed (§6.1): RTX 3090 + 2x100G NICs shared by 4 GPUs => 50 Gbps/GPU,
# PCIe Gen3 x16 intra-server (~16 GB/s).
RTX3090 = HW("rtx3090", flops=71e12, hbm_bw=936 * GB, nic_bw=50 * Gb,
             scaleup_bw=16 * GB, mfu=0.35)

# Roofline target hardware (per brief): TPU v5e.
TPU_V5E = HW("tpu_v5e", flops=197e12, hbm_bw=819 * GB, nic_bw=50 * GB,
             scaleup_bw=50 * GB, mfu=0.5)

# Serving target of the PyTorch port: one NVIDIA H100 SXM per endpoint.
# Data-sheet figures, not measured: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3,
# 900 GB/s NVLink, one 400 Gb/s NIC per GPU. ``mfu`` is a placeholder (the
# A100 default) until prefill GEMMs are timed on the card.
H100 = HW("h100", flops=989e12, hbm_bw=3.35e12, nic_bw=400 * Gb,
          scaleup_bw=900 * GB, mfu=0.45)

__all__ += ["H100"]
