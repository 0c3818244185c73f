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
# Data-sheet figures: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 900 GB/s
# NVLink, one 400 Gb/s NIC per GPU. ``mfu`` is measured: the modeled FLOPs
# of 4 prompts x 1024 tokens through the port's ``ServingEngine.prefill``
# over 989 TFLOP/s times the host-clock seconds to a synchronise (warm,
# median of 3; chip_smoke.py phase 8), on an NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit, in four processes on three machines: minitron-8b
# 0.3262, 0.4918, 0.4721, 0.5335 (set here to their median: the largest
# dense config whole on one card; over the device's busy time alone
# 0.634-0.636, the rest is the host's), starcoder2-3b 0.2722, 0.2536,
# 0.2587, 0.2574, smollm-360m 0.0241, 0.0196, 0.0202, 0.0244.
# ``hbm_eff`` keeps the A100 default.
H100 = HW("h100", flops=989e12, hbm_bw=3.35e12, nic_bw=400 * Gb,
          scaleup_bw=900 * GB, mfu=0.48)

__all__ += ["H100"]
