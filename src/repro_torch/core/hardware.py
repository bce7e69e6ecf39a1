"""Hardware profiles for the execution predictor and operator models."""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float          # bf16/fp16 dense FLOP/s per device
    hbm_bw: float              # bytes/s per device
    hbm_capacity: float        # bytes per device
    intra_node_bw: float       # bytes/s per device (NVLink / ICI all links)
    inter_node_bw: float       # bytes/s per device (IB / DCN)
    devices_per_node: int
    # kernel-launch / framework overhead floor per operator invocation
    op_overhead: float = 3e-6
    # tile geometry used by the virtual-kernel simulator (kernelsim)
    n_cores: int = 108         # SMs (GPU) or tensor-cores (TPU)
    mxu_tile: int = 128
    # provisioning cost per device (on-demand $/GPU-hr); 0.0 = unpriced
    dollars_per_hour: float = 0.0

    def with_(self, **kw) -> "HardwareSpec":
        return replace(self, **kw)


# NVIDIA A800-SXM4-80G: A100 silicon, NVLink capped at 400 GB/s (paper setup)
A800_SXM4_80G = HardwareSpec(
    name="A800-SXM4-80G",
    peak_flops=312e12,
    hbm_bw=2.039e12,
    hbm_capacity=80e9,
    intra_node_bw=400e9,
    inter_node_bw=25e9,
    devices_per_node=8,
    n_cores=108,
    dollars_per_hour=1.90,
)

H100_SXM = HardwareSpec(
    name="H100-SXM",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    hbm_capacity=80e9,
    intra_node_bw=900e9,
    inter_node_bw=50e9,
    devices_per_node=8,
    n_cores=132,
    dollars_per_hour=3.90,
)

# TPU v5e: the dry-run/roofline target (197 TFLOP/s bf16, 819 GB/s HBM,
# ~50 GB/s per ICI link; 2D torus, 4 links/chip).
TPU_V5E = HardwareSpec(
    name="TPU-v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    hbm_capacity=16e9,
    intra_node_bw=4 * 50e9,
    inter_node_bw=25e9,
    devices_per_node=256,      # one pod
    n_cores=2,                 # tensor cores per chip
    mxu_tile=128,
    dollars_per_hour=1.20,
)

HARDWARE = {h.name: h for h in (A800_SXM4_80G, H100_SXM, TPU_V5E)}


@dataclass(frozen=True)
class LinkSpec:
    """A directed inter-cluster link (asymmetric bandwidths are two links)."""
    src: str                   # source cluster name
    dst: str                   # destination cluster name
    bandwidth: float           # bytes/s
    latency: float = 0.0       # base latency per transfer (s)

    def transfer_time(self, nbytes: float) -> float:
        if self.bandwidth <= 0:
            # previously bandwidth=0 silently priced the transfer as free;
            # spec-level validation rejects it up front, and this guard
            # catches programmatic LinkSpec construction
            raise ValueError(
                f"link {self.src}->{self.dst}: bandwidth must be > 0 "
                f"(got {self.bandwidth}); a free link is almost certainly "
                f"a spec mistake — use a large finite bandwidth instead")
        return self.latency + nbytes / self.bandwidth


@dataclass(frozen=True)
class ParallelismConfig:
    """Per-replica parallelism degrees (a replica = one model instance)."""
    tp: int = 1                # tensor parallel
    pp: int = 1                # pipeline parallel
    dp: int = 1                # data parallel (replica count handled above)
    ep: int = 1                # expert parallel (within tp*... group)
    # AF disaggregation: attention/FFN device splits (MegaScale/Step-3)
    attn_devices: int = 0
    ffn_devices: int = 0

    @property
    def devices(self) -> int:
        return self.tp * self.pp
