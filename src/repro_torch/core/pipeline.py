"""Latency-hiding pipelining strategies (paper: "advanced pipelining
strategies for latency hiding").

A ``PipelineConfig`` selects, per workflow, how much of the serving
micro-workflow is allowed to overlap:

- **AF decode-step overlap** (``af_overlap``): how the attention/transfer/
  FFN event graph of one AF-disaggregated decode step shares resources.

  * ``"none"``   — the legacy model: the attention cluster is one compute
    lane, the FFN/EP group advances in lockstep, and A2F/F2A transfers are
    un-contended (an infinitely wide NIC).  This is the default and is
    bit-for-bit identical to the simulator before pipelining existed.
  * ``"serial"`` — the no-latency-hiding baseline: every task (attention,
    transfers, FFN/expert stages) is chained on ONE resource, so the step
    time is the sum of all task durations.  This is the denominator of
    ``overlap_efficiency``.
  * ``"two_batch"`` — MegaScale-Infer-style ping-pong: attention compute,
    FFN compute, and per-direction NIC lanes (``nic_lanes`` each way) are
    separate resources, so micro-batch *i*'s A2F/F2A transfers and
    FFN/expert compute hide behind micro-batch *i+1*'s attention — but
    transfers now *contend* for finite NIC lanes instead of being free.

- **Chunked prefill with piggybacked decode** (``chunked_prefill``): the
  Sarathi-Serve strategy for colocated pools and PD prefill clusters.
  Prefills are split into ``prefill_chunk``-token chunks and mixed batches
  (prefill chunk + decode tokens) are priced as one fused step: prefill
  attention for the chunk, decode attention for the piggybacked tokens,
  shared GEMMs over the combined token count (see
  ``ExecutionPredictor.step_time(..., n_prefill=...)``).

- **EP dispatch/combine comm-compute overlap** (``ep_overlap``): the
  efficiency eta in [0, 1] with which the per-rank expert sub-graph hides
  its all-to-all legs behind GroupedGEMM compute (chunked dispatch a la
  DeepEP).  A leg+compute pair costs ``(1-eta)*(comm+compute) +
  eta*max(comm, compute)`` — eta=0 is the serial legacy behavior, eta=1 is
  perfect overlap.

Configs resolve uniformly (instance | registered name | ``{"name": ...,
**overrides}`` mapping | ``None``) through :func:`resolve_pipeline`,
mirroring the batching/routing/scheduler registries.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, replace
from typing import Optional, Union

AF_OVERLAP_MODES = ("none", "serial", "two_batch")


@dataclass(frozen=True)
class PipelineConfig:
    """Per-workflow latency-hiding strategy selection (see module docs)."""
    af_overlap: str = "none"       # "none" | "serial" | "two_batch"
    nic_lanes: int = 1             # parallel transfer lanes per direction
    chunked_prefill: bool = False  # Sarathi chunked prefill + piggyback
    prefill_chunk: int = 512       # tokens per prefill chunk
    ep_overlap: float = 0.0        # EP comm/compute overlap efficiency eta

    def validate(self) -> "PipelineConfig":
        if self.af_overlap not in AF_OVERLAP_MODES:
            raise ValueError(f"af_overlap must be one of {AF_OVERLAP_MODES}, "
                             f"got {self.af_overlap!r}")
        if self.nic_lanes < 1:
            raise ValueError(f"nic_lanes must be >= 1, got {self.nic_lanes}")
        if self.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, "
                             f"got {self.prefill_chunk}")
        if not 0.0 <= self.ep_overlap <= 1.0:
            raise ValueError(f"ep_overlap must be in [0, 1], "
                             f"got {self.ep_overlap}")
        return self

    @property
    def enabled(self) -> bool:
        """True when any strategy deviates from the legacy serial model."""
        return (self.af_overlap != "none" or self.chunked_prefill
                or self.ep_overlap > 0.0)

    def to_dict(self) -> dict:
        return asdict(self)


# Named strategy presets, selectable from specs/YAML like any other policy.
PIPELINES = {
    "serial": PipelineConfig(af_overlap="serial"),
    "two_batch": PipelineConfig(af_overlap="two_batch"),
    "chunked_prefill": PipelineConfig(chunked_prefill=True),
    "ep_overlap": PipelineConfig(ep_overlap=0.8),
    "full_overlap": PipelineConfig(af_overlap="two_batch",
                                   chunked_prefill=True, ep_overlap=0.8),
}


def resolve_pipeline(spec: Union[None, str, dict, PipelineConfig]
                     ) -> Optional[PipelineConfig]:
    """Uniform pipeline-config argument handling (mirrors resolve_router).

    Accepts an instance (validated and returned), a registered preset name
    ("serial", "two_batch", "chunked_prefill", "ep_overlap",
    "full_overlap"), a mapping — either ``{"name": preset, **overrides}``
    or plain ``PipelineConfig`` fields — or None (pipelining disabled).
    """
    if spec is None:
        return None
    if isinstance(spec, PipelineConfig):
        return spec.validate()
    if isinstance(spec, str):
        spec = {"name": spec}
    if isinstance(spec, dict):
        kw = dict(spec)
        name = kw.pop("name", None)
        if name is not None:
            if name not in PIPELINES:
                raise KeyError(f"unknown pipeline preset {name!r}; "
                               f"registered: {sorted(PIPELINES)}")
            return replace(PIPELINES[name], **kw).validate()
        return PipelineConfig(**kw).validate()
    raise TypeError(f"pipeline must be None, a name, a mapping, or a "
                    f"PipelineConfig; got {type(spec).__name__}")
